"""Host seconds a video in the mp4 write (``utils.media.save_video``, as
``serving/server.py`` calls it)."""


def read(run):
    return run.mean([r.save_span[1] - r.save_span[0]
                     for r in run.requests if r.save_span])
