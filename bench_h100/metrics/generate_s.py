"""Seconds a video in ``LTXVideoGenerator.generate``, which returns host
arrays, so its end has synchronized."""


def read(run):
    return run.mean([r.gen_span[1] - r.gen_span[0]
                     for r in run.requests if r.gen_span])
