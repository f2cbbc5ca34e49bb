"""Seconds a video in the VAE decode, from the ``decode`` mark to the
``postprocess`` one."""


def read(run):
    return run.mean([r.marks["postprocess"] - r.marks["decode"]
                     for r in run.requests
                     if "decode" in r.marks and "postprocess" in r.marks])
