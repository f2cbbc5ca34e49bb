"""Seconds a video in the denoise passes, from the ``on_stage`` marks (each
mark synchronizes the device first): pass 1 and pass 2 of a multi-scale
pipeline, the one pass of a base one."""


def denoise_seconds(marks):
    if "pass1" in marks and "upsample" in marks and "pass2" in marks:
        if "decode" not in marks:
            return None
        return (marks["upsample"] - marks["pass1"]) + \
            (marks["decode"] - marks["pass2"])
    if "denoise" in marks and "decode" in marks:
        return marks["decode"] - marks["denoise"]
    return None


def read(run):
    return run.mean([denoise_seconds(r.marks) for r in run.requests])
