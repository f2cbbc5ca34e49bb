"""Device seconds of a request's first pass: the device interval of its
first ``denoise`` span (pass 1 of the 13B at 3840 tokens, the 2B's one
pass), from the CUDA events of the port's own request records
(``h100bench/spans.py``); the mean over the window's requests."""

from h100bench import spans


def _seconds(record):
    first, _ = spans.first_pass(record)
    if first is None or not first["device_s"]:
        return None
    return first["device_s"][1] - first["device_s"][0]


def read(run):
    return run.mean([_seconds(r) for r in spans.window_records(run)])
