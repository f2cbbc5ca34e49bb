"""The share of the traced window (whole generations from the window's
first request) in which no kernel, copy or set runs on the card, in %."""


def read(run):
    t = run.trace
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
