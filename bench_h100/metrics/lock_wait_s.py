"""Seconds a request of the window waited for the generation lock: its
``lock_wait`` spans summed (host clock), from the port's own request
records (``h100bench/spans.py``); the mean over the window's requests."""

from h100bench import spans


def read(run):
    return run.mean([sum(s["end_s"] - s["start_s"] for s in r["spans"]
                         if s["name"] == "lock_wait")
                     for r in spans.window_records(run)])
