"""The share of the first pass's host time in which the generating thread
was off the CPU: 100 x (1 - its CPU seconds over the host seconds) summed
over the window's first-pass ``step`` spans, from the port's own request
records (``h100bench/spans.py``). High: the thread waits (for the
interpreter lock, or the cores the other client's mp4 write holds)."""

from h100bench import spans


def read(run):
    steps = [s for r in spans.window_records(run)
             for s in spans.first_pass(r)[1] if s["cpu_s"] is not None]
    host = sum(s["end_s"] - s["start_s"] for s in steps)
    if not host:
        return None
    return 100.0 * (1.0 - sum(s["cpu_s"] for s in steps) / host)
