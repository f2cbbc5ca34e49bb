"""How far the card trails the host at the end of each step of the first
pass: the device end of a ``step`` span minus its host end, in ms, from
the port's own request records (``h100bench/spans.py``); the median over
the window's first-pass steps. Near zero the card has drained by the
step's end: the host could not issue ahead of it, or waited for it in a
synchronizing copy inside the step; a long lead means the host runs ahead
and the card sets the pace."""

import statistics

from h100bench import spans


def read(run):
    leads = [1e3 * (s["device_s"][1] - s["end_s"])
             for r in spans.window_records(run)
             for s in spans.first_pass(r)[1] if s["device_s"]]
    return statistics.median(leads) if leads else None
