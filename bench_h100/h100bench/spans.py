"""The port's own request records for the window: the ring of
``ltx_video_gpupoor_tpu_torch/utils/observability.py`` (``records()``),
which outlives the service, read after the window.

A record of kind ``request`` whose root span started at or after the
window's opening is one of the window's requests; the warm-up's records
(kind ``warmup``) and anything before the window are left out. A program
without the ring gives no records, and its readers no value.
"""

from __future__ import annotations


def window_records(run) -> list[dict]:
    try:
        from ltx_video_gpupoor_tpu_torch.utils import observability
    except ImportError:
        return []
    records = getattr(observability, "records", None)
    if records is None:
        return []
    t_open = run.window.t_open
    return [r for r in records()
            if r.get("kind") == "request" and r.get("spans")
            and r["spans"][0]["start_s"] >= t_open]


def first_pass(record: dict):
    """The record's first ``denoise`` span (pass 1 of a multi-scale
    pipeline, the one pass of a base one) and its ``step`` spans; (None,
    []) where it has none."""
    denoise = [s for s in record["spans"] if s["name"] == "denoise"]
    if not denoise:
        return None, []
    first = min(denoise, key=lambda s: s["start_s"])
    return first, [s for s in record["spans"]
                   if s["name"] == "step" and s["parent"] == first["id"]]
