"""Resolution bucketing: snap a request's size to a bounded set of shapes.

Pinned copy of ``ltx_video_gpupoor_tpu/utils/resolution.py`` (the JAX
package cannot be imported without jax; ``tests/test_torch_serving.py``
pins the two equal). On the TPU every distinct (height, width, frames)
compiles a new program; here a bounded set of shapes keeps the server's
warm-up buckets and the allocator's block sizes few. The bins are
generated from the rule the reference's aspect-ratio tables encode: for
each aspect ratio, the (h, w) pair on a 32-pixel grid whose area is as
close as possible to (but not above) ``base**2``.
"""

from __future__ import annotations

import functools


@functools.lru_cache(maxsize=None)
def aspect_ratio_bins(
    base: int = 512,
    block: int = 32,
    min_side: int | None = None,
    max_side: int | None = None,
) -> dict[float, tuple[int, int]]:
    """Map aspect ratio -> (height, width) on the ``block`` grid with area
    maximal under ``base**2``. Covers ratios from 1:4 to 4:1."""
    if min_side is None:
        min_side = base // 2
    if max_side is None:
        max_side = base * 2
    budget = base * base
    bins: dict[float, tuple[int, int]] = {}
    h = min_side
    while h <= max_side:
        # widest width within the area budget, on the grid
        w = (budget // h) // block * block
        if min_side <= w <= max_side:
            ratio = round(h / w, 2)
            cand = (h, w)
            if ratio not in bins or cand[0] * cand[1] > bins[ratio][0] * bins[ratio][1]:
                bins[ratio] = cand
        h += block
    return dict(sorted(bins.items()))


def snap_to_bin(
    height: int,
    width: int,
    base: int = 512,
    block: int = 32,
) -> tuple[int, int]:
    """Snap (height, width) to the generated bin with the nearest aspect
    ratio — the bucketing policy that keeps the number of compiled
    programs bounded by the bin count regardless of user-supplied sizes."""
    bins = aspect_ratio_bins(base, block)
    ratio = height / width
    best = min(bins, key=lambda r: abs(r - ratio))
    return bins[best]


def bucketed_dimensions(
    height: int,
    width: int,
    frame_num: int,
    base: int | None = None,
) -> tuple[int, int, int]:
    """Full bucketing: snap H/W to the aspect bin of the nearest base
    (chosen by area when ``base`` is None), frames UP to the next point
    of the 8k+1 grid the causal VAE requires (``((f-2)//8+1)*8+1``); padding
    up never silently shortens the
    requested clip (callers should surface the result when it differs
    from the request — see ``serving/orchestrator.py``)."""
    if base is None:
        area = height * width
        base = min((512, 768, 1024), key=lambda b: abs(b * b - area))
    h, w = snap_to_bin(height, width, base=base)
    f = max(frame_num, 1)
    frames = ((f - 2) // 8 + 1) * 8 + 1
    return h, w, frames
