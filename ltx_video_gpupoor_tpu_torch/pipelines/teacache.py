"""TeaCache step-skip schedules, precomputed.

A pinned copy of ``ltx_video_gpupoor_tpu/pipelines/teacache.py`` (numpy
only; held equal by ``tests/test_torch_teacache.py``). TeaCache decides
per step whether the block stack can be skipped and the previous step's
residual reused, from the relative change of the timestep embedding
between steps. That signal depends only on the (known, static) timestep
list, so the whole accumulate-and-threshold state machine is computed
ahead into a boolean mask.

``calibrate_mask`` is the model-agnostic core: feed it the per-step
timestep-embedding vectors and a target speed multiplier; it searches the
threshold whose executed-step count is closest to ``n / multiplier`` and
returns the compute mask. The LTX wrapper is
``pipelines/ltx_pipeline.py::ltx_teacache_schedule``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def calibrate_mask(
    e_list: np.ndarray,                 # [steps, D] timestep embeddings
    multiplier: float,
    coefficients: Optional[Sequence[float]] = None,
    start_step: int = 0,
) -> np.ndarray:
    """Boolean per-step compute mask with ~``len/multiplier`` True entries.

    ``coefficients``: optional polynomial rescale of the relative deltas
    (TeaCache's published per-model fits); identity when None.
    """
    e_list = np.asarray(e_list, np.float32)
    n = len(e_list)
    rescale = np.poly1d(coefficients) if coefficients is not None else None

    def delta(i):
        prev, cur = e_list[i - 1], e_list[i]
        rel = np.abs(cur - prev).mean() / (np.abs(prev).mean() + 1e-12)
        return abs(float(rescale(rel))) if rescale is not None else rel

    # computed once: the 121-threshold sweep below reuses these
    deltas = [0.0] + [delta(i) for i in range(1, n)]

    def run(threshold):
        acc, steps_run, mask = 0.0, 0, []
        for i in range(n):
            skip = False
            # first steps and the last step always compute
            if not (i <= start_step or i == n - 1):
                acc += deltas[i]
                if acc < threshold:
                    skip = True
                else:
                    acc = 0.0
            mask.append(not skip)
            if not skip:
                steps_run += 1
        return steps_run, np.asarray(mask)

    target = int(n / multiplier)
    # Sweep thresholds over the actual delta distribution (deriving the
    # range from the deltas keeps calibration model-agnostic).
    ds = deltas[1:] or [0.0]
    lo = 0.5 * min(ds)
    hi = float(np.sum(ds)) + 1e-6
    best_diff, best_mask = 10**9, np.ones(n, bool)
    for thr in np.linspace(lo, hi, 121):
        steps_run, mask = run(float(thr))
        diff = abs(target - steps_run)
        if diff < best_diff:
            best_diff, best_mask = diff, mask
    return best_mask
