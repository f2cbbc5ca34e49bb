"""Spatial tiling helpers.

Port of ``ltx_video_gpupoor_tpu/models/ltx/vae_tiling.py``: ``_ramp``
(:79) and ``blend`` (:83), the linear crossfade that the Wan VAE's tiled
decode uses. The LTX tiled decode itself is still to be ported (ROADMAP
queue 1 step 10).
"""

from __future__ import annotations

import torch


def _ramp(extent: int, dtype, device=None) -> torch.Tensor:
    return (torch.arange(extent, dtype=torch.float32, device=device)
            / extent).to(dtype)


def blend(a: torch.Tensor, b: torch.Tensor, extent: int,
          axis: int) -> torch.Tensor:
    """Linear crossfade: b's leading ``extent`` slices along ``axis``
    blended with a's trailing ``extent`` slices."""
    extent = min(a.shape[axis], b.shape[axis], extent)
    if extent <= 0:
        return b
    shape = [1] * b.dim()
    shape[axis] = extent
    w = _ramp(extent, b.dtype, b.device).reshape(shape)
    a_tail = a.narrow(axis, a.shape[axis] - extent, extent)
    b_head = b.narrow(axis, 0, extent)
    blended = a_tail * (1 - w) + b_head * w
    return torch.cat([blended, b.narrow(axis, extent, b.shape[axis] - extent)],
                     dim=axis)
