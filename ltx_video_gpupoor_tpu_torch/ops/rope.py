"""LTX fractional 3-D rotary position embeddings.

Port of ``ltx_video_gpupoor_tpu/ops/rope.py``: ``rotate_pairs`` (:32),
``apply_rotary_emb`` (:44) and ``ltx_freqs_cis`` (:144) with its
``half_layout``. Tables are built in float32; application computes in
float32 and casts back. The Wan N-d RoPE and RIFLEx join with the Wan
family (ROADMAP queue 1 step 13).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """(x1, x2, x3, x4, ...) -> (-x2, x1, -x4, x3, ...)."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    a, b = x2[..., 0], x2[..., 1]
    return torch.stack([-b, a], dim=-1).reshape(x.shape)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair RoPE; ``cos``/``sin`` are pair-duplicated to the
    width of ``x`` or half width (one entry per rotation pair)."""
    if cos.shape[-1] * 2 == x.shape[-1]:
        xf = x.float().reshape(*x.shape[:-1], -1, 2)
        a, b = xf[..., 0], xf[..., 1]
        out = torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1)
        return out.reshape(x.shape).to(x.dtype)
    xf = x.float()
    return (xf * cos + rotate_pairs(xf) * sin).to(x.dtype)


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """float32 ``linspace`` by ``jnp.linspace``'s formula as XLA runs it
    (``start * (1 - s) + stop * s`` with ``s = i * (1/div)``, endpoint
    appended). ``torch.linspace`` rounds some elements one ulp apart, and
    the angles of the LTX tables reach 1.6e4 rad, where one ulp of the
    frequency moves a cosine by 1e-2."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32, device=device)
    div = num - 1
    recip = torch.tensor(1.0, dtype=torch.float32) / div
    step = torch.arange(div, dtype=torch.float32, device=device) * recip.to(device)
    out = torch.tensor(start, dtype=torch.float32) * (1 - step) + \
        torch.tensor(stop, dtype=torch.float32) * step
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32,
                                        device=device)])


def ltx_freqs_cis(
    indices_grid: torch.Tensor,
    dim: int,
    theta: float = 10000.0,
    max_pos: Sequence[int] = (20, 2048, 2048),
    half_layout: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fractional 3-D RoPE tables from ``[B, 3, S]`` (frame, y, x) coords.

    Returns ``(cos, sin)``, each ``[B, S, dim]`` float32, or ``[B, S,
    dim/2]`` with ``half_layout``. Frequencies use the JAX package's
    default ``"exp"`` spacing, the one LTX uses."""
    dev = indices_grid.device
    fractional = torch.stack(
        [indices_grid[:, i].float() / max_pos[i] for i in range(3)], dim=-1
    )  # [B, S, 3]
    n = dim // 6
    start = math.log(1.0, theta) if theta != 1.0 else 0.0
    # the power in float64, rounded once (an fp32 pow differs by an ulp
    # between libraries)
    indices = torch.pow(torch.tensor(float(theta), dtype=torch.float64),
                        linspace(start, 1.0, n, device=dev).double()).float()
    indices = indices * math.pi / 2

    b, s = fractional.shape[:2]
    freqs = indices[None, None, :, None] * (fractional[:, :, None, :] * 2 - 1)
    freqs = freqs.reshape(b, s, -1)

    pad = dim % 6
    if half_layout:
        if pad % 2:
            raise ValueError("half layout needs a pair-aligned pad")
        cos, sin = torch.cos(freqs), torch.sin(freqs)
        if pad:
            cos = torch.cat([torch.ones_like(cos[..., :pad // 2]), cos], -1)
            sin = torch.cat([torch.zeros_like(sin[..., :pad // 2]), sin], -1)
        return cos, sin
    cos = torch.repeat_interleave(torch.cos(freqs), 2, dim=-1)
    sin = torch.repeat_interleave(torch.sin(freqs), 2, dim=-1)
    if pad:
        cos = torch.cat([torch.ones_like(cos[..., :pad]), cos], -1)
        sin = torch.cat([torch.zeros_like(sin[..., :pad]), sin], -1)
    return cos, sin
