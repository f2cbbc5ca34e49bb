"""Rotary position embeddings: LTX fractional 3-D RoPE, Wan N-d RoPE,
RIFLEx.

Port of ``ltx_video_gpupoor_tpu/ops/rope.py``: ``rotate_pairs`` (:32),
``apply_rotary_emb`` (:44), ``ltx_freqs_cis`` (:144) with its
``half_layout``, and the Wan side (:113-137, :235-308): ``full_to_half``,
``apply_rotary_emb_shared_heads``, ``identify_k``, ``rope_1d``,
``default_rope_dims`` and ``wan_rope_freqs``. Tables are built in
float32; application computes in float32 and casts back.
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


def full_to_half(tab: torch.Tensor) -> torch.Tensor:
    """Pair-duplicated table ``[..., d]`` -> half layout ``[..., d/2]``."""
    return tab.reshape(*tab.shape[:-1], -1, 2)[..., 0]


def apply_rotary_emb_shared_heads(x: torch.Tensor, cos: torch.Tensor,
                                  sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair RoPE with one half-layout table shared by all
    heads (the Wan layout): ``x [B, S, N, d]``, ``cos``/``sin``
    broadcastable to ``[B, S, N, d/2]``; the output is head-major
    ``[B, N, S, d]``."""
    b, s, n, d = x.shape
    xf = x.float().reshape(b, s, n, d // 2, 2)
    a, b2 = xf[..., 0], xf[..., 1]
    c = cos[..., None, :] if cos.dim() != 4 else cos
    sn = sin[..., None, :] if sin.dim() != 4 else sin
    out = torch.stack([a * c - b2 * sn, b2 * c + a * sn], dim=-1)
    return out.reshape(b, s, n, d).to(x.dtype).transpose(1, 2)


def identify_k(b: float, d: int, n: int) -> tuple[int, int]:
    """The intrinsic RoPE frequency index whose period is closest to
    ``n`` latent frames (RIFLEx Eq. 7)."""
    periods = [round(2 * math.pi * (b ** (2 * (j - 1) / d)))
               for j in range(1, d // 2 + 1)]
    diffs = [abs(p - n) for p in periods]
    k = diffs.index(min(diffs)) + 1
    return k, periods[k - 1]


def rope_1d(dim: int, pos, theta: float = 10000.0,
            riflex_k: int | None = None,
            riflex_l_test: int | None = None,
            device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """1-D tables ``(cos, sin)``, each ``[S, dim]`` pair-duplicated. With
    ``riflex_k`` the k-th frequency is clamped to 90% of one period over
    ``riflex_l_test`` frames (RIFLEx Eq. 8)."""
    pos = torch.as_tensor(pos, dtype=torch.float32, device=device)
    # the power in float64, rounded once (an fp32 pow differs by an ulp
    # between libraries)
    expo = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freqs = (1.0 / torch.pow(torch.tensor(float(theta), dtype=torch.float64,
                                          device=device),
                             expo.double())).float()
    if riflex_k is not None:
        freqs[riflex_k - 1] = 0.9 * 2 * math.pi / riflex_l_test
    angles = torch.outer(pos, freqs)
    return (torch.repeat_interleave(torch.cos(angles), 2, dim=-1),
            torch.repeat_interleave(torch.sin(angles), 2, dim=-1))


def default_rope_dims(head_dim: int) -> tuple[int, int, int]:
    """Wan's head-dim split: even spatial thirds, the rest to time
    (head_dim 128 -> (44, 42, 42))."""
    hw = (head_dim // 3) // 2 * 2
    return (head_dim - 2 * hw, hw, hw)


def wan_rope_freqs(grid_sizes: Sequence[int], head_dim: int = 128,
                   rope_dims: Sequence[int] | None = None,
                   theta: float = 10000.0, enable_riflex: bool = False,
                   device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Wan RoPE tables over an (F, H, W) token grid, flattened row-major
    to ``[F*H*W, head_dim]``, the head dim split per axis as
    ``rope_dims``; RIFLEx (``k=6``, ``L_test = F``) on the time axis."""
    if rope_dims is None:
        rope_dims = default_rope_dims(head_dim)
    if sum(rope_dims) != head_dim:
        raise ValueError(f"rope dims {tuple(rope_dims)} do not sum to "
                         f"{head_dim}")
    f, h, w = grid_sizes
    coses, sins = [], []
    for i, (d, n) in enumerate(zip(rope_dims, (f, h, w))):
        riflex = dict(riflex_k=6, riflex_l_test=f) \
            if i == 0 and enable_riflex else {}
        c, s = rope_1d(d, torch.arange(n), theta, device=device, **riflex)
        coses.append(c)
        sins.append(s)

    def expand(tabs):
        tf = tabs[0][:, None, None, :].expand(f, h, w, -1)
        th = tabs[1][None, :, None, :].expand(f, h, w, -1)
        tw = tabs[2][None, None, :, :].expand(f, h, w, -1)
        return torch.cat([tf, th, tw], dim=-1).reshape(f * h * w, -1)

    return expand(coses), expand(sins)
