"""Normalization primitives (fp32 math, cast back to the input dtype).

Port of ``ltx_video_gpupoor_tpu/ops/norms.py`` (``rms_norm``,
``layer_norm``, ``pixel_norm``, ``group_norm``). Pure functions: none
updates its input in place (the reference's in-place RMSNorm corrupted
its fp32 input, ROADMAP queue 3).
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
               bias: torch.Tensor | None = None,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def pixel_norm(x: torch.Tensor, axis: int = 1,
               eps: float = 1e-8) -> torch.Tensor:
    """Per-pixel channel norm over ``axis``."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=axis, keepdim=True) + eps)
    return y.to(x.dtype)


def group_norm(x: torch.Tensor, num_groups: int,
               weight: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, eps: float = 1e-6,
               channel_axis: int = -1) -> torch.Tensor:
    """GroupNorm over ``channel_axis`` (axis 0 is the batch)."""
    xf = x.float()
    ax = channel_axis % xf.ndim
    c = xf.shape[ax]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    xg = xf.reshape(xf.shape[:ax] + (num_groups, c // num_groups)
                    + xf.shape[ax + 1:])
    red = tuple(i for i in range(xg.ndim) if i not in (0, ax))
    mu = xg.mean(dim=red, keepdim=True)
    var = (xg - mu).square().mean(dim=red, keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(xf.shape)
    shape = [1] * xf.ndim
    shape[ax] = c
    if weight is not None:
        y = y * weight.float().reshape(shape)
    if bias is not None:
        y = y + bias.float().reshape(shape)
    return y.to(x.dtype)
