"""Latent upsampler of the multi-scale LTX pipeline.

Port of ``ltx_video_gpupoor_tpu/models/ltx/latent_upsampler.py``:
``LatentUpsamplerConfig`` (:23), ``init_params`` (:86) and ``forward``
(:134): a ResBlock stack, a pixel-shuffle 2x spatial (optionally
temporal) upsample and a second ResBlock stack, in un-normalized latent
space. ``dims=2`` applies 2-D convolutions frame by frame (the shipped
spatial-upscaler checkpoints), ``dims=3`` full 3-D convolutions with zero
padding. :func:`forward` keeps the JAX layout ``[B, F, H, W, C]``; inside,
tensors are channels-first. Module attribute names are the JAX keys
(``core/from_jax.py``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from ...core.dtypes import DEFAULT_POLICY, DtypePolicy
from ...ops.norms import group_norm


@dataclasses.dataclass(frozen=True)
class LatentUpsamplerConfig:
    in_channels: int = 128
    mid_channels: int = 512
    num_blocks_per_stage: int = 4
    dims: int = 3
    spatial_upsample: bool = True
    temporal_upsample: bool = False


def _check_cfg(cfg: LatentUpsamplerConfig) -> None:
    if not (cfg.spatial_upsample or cfg.temporal_upsample):
        raise ValueError(
            "Either spatial_upsample or temporal_upsample must be True")
    if cfg.dims == 2 and (cfg.temporal_upsample or not cfg.spatial_upsample):
        raise ValueError(
            "dims=2 supports spatial upsampling only (reference parity)")


class Conv(nn.Module):
    """A 3x3 (``kdims=2``, framewise) or 3x3x3 convolution, same padding
    with zeros, on ``[B, C, F, H, W]``."""

    def __init__(self, cin, cout, kdims, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cout, cin, *(3,) * kdims, device=device, dtype=dtype),
            requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout, device=device, dtype=dtype),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        bias = self.bias.to(x.dtype)
        if w.dim() == 5:
            return F.conv3d(x, w, bias, padding=1)
        b, c, f, h, wd = x.shape
        flat = x.transpose(1, 2).reshape(b * f, c, h, wd)
        y = F.conv2d(flat, w, bias, padding=1)
        return y.reshape(b, f, -1, h, wd).transpose(1, 2)


class GroupNorm(nn.Module):
    def __init__(self, channels, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device,
                                              dtype=dtype),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels, device=device,
                                             dtype=dtype),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, 32, self.weight, self.bias, eps=1e-5,
                          channel_axis=1)


class ResBlock(nn.Module):
    def __init__(self, channels, kdims, **kw):
        super().__init__()
        self.conv1 = Conv(channels, channels, kdims, **kw)
        self.norm1 = GroupNorm(channels, **kw)
        self.conv2 = Conv(channels, channels, kdims, **kw)
        self.norm2 = GroupNorm(channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.norm1(self.conv1(x)))
        h = self.norm2(self.conv2(h))
        return F.silu(h + x)


class LatentUpsampler(nn.Module):
    def __init__(self, cfg: LatentUpsamplerConfig,
                 policy: DtypePolicy = DEFAULT_POLICY, *, device=None):
        super().__init__()
        _check_cfg(cfg)
        self.cfg = cfg
        self.compute_dtype = policy.compute_dtype
        kw = dict(device=device, dtype=policy.param_dtype)
        body = 2 if cfg.dims == 2 else 3
        mid = cfg.mid_channels
        self.initial_conv = Conv(cfg.in_channels, mid, body, **kw)
        self.initial_norm = GroupNorm(mid, **kw)
        self.res_blocks = nn.ModuleList(
            ResBlock(mid, body, **kw) for _ in range(cfg.num_blocks_per_stage))
        if cfg.spatial_upsample and cfg.temporal_upsample:
            self.upsampler = Conv(mid, 8 * mid, 3, **kw)
        elif cfg.spatial_upsample:
            self.upsampler = Conv(mid, 4 * mid, 2, **kw)
        else:
            self.upsampler = Conv(mid, 2 * mid, 3, **kw)
        self.post_upsample_res_blocks = nn.ModuleList(
            ResBlock(mid, body, **kw) for _ in range(cfg.num_blocks_per_stage))
        self.final_conv = Conv(mid, cfg.in_channels, body, **kw)


def forward(model: LatentUpsampler, latents: torch.Tensor) -> torch.Tensor:
    """``[B, F, H, W, C]`` un-normalized latents -> the upsampled grid in
    the policy's compute dtype."""
    cfg = model.cfg
    x = latents.to(model.compute_dtype).permute(0, 4, 1, 2, 3)
    x = F.silu(model.initial_norm(model.initial_conv(x)))
    for blk in model.res_blocks:
        x = blk(x)
    x = model.upsampler(x)
    if cfg.temporal_upsample and cfg.spatial_upsample:
        x = rearrange(x, "b (c p1 p2 p3) d h w -> b c (d p1) (h p2) (w p3)",
                      p1=2, p2=2, p3=2)[:, :, 1:]
    elif cfg.spatial_upsample:
        x = rearrange(x, "b (c p1 p2) f h w -> b c f (h p1) (w p2)",
                      p1=2, p2=2)
    else:
        x = rearrange(x, "b (c p1) d h w -> b c (d p1) h w", p1=2)[:, :, 1:]
    for blk in model.post_upsample_res_blocks:
        x = blk(x)
    return model.final_conv(x).permute(0, 2, 3, 4, 1)


@torch.no_grad()
def init_params(model: LatentUpsampler, generator: torch.Generator
                ) -> LatentUpsampler:
    """Random weights in the JAX ``init_params`` distribution: kernels
    N(0, 1/fan_in), zero biases, unit norms."""
    for mod in model.modules():
        if isinstance(mod, Conv):
            w = mod.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                                dtype=w.dtype) * fan_in ** -0.5)
    return model
