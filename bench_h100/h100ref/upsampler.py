"""The LTX latent upsampler in float32: a frozen copy of the port's
``models/ltx/latent_upsampler.py`` (the 3-D body, spatial 2x, the one
configuration in use), with its parameter names and shapes, and
``pipelines/multiscale.py``'s ``adain_filter_latent``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from h100bench import weights

from .common import group_norm


class Conv(nn.Module):
    def __init__(self, cin, cout, kdims, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *(3,) * kdims,
                                               device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout, device=device),
                                 requires_grad=False)

    def forward(self, x):
        if self.weight.dim() == 5:
            return F.conv3d(x, self.weight, self.bias, padding=1)
        b, c, f, h, w = x.shape       # the upsampler's framewise 3x3 conv
        flat = x.transpose(1, 2).reshape(b * f, c, h, w)
        y = F.conv2d(flat, self.weight, self.bias, padding=1)
        return y.reshape(b, f, -1, h, w).transpose(1, 2)


class GroupNorm(nn.Module):
    def __init__(self, channels, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels, device=device),
                                 requires_grad=False)

    def forward(self, x):
        return group_norm(x, 32, self.weight, self.bias, eps=1e-5)


class ResBlock(nn.Module):
    def __init__(self, ch, kdims, *, device=None):
        super().__init__()
        self.conv1 = Conv(ch, ch, kdims, device=device)
        self.norm1 = GroupNorm(ch, device=device)
        self.conv2 = Conv(ch, ch, kdims, device=device)
        self.norm2 = GroupNorm(ch, device=device)

    def forward(self, x):
        h = F.silu(self.norm1(self.conv1(x)))
        return F.silu(self.norm2(self.conv2(h)) + x)


class Upsampler(nn.Module):
    """Spatial 2x upsampler, drawn from ``seed`` as the group
    ``"upsampler"``."""

    def __init__(self, cfg, seed, device):
        super().__init__()
        if cfg.get("temporal_upsample") or not cfg.get("spatial_upsample",
                                                        True) \
                or cfg.get("dims", 3) != 3:
            raise ValueError("the reference upsamples space only, 3-D body")
        body = 3
        mid, n = cfg["mid_channels"], cfg["num_blocks_per_stage"]
        self.initial_conv = Conv(cfg["in_channels"], mid, body, device=device)
        self.initial_norm = GroupNorm(mid, device=device)
        self.res_blocks = nn.ModuleList(ResBlock(mid, body, device=device)
                                        for _ in range(n))
        self.upsampler = Conv(mid, 4 * mid, 2, device=device)
        self.post_upsample_res_blocks = nn.ModuleList(
            ResBlock(mid, body, device=device) for _ in range(n))
        self.final_conv = Conv(mid, cfg["in_channels"], body, device=device)
        weights.fill(self, seed, "upsampler")

    @torch.no_grad()
    def forward(self, latents):
        x = latents.permute(0, 4, 1, 2, 3)
        x = F.silu(self.initial_norm(self.initial_conv(x)))
        for blk in self.res_blocks:
            x = blk(x)
        x = rearrange(self.upsampler(x), "b (c p1 p2) f h w -> b c f (h p1) (w p2)",
                      p1=2, p2=2)
        for blk in self.post_upsample_res_blocks:
            x = blk(x)
        return self.final_conv(x).permute(0, 2, 3, 4, 1)


def adain(latents, reference):
    axes = (1, 2, 3)
    i_mean = latents.mean(dim=axes, keepdim=True)
    i_sd = latents.std(dim=axes, keepdim=True, correction=0)
    r_mean = reference.mean(dim=axes, keepdim=True)
    r_sd = reference.std(dim=axes, keepdim=True, correction=0)
    return ((latents - i_mean) / (i_sd + 1e-8)) * r_sd + r_mean
