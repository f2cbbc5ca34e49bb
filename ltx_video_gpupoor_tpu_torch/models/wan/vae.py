"""Wan 2.1 causal 3-D VAE: the decoder.

Port of ``ltx_video_gpupoor_tpu/models/wan/vae.py``: ``WanVAEConfig`` and
the latent statistics (:38-59), ``causal_conv3d``, ``conv2d_framewise``,
``wan_rms_norm`` (:66-118), the residual and attention blocks and the
spatial and time upsamples (:121-187), ``_decoder_structure`` (:259),
``_run_blocks`` (:340), ``decode`` (:398-425), ``get_vae_tile_size`` and
``spatial_tiled_decode`` (:435-510). Every CausalConv3d is a zero pad of
``2*(kt//2)`` frames in front and a same pad in space; the decoder's time
upsample passes frame 0 through and turns each later frame into two.

The public functions keep JAX's channels-last ``[B, F, H, W, C]``; inside,
activations are torch's ``[B, C, F, H, W]`` and run in the policy's
``compute_dtype``. The convolutions are cuDNN's (``F.conv3d``; the 2-D
framewise ones as 3-D with a time kernel of 1), the attention block a
plain fp32 einsum as in JAX. The encoder belongs to i2v (ROADMAP queue 1
step 13).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...core.dtypes import DEFAULT_POLICY, DtypePolicy
from ..ltx.vae_tiling import blend


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: tuple = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: tuple = ()
    temperal_downsample: tuple = (False, True, True)

    @property
    def temperal_upsample(self) -> tuple:
        return tuple(reversed(self.temperal_downsample))


WAN_LATENT_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], np.float32)
WAN_LATENT_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
], np.float32)


# ---------------------------------------------------------------------------
# Modules (attribute names are the JAX keys)
# ---------------------------------------------------------------------------

class Conv(nn.Module):
    """A conv leaf: ``weight [cout, cin, *kernel]`` (3-D or 2-D) + bias."""

    def __init__(self, cin, cout, kernel, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(cout, cin, *kernel, device=device, dtype=dtype),
            requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout, device=device, dtype=dtype),
                                 requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, c, *, device=None, dtype=torch.float32):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c, device=device, dtype=dtype),
                                  requires_grad=False)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.norm1 = RMSNorm(cin, **kw)
        self.conv1 = Conv(cin, cout, (3, 3, 3), **kw)
        self.norm2 = RMSNorm(cout, **kw)
        self.conv2 = Conv(cout, cout, (3, 3, 3), **kw)
        self.shortcut = Conv(cin, cout, (1, 1, 1), **kw) if cin != cout \
            else None


class AttnBlock(nn.Module):
    def __init__(self, c, **kw):
        super().__init__()
        self.norm = RMSNorm(c, **kw)
        self.to_qkv = Conv(c, 3 * c, (1, 1), **kw)
        self.proj = Conv(c, c, (1, 1), **kw)


class Upsample3d(nn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.resample = Conv(cin, cout, (3, 3), **kw)
        self.time_conv = Conv(cin, 2 * cin, (3, 1, 1), **kw)


class Decoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, **kw):
        super().__init__()
        structure, dec_in = _decoder_structure(cfg)
        final_c = cfg.dim * cfg.dim_mult[::-1][-1]
        self.conv1 = Conv(cfg.z_dim, dec_in, (3, 3, 3), **kw)
        self.middle = nn.ModuleList([ResBlock(dec_in, dec_in, **kw),
                                     AttnBlock(dec_in, **kw),
                                     ResBlock(dec_in, dec_in, **kw)])
        blocks = []
        for kind, cin, cout, _ in structure:
            if kind == "res":
                blocks.append(ResBlock(cin, cout, **kw))
            elif kind == "attn":
                blocks.append(AttnBlock(cin, **kw))
            elif kind == "upsample2d":
                blocks.append(Conv(cin, cout, (3, 3), **kw))
            elif kind == "upsample3d":
                blocks.append(Upsample3d(cin, cout, **kw))
        self.upsamples = nn.ModuleList(blocks)
        self.head_norm = RMSNorm(final_c, **kw)
        self.head_conv = Conv(final_c, 3, (3, 3, 3), **kw)


class WanVAEDecoder(nn.Module):
    """The VAE's decoder half (``conv2`` and ``decoder``)."""

    def __init__(self, cfg: WanVAEConfig, policy: DtypePolicy = DEFAULT_POLICY,
                 *, device=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = policy.compute_dtype
        kw = dict(device=device, dtype=policy.param_dtype)
        self.conv2 = Conv(cfg.z_dim, cfg.z_dim, (1, 1, 1), **kw)
        self.decoder = Decoder(cfg, **kw)


# ---------------------------------------------------------------------------
# Primitives, on [B, C, F, H, W]
# ---------------------------------------------------------------------------

def causal_conv3d(p: Conv, x: torch.Tensor) -> torch.Tensor:
    """Wan CausalConv3d: ``2*(kt//2)`` zero frames in front, same pad in
    space."""
    kt, kh, kw = p.weight.shape[2:]
    x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2, 2 * (kt // 2), 0))
    y = F.conv3d(x, p.weight.to(x.dtype))
    return y + p.bias.to(y.dtype)[:, None, None, None]


def conv2d_framewise(p: Conv, x: torch.Tensor) -> torch.Tensor:
    """A 2-D conv on every frame, same pad (stride 1)."""
    kh, kw = p.weight.shape[2:]
    y = F.conv3d(x, p.weight.to(x.dtype)[:, :, None],
                 padding=(0, kh // 2, kw // 2))
    return y + p.bias.to(y.dtype)[:, None, None, None]


def wan_rms_norm(p: RMSNorm, x: torch.Tensor) -> torch.Tensor:
    """``RMS_norm``: L2-normalize the channels, times sqrt(C) and gamma."""
    xf = x.float()
    norm = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True))
    c = x.shape[1]
    y = xf / torch.clamp(norm, min=1e-12) * (c ** 0.5)
    y = y * p.gamma.float()[:, None, None, None]
    return y.to(x.dtype)


def _residual_block(p: ResBlock, x):
    h = causal_conv3d(p.conv1, F.silu(wan_rms_norm(p.norm1, x)))
    h = causal_conv3d(p.conv2, F.silu(wan_rms_norm(p.norm2, h)))
    sc = causal_conv3d(p.shortcut, x) if p.shortcut is not None else x
    return sc + h


def _attention_block(p: AttnBlock, x):
    """Single-head spatial attention within each frame, fp32 einsum."""
    b, c, f, h, w = x.shape
    identity = x
    qkv = conv2d_framewise(p.to_qkv, wan_rms_norm(p.norm, x))
    qkv = qkv.permute(0, 2, 3, 4, 1).reshape(b * f, h * w, 3 * c)
    q, k, v = qkv.float().chunk(3, dim=-1)
    scores = torch.einsum("bic,bjc->bij", q, k) * (c ** -0.5)
    out = torch.einsum("bij,bjc->bic", torch.softmax(scores, dim=-1), v)
    out = out.to(x.dtype).reshape(b, f, h, w, c).permute(0, 4, 1, 2, 3)
    return conv2d_framewise(p.proj, out) + identity


def _upsample_spatial(p: Conv, x):
    """Nearest 2x, then a 3x3 conv dim -> dim // 2."""
    y = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    return conv2d_framewise(p, y)


def _upsample_time(p: Conv, x):
    """Frame 0 passes; frames 1.. through a causal k-3 conv whose 2C
    output channels are two frames each."""
    b, c, f, h, w = x.shape
    if f == 1:
        return x
    y = causal_conv3d(p, x[:, :, 1:])                     # [B, 2C, F-1, H, W]
    y = y.reshape(b, 2, c, f - 1, h, w).permute(0, 2, 3, 1, 4, 5)
    return torch.cat([x[:, :, :1], y.reshape(b, c, 2 * (f - 1), h, w)], dim=2)


def _decoder_structure(cfg: WanVAEConfig):
    dims = [cfg.dim * u
            for u in (cfg.dim_mult[-1],) + tuple(cfg.dim_mult[::-1])]
    out = []
    scale = 1.0 / 2 ** (len(cfg.dim_mult) - 2)
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        cur = cin // 2 if i in (1, 2, 3) else cin
        for _ in range(cfg.num_res_blocks + 1):
            out.append(("res", cur, cout, None))
            if scale in cfg.attn_scales:
                out.append(("attn", cout, cout, None))
            cur = cout
        if i != len(cfg.dim_mult) - 1:
            mode = "upsample3d" if cfg.temperal_upsample[i] else "upsample2d"
            out.append((mode, cout, cout // 2, None))
            scale *= 2.0
    return out, dims[0]


def _run_blocks(structure, blocks, x):
    for (kind, _, _, _), p in zip(structure, blocks):
        if kind == "res":
            x = _residual_block(p, x)
        elif kind == "attn":
            x = _attention_block(p, x)
        elif kind == "upsample2d":
            x = _upsample_spatial(p, x)
        elif kind == "upsample3d":
            x = _upsample_time(p.time_conv, x)
            x = _upsample_spatial(p.resample, x)
    return x


def _latent_stats(cfg: WanVAEConfig, z: torch.Tensor):
    mean = torch.from_numpy(WAN_LATENT_MEAN[: cfg.z_dim]).to(z.device, z.dtype)
    std = torch.from_numpy(WAN_LATENT_STD[: cfg.z_dim]).to(z.device, z.dtype)
    return mean, std


def decode(vae: WanVAEDecoder, z: torch.Tensor, normalized: bool = True,
           clamp: bool = True) -> torch.Tensor:
    """latents ``[B, F', H', W', z]`` -> video ``[B, 1+4(F'-1), 8H', 8W',
    3]`` in the policy's compute dtype. (JAX's ``any_end_frame``, the
    i2v last-frame decode, comes with i2v.)"""
    cfg = vae.cfg
    z = z.to(vae.compute_dtype)
    if normalized:
        mean, std = _latent_stats(cfg, z)
        z = z * std + mean
    x = causal_conv3d(vae.conv2, z.permute(0, 4, 1, 2, 3))
    dec = vae.decoder
    x = causal_conv3d(dec.conv1, x)
    for i, p in enumerate(dec.middle):
        x = _attention_block(p, x) if i == 1 else _residual_block(p, x)
    structure, _ = _decoder_structure(cfg)
    x = _run_blocks(structure, dec.upsamples, x)
    x = F.silu(wan_rms_norm(dec.head_norm, x))
    x = causal_conv3d(dec.head_conv, x).permute(0, 2, 3, 4, 1)
    return torch.clamp(x, -1.0, 1.0) if clamp else x


def get_vae_tile_size(vae_config: int, device_mem_mb: float,
                      mixed_precision: bool = False) -> int:
    """Pixel tile size policy: 0 = untiled."""
    if vae_config == 0:
        if mixed_precision:
            device_mem_mb = device_mem_mb / 2
        if device_mem_mb >= 24000:
            vae_config = 1
        elif device_mem_mb >= 8000:
            vae_config = 2
        else:
            vae_config = 3
    return {1: 0, 2: 256, 3: 128}[vae_config]


def spatial_tiled_decode(vae: WanVAEDecoder, z: torch.Tensor,
                         tile_size: int = 256,
                         normalized: bool = True) -> torch.Tensor:
    """Tiled :func:`decode` with a 25% overlap crossfade: one tile's
    decoder activations live at a time."""
    cfg = vae.cfg
    sf = 2 ** (len(cfg.dim_mult) - 1)
    lat_tile = tile_size // sf
    overlap = int(lat_tile * 0.75)
    blend_extent = int(tile_size * 0.25)
    row_limit = tile_size - blend_extent
    h_lat, w_lat = z.shape[2], z.shape[3]
    if h_lat <= lat_tile and w_lat <= lat_tile:
        return decode(vae, z, normalized)
    z = z.to(vae.compute_dtype)
    if normalized:
        mean, std = _latent_stats(cfg, z)
        z = z * std + mean
    rows = []
    for i in range(0, h_lat, overlap):
        rows.append([decode(vae, z[:, :, i:i + lat_tile, j:j + lat_tile],
                            False, False)
                     for j in range(0, w_lat, overlap)])
    result_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            # the neighbours are the already-blended tiles, as in JAX
            if i > 0:
                tile = blend(rows[i - 1][j], tile, blend_extent, axis=2)
            if j > 0:
                tile = blend(row[j - 1], tile, blend_extent, axis=3)
            row[j] = tile
            out_row.append(tile[:, :, :row_limit, :row_limit])
        result_rows.append(torch.cat(out_row, dim=3))
    return torch.clamp(torch.cat(result_rows, dim=2), -1.0, 1.0)


@torch.no_grad()
def init_params(vae: WanVAEDecoder, generator: torch.Generator
                ) -> WanVAEDecoder:
    """Random weights in the JAX ``init_params`` distribution: conv
    kernels N(0, 1/fan_in), zero biases, unit gammas, and the attention
    blocks' ``proj`` zero, as JAX initializes it."""
    for mod in vae.modules():
        if isinstance(mod, Conv):
            w = mod.weight
            fan_in = math.prod(w.shape[1:])
            w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                                dtype=w.dtype) * fan_in ** -0.5)
    for mod in vae.modules():
        if isinstance(mod, AttnBlock):
            mod.proj.weight.zero_()
    return vae
