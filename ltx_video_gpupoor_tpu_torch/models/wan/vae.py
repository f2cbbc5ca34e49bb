"""Wan 2.1 causal 3-D VAE: the decoder and the encoder.

Port of ``ltx_video_gpupoor_tpu/models/wan/vae.py``: ``WanVAEConfig`` and
the latent statistics (:38-59), ``causal_conv3d``, ``conv2d_framewise``,
``wan_rms_norm`` (:66-118), the residual and attention blocks, the spatial
and time downsamples and upsamples (:121-187), ``_encoder_structure``
(:238), ``_decoder_structure`` (:259), ``_run_blocks`` (:340),
``_encode_raw`` and ``encode`` with ``any_end_frame`` (:359-395),
``decode`` (:398-425), ``get_vae_tile_size``, ``spatial_tiled_decode``
(:435-510), ``parallel_spatial_tiled_decode`` (:513-550, the tile grid
over every rank of a mesh) and ``spatial_tiled_encode`` (:561). Every CausalConv3d is a
zero pad of ``2*(kt//2)`` frames in front and a same pad in space; the
decoder's time upsample passes frame 0 through and turns each later frame
into two; the encoder's time downsample passes frame 0 through and takes
frames ``2j - 2 .. 2j`` into frame j.

The encoder computes JAX's function of the whole clip, but streams it:
the clip enters the frame 0 first, then :data:`ENCODE_CHUNK_FRAMES` frames
at a time, each chunk through every layer (:class:`_EncodeStream`). A
causal conv's output frames ``t0 .. t1`` read input frames ``t0 - 2 ..
t1`` (zeros before the first), so each conv keeps the last two frames of
its input; a time downsample keeps the frame its next window starts at;
the norms, SiLU and the per-frame attention act on each frame alone. So
the activations stay a chunk's size: a 1280x720x81 clip's first
activation is 14.3 GB in bf16 a layer, and a residual block holds three
(its input, its two convs' outputs), which with a 14B DiT, UMT5-XXL and
CLIP resident does not fit an 80 GB card.

The public functions keep JAX's channels-last ``[B, F, H, W, C]``; inside,
activations are torch's ``[B, C, F, H, W]`` and run in the policy's
``compute_dtype``. The convolutions are cuDNN's (``F.conv3d``; the 2-D
framewise ones as 3-D with a time kernel of 1), the attention block a
plain fp32 einsum as in JAX. :class:`WanVAEDecoder` holds the decoder
half, :class:`WanVAE` both (i2v encodes its conditioning frames).
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


# input frames the encoder takes at a time after the first (None: the whole
# clip at once): a chunk of 4 makes one latent frame
ENCODE_CHUNK_FRAMES = 4

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


class Downsample3d(nn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.resample = Conv(cin, cout, (3, 3), **kw)
        self.time_conv = Conv(cout, cout, (3, 1, 1), **kw)


class Encoder(nn.Module):
    def __init__(self, cfg: WanVAEConfig, **kw):
        super().__init__()
        structure, enc_out = _encoder_structure(cfg)
        self.conv1 = Conv(3, cfg.dim, (3, 3, 3), **kw)
        blocks = []
        for kind, cin, cout, _ in structure:
            if kind == "res":
                blocks.append(ResBlock(cin, cout, **kw))
            elif kind == "attn":
                blocks.append(AttnBlock(cin, **kw))
            elif kind == "downsample2d":
                blocks.append(Conv(cin, cout, (3, 3), **kw))
            elif kind == "downsample3d":
                blocks.append(Downsample3d(cin, cout, **kw))
        self.downsamples = nn.ModuleList(blocks)
        self.middle = nn.ModuleList([ResBlock(enc_out, enc_out, **kw),
                                     AttnBlock(enc_out, **kw),
                                     ResBlock(enc_out, enc_out, **kw)])
        self.head_norm = RMSNorm(enc_out, **kw)
        self.head_conv = Conv(enc_out, 2 * cfg.z_dim, (3, 3, 3), **kw)


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


class WanVAE(WanVAEDecoder):
    """The whole VAE: the decoder half and the encoder (``encoder`` and
    the posterior's ``conv1``)."""

    def __init__(self, cfg: WanVAEConfig, policy: DtypePolicy = DEFAULT_POLICY,
                 *, device=None):
        super().__init__(cfg, policy, device=device)
        kw = dict(device=device, dtype=policy.param_dtype)
        self.encoder = Encoder(cfg, **kw)
        self.conv1 = Conv(2 * cfg.z_dim, 2 * cfg.z_dim, (1, 1, 1), **kw)


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


def _residual_block(p: ResBlock, x, conv=causal_conv3d):
    """The residual block, its causal convs through ``conv(p, x)``."""
    h = conv(p.conv1, F.silu(wan_rms_norm(p.norm1, x)))
    h = conv(p.conv2, F.silu(wan_rms_norm(p.norm2, h)))
    sc = conv(p.shortcut, x) if p.shortcut is not None else x
    return h.add_(sc)


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


def _downsample_spatial(p: Conv, x):
    """A zero row and column at the bottom and right, then a stride-2 3x3
    conv on each frame."""
    y = F.conv3d(F.pad(x, (0, 1, 0, 1)), p.weight.to(x.dtype)[:, :, None],
                 stride=(1, 2, 2))
    return y + p.bias.to(y.dtype)[:, None, None, None]


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


def _encoder_structure(cfg: WanVAEConfig):
    """(kind, cin, cout, extra) descriptors in forward order, and the
    encoder's output width."""
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    out = []
    scale = 1.0
    for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
        cur = cin
        for _ in range(cfg.num_res_blocks):
            out.append(("res", cur, cout, None))
            if scale in cfg.attn_scales:
                out.append(("attn", cout, cout, None))
            cur = cout
        if i != len(cfg.dim_mult) - 1:
            mode = ("downsample3d" if cfg.temperal_downsample[i]
                    else "downsample2d")
            out.append((mode, cout, cout, None))
            scale /= 2.0
    return out, dims[-1]


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


class _EncodeStream:
    """The encoder's layers over a clip that arrives a few frames at a
    time: each causal conv keeps the last ``2*(kt//2)`` frames of its
    input, each time downsample the frames from its next window's start,
    so that every output frame reads the input frames it reads in the
    whole-clip layer (zeros before the first)."""

    def __init__(self):
        self.tails = {}

    def conv(self, p: Conv, x: torch.Tensor) -> torch.Tensor:
        """``causal_conv3d(p, x)`` of the clip so far, for ``x``'s
        frames."""
        front = 2 * (p.weight.shape[2] // 2)
        prev = self.tails.get(id(p))
        full = x if prev is None else torch.cat([prev, x], dim=2)
        if front:
            self.tails[id(p)] = full[:, :, -front:].clone()
        pad = front - (full.shape[2] - x.shape[2])
        kh, kw = p.weight.shape[3:]
        full = F.pad(full, (kw // 2, kw // 2, kh // 2, kh // 2, pad, 0))
        y = F.conv3d(full, p.weight.to(full.dtype))
        return y + p.bias.to(y.dtype)[:, None, None, None]

    def downsample_time(self, p: Conv, x: torch.Tensor) -> torch.Tensor:
        """Frame 0 passes; frame j >= 1 is the stride-2 kernel-3 window
        over frames ``2j - 2 .. 2j``: those of the windows ``x`` closes
        (none, it may be)."""
        key = id(p)
        out = []
        if key in self.tails:
            x = torch.cat([self.tails[key], x], dim=2)
        else:
            out.append(x[:, :, :1])
        k = (x.shape[2] - 1) // 2
        if k > 0:
            y = F.conv3d(x[:, :, :2 * k + 1], p.weight.to(x.dtype),
                         stride=(2, 1, 1))
            out.append(y + p.bias.to(y.dtype)[:, None, None, None])
        self.tails[key] = x[:, :, 2 * k:].clone()
        return torch.cat(out, dim=2) if out else x[:, :, :0]

    def encode(self, vae: "WanVAE", x: torch.Tensor):
        """The next frames of ``_encode_raw``'s output for input frames
        ``x`` (None where they close no latent frame)."""
        enc = vae.encoder
        x = self.conv(enc.conv1, x)
        structure, _ = _encoder_structure(vae.cfg)
        for (kind, _, _, _), p in zip(structure, enc.downsamples):
            if kind == "res":
                x = _residual_block(p, x, self.conv)
            elif kind == "attn":
                x = _attention_block(p, x)
            elif kind == "downsample2d":
                x = _downsample_spatial(p, x)
            else:                                   # downsample3d
                x = self.downsample_time(
                    p.time_conv, _downsample_spatial(p.resample, x))
                if x.shape[2] == 0:
                    return None
        for i, p in enumerate(enc.middle):
            x = _attention_block(p, x) if i == 1 \
                else _residual_block(p, x, self.conv)
        return self.conv(enc.head_conv,
                         F.silu(wan_rms_norm(enc.head_norm, x)))


def _run_blocks(structure, blocks, x):
    """The decoder's blocks (residual, attention, the time and spatial
    upsamples) over the whole clip."""
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


def _encode_raw(vae: WanVAE, x: torch.Tensor, chunk) -> torch.Tensor:
    """``[B, 3, F, H, W]`` -> the posterior's ``[B, 2z, F', H/8, W/8]``
    before ``conv1``: frame 0, then ``chunk`` frames at a time (None: the
    whole clip at once) through :class:`_EncodeStream`."""
    f = x.shape[2]
    bounds = [0, f] if chunk is None else [0, *range(1, f, chunk), f]
    stream = _EncodeStream()
    out = [stream.encode(vae, x[:, :, t0:t1])
           for t0, t1 in zip(bounds[:-1], bounds[1:])]
    return torch.cat([y for y in out if y is not None], dim=2)


def encode(vae: WanVAE, video: torch.Tensor, normalize: bool = True,
           any_end_frame: bool = False) -> torch.Tensor:
    """video ``[B, F, H, W, 3]`` in [-1, 1] -> the posterior mean ``[B,
    F', H/8, W/8, z]`` (normalized by the latent statistics unless
    ``normalize=False``), in the policy's compute dtype. F is 4k+1 (4k+2
    with ``any_end_frame``, whose last frame is encoded alone, from a
    fresh causal state, and appended). The clip enters frame 0 first,
    then :data:`ENCODE_CHUNK_FRAMES` frames at a time (None: the whole
    clip at once): the same function either way."""
    chunk = ENCODE_CHUNK_FRAMES
    x = video.to(vae.compute_dtype).permute(0, 4, 1, 2, 3)
    if any_end_frame:
        x = torch.cat([_encode_raw(vae, x[:, :, :-1], chunk),
                       _encode_raw(vae, x[:, :, -1:], chunk)], dim=2)
    else:
        x = _encode_raw(vae, x, chunk)
    mu = causal_conv3d(vae.conv1, x)[:, :vae.cfg.z_dim].permute(0, 2, 3, 4, 1)
    if normalize:
        mean, std = _latent_stats(vae.cfg, mu)
        mu = (mu - mean) / std
    return mu


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
def parallel_spatial_tiled_decode(mesh, vae: WanVAEDecoder, z: torch.Tensor,
                                  tile_size: int = 256,
                                  normalized: bool = True) -> torch.Tensor:
    """:func:`spatial_tiled_decode` with the tile grid spread over every
    rank of ``mesh`` (``ltx/vae_tiling.parallel_spatial_map``; JAX
    :513-550): tail tiles made uniform by edge-replicate padding, the
    tiles brought back by one ``all_gather``, the blend the sequential
    one's. Without a mesh, on one rank, or when one tile covers the
    latent it is :func:`spatial_tiled_decode`."""
    sf = 2 ** (len(vae.cfg.dim_mult) - 1)
    lat_tile = tile_size // sf
    h_lat, w_lat = z.shape[2], z.shape[3]
    if (mesh is None or mesh.size() == 1
            or (h_lat <= lat_tile and w_lat <= lat_tile)):
        return spatial_tiled_decode(vae, z, tile_size, normalized)
    return spread_tiled_decode(mesh, vae, z, tile_size, normalized)


@torch.no_grad()
def spread_tiled_decode(mesh, vae: WanVAEDecoder, z: torch.Tensor,
                        tile_size: int = 256,
                        normalized: bool = True) -> torch.Tensor:
    """The tiled decode of :func:`parallel_spatial_tiled_decode` on any
    mesh, one rank's included (that rank then decodes every padded tile):
    what the parallel decode computes, without its fallback."""
    from ..ltx.vae_tiling import parallel_spatial_map

    cfg = vae.cfg
    sf = 2 ** (len(cfg.dim_mult) - 1)
    lat_tile = tile_size // sf
    h_lat, w_lat = z.shape[2], z.shape[3]
    z = z.to(vae.compute_dtype)
    if normalized:
        mean, std = _latent_stats(cfg, z)
        z = z * std + mean
    full = parallel_spatial_map(
        mesh, lambda i, tile: decode(vae, tile, False, False), z, lat_tile,
        tile_size, 0.25)
    return torch.clamp(full[:, :, :h_lat * sf, :w_lat * sf], -1.0, 1.0)


def spatial_tiled_encode(vae: WanVAE, video: torch.Tensor,
                         tile_size: int = 256, normalize: bool = True,
                         any_end_frame: bool = False) -> torch.Tensor:
    """Tiled :func:`encode` with a 25% overlap crossfade of the latent
    tiles (a different function from :func:`encode`: each tile sees only
    its own pixels)."""
    cfg = vae.cfg
    sf = 2 ** (len(cfg.dim_mult) - 1)
    lat_tile = tile_size // sf
    overlap = int(tile_size * 0.75)
    blend_extent = int(lat_tile * 0.25)
    row_limit = lat_tile - blend_extent
    h, w = video.shape[2], video.shape[3]
    if h <= tile_size and w <= tile_size:
        return encode(vae, video, normalize, any_end_frame)
    rows = []
    for i in range(0, h, overlap):
        rows.append([encode(vae, video[:, :, i:i + tile_size,
                                       j:j + tile_size], False, any_end_frame)
                     for j in range(0, w, overlap)])
    result_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = blend(rows[i - 1][j], tile, blend_extent, axis=2)
            if j > 0:
                tile = blend(row[j - 1], tile, blend_extent, axis=3)
            row[j] = tile
            out_row.append(tile[:, :, :row_limit, :row_limit])
        result_rows.append(torch.cat(out_row, dim=3))
    mu = torch.cat(result_rows, dim=2)
    if normalize:
        mean, std = _latent_stats(cfg, mu)
        mu = (mu - mean) / std
    return mu


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
