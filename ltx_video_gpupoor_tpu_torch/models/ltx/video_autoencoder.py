"""Legacy (non-causal) video VAE of the pre-0.9.6 LTX checkpoints.

Port of ``ltx_video_gpupoor_tpu/models/ltx/video_autoencoder.py``:
``LegacyVAEConfig`` with ``from_dict`` and its validation (:115-192),
``conv_nd`` for dims 3 (a full 3-D conv), (2, 1) (DualConv3d: a spatial
``1 x k x k`` conv then a temporal ``k x 1 x 1`` one) and 2 (a 2-D conv a
frame) (:46-77), the resnet, asymmetric-padded stride-2 downsample and
nearest-neighbour upsample blocks (:312-353), ``pixel_patchify`` /
``pixel_unpatchify`` with the channel padding the reference prepends
(:356-382), ``encode`` (:385) and ``decode(target_frames=)`` (:413). The
legacy decoder takes no timestep and injects no noise.

:func:`encode` and :func:`decode` keep the JAX layouts, ``[B, F, H, W,
C]`` in and out; inside, tensors are channels-first ``[B, C, F, H, W]``
and kernels torch's ``[C_out, C_in, kt, kh, kw]`` (``[C_out, C_in, kh,
kw]`` for dims 2; DualConv3d's ``weight1`` / ``weight2``, its own names).
Attribute names are the JAX keys, so ``core/from_jax.py::
legacy_vae_state_dict`` carries JAX's weights over and ``core/
checkpoint.py::convert_legacy_vae`` a published file's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from ...core.dtypes import DEFAULT_POLICY, DtypePolicy
from ...ops.norms import group_norm, pixel_norm
from ...ops.quant import Linear
from .vae import LatentStats

Dims = Union[int, tuple]


@dataclasses.dataclass(frozen=True)
class LegacyVAEConfig:
    dims: Any = 3
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 128
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    patch_size: int = 1
    patch_size_t: Optional[int] = None
    norm_layer: str = "group_norm"
    latent_log_var: str = "per_channel"
    use_quant_conv: bool = True
    add_channel_padding: bool = False

    @staticmethod
    def from_dict(cfg: dict) -> "LegacyVAEConfig":
        dims = cfg["dims"]
        if isinstance(dims, list):
            dims = tuple(dims)
        double_z = cfg.get("double_z", True)
        llv = cfg.get("latent_log_var", "per_channel" if double_z else "none")
        if cfg.get("use_quant_conv", True) and llv == "uniform":
            # the reference's validation (``video_autoencoder.py:76-77``)
            raise ValueError(
                "uniform latent_log_var requires use_quant_conv=False")
        return LegacyVAEConfig(
            dims=dims,
            in_channels=cfg.get("in_channels", 3),
            out_channels=cfg.get("out_channels", 3),
            latent_channels=cfg["latent_channels"],
            block_out_channels=tuple(cfg["block_out_channels"]),
            layers_per_block=cfg.get("layers_per_block", 2),
            norm_num_groups=cfg.get("norm_num_groups", 32),
            patch_size=cfg.get("patch_size", 1),
            patch_size_t=cfg.get("patch_size_t"),
            norm_layer=cfg.get("norm_layer", "group_norm"),
            latent_log_var=llv,
            use_quant_conv=cfg.get("use_quant_conv", True),
            add_channel_padding=cfg.get("add_channel_padding", False),
        )

    @property
    def pst(self) -> int:
        return self.patch_size_t if self.patch_size_t else self.patch_size

    def encoder_in_channels(self) -> int:
        if self.add_channel_padding:
            return self.in_channels * self.patch_size ** 3
        return self.in_channels * self.pst * self.patch_size ** 2

    def decoder_out_channels(self) -> int:
        if self.add_channel_padding:
            return self.out_channels * self.patch_size ** 3
        return self.out_channels * self.pst * self.patch_size ** 2

    @property
    def _num_downsamples(self) -> int:
        n = len(self.block_out_channels)
        return sum(1 for i in range(n)
                   if i != n - 1 and 2 ** i >= self.patch_size)

    @property
    def spatial_downscale_factor(self) -> int:
        return 2 ** self._num_downsamples * self.patch_size

    @property
    def temporal_downscale_factor(self) -> int:
        # dims 3 / (2, 1) downsamples stride time as well (when in time);
        # pure 2-D configs never stride the time axis
        if self.dims == 2:
            return self.pst
        return 2 ** self._num_downsamples * self.pst

    # the legacy decoder has no timestep conditioning / injected noise
    timestep_conditioning = False


# ---------------------------------------------------------------------------
# Modules (attribute names are the JAX parameter keys)
# ---------------------------------------------------------------------------

def _param(*shape, **kw):
    return nn.Parameter(torch.empty(*shape, **kw), requires_grad=False)


def _zeros(n, **kw):
    return nn.Parameter(torch.zeros(n, **kw), requires_grad=False)


class ConvND(nn.Module):
    """The reference's ``make_conv_nd``: ``weight [cout, cin, k, k, k]``
    (dims 3), ``[cout, cin, k, k]`` (dims 2) or DualConv3d's ``weight1
    [cout, cin, 1, k, k]`` + ``weight2 [cout, cout, k, 1, 1]`` (dims
    (2, 1)), each with its bias."""

    def __init__(self, dims: Dims, cin: int, cout: int, k: int = 3, **kw):
        super().__init__()
        self.dims = dims
        if dims == (2, 1):
            self.weight1 = _param(cout, cin, 1, k, k, **kw)
            self.bias1 = _zeros(cout, **kw)
            self.weight2 = _param(cout, cout, k, 1, 1, **kw)
            self.bias2 = _zeros(cout, **kw)
        elif dims in (2, 3):
            self.weight = _param(cout, cin, *(k,) * dims, **kw)
            self.bias = _zeros(cout, **kw)
        else:
            raise ValueError(f"dims must be 2, 3 or (2, 1); got {dims}")


class _Norm(nn.Module):
    def __init__(self, c, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device),
                                   requires_grad=False)
        self.bias = _zeros(c, device=device)


class ResBlock(nn.Module):
    def __init__(self, cfg: LegacyVAEConfig, cin, cout, **kw):
        super().__init__()
        self.conv1 = ConvND(cfg.dims, cin, cout, **kw)
        self.conv2 = ConvND(cfg.dims, cout, cout, **kw)
        if cfg.norm_layer == "group_norm":
            self.norm1 = _Norm(cin, kw.get("device"))
            self.norm2 = _Norm(cout, kw.get("device"))
        if cin != cout:
            self.conv_shortcut = Linear(cin, cout, **kw)


class _ResList(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.res_blocks = nn.ModuleList(blocks)


class LegacyVAE(nn.Module):
    """Encoder, decoder, the 1x1 quant convs (``use_quant_conv``) and the
    latent statistics (identity unless the checkpoint carries them)."""

    def __init__(self, cfg: LegacyVAEConfig,
                 policy: DtypePolicy = DEFAULT_POLICY, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = policy.compute_dtype
        kw = dict(device=device, dtype=policy.param_dtype)
        dims, boc, n = cfg.dims, cfg.block_out_channels, cfg.layers_per_block
        group = cfg.norm_layer == "group_norm"

        enc = nn.Module()
        enc.conv_in = ConvND(dims, cfg.encoder_in_channels(), boc[0], **kw)
        enc.down_blocks = nn.ModuleList()
        cur = boc[0]
        for i, ch in enumerate(boc):
            stage = _ResList([ResBlock(cfg, cur if j == 0 else ch, ch, **kw)
                              for j in range(n)])
            if i != len(boc) - 1 and 2 ** i >= cfg.patch_size:
                stage.downsample = ConvND(dims, ch, ch, **kw)
            enc.down_blocks.append(stage)
            cur = ch
        enc.mid_block = _ResList([ResBlock(cfg, boc[-1], boc[-1], **kw)
                                  for _ in range(n)])
        if group:
            enc.conv_norm_out = _Norm(boc[-1], device)
        out_ch = cfg.latent_channels
        if cfg.latent_log_var == "per_channel":
            out_ch *= 2
        elif cfg.latent_log_var == "uniform":
            out_ch += 1
        enc.conv_out = ConvND(dims, boc[-1], out_ch, **kw)
        self.encoder = enc

        rev = tuple(reversed(boc))
        dec = nn.Module()
        dec.conv_in = ConvND(dims, cfg.latent_channels, rev[0], **kw)
        dec.mid_block = _ResList([ResBlock(cfg, rev[0], rev[0], **kw)
                                  for _ in range(n)])
        dec.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, ch in enumerate(rev):
            stage = _ResList([ResBlock(cfg, prev if j == 0 else ch, ch, **kw)
                              for j in range(n + 1)])
            if i != len(boc) - 1 and 2 ** (len(boc) - i - 1) > cfg.patch_size:
                stage.upsample = ConvND(dims, ch, ch, **kw)
            dec.up_blocks.append(stage)
            prev = ch
        if group:
            dec.conv_norm_out = _Norm(boc[0], device)
        dec.conv_out = ConvND(dims, boc[0], cfg.decoder_out_channels(), **kw)
        self.decoder = dec

        if cfg.use_quant_conv:
            c2 = 2 * cfg.latent_channels
            self.quant_conv = Linear(c2, c2, **kw)
            self.post_quant_conv = Linear(cfg.latent_channels,
                                          cfg.latent_channels, **kw)
        self.per_channel_statistics = LatentStats(cfg.latent_channels,
                                                  device=device)


@torch.no_grad()
def init_params(vae: LegacyVAE, generator: torch.Generator) -> LegacyVAE:
    """Random weights in the JAX ``init_params`` distribution: each conv
    N(0, 1 / its fan-in), the 1x1 convs N(0, 1 / c_in), zero biases, unit
    norms. Draws on the model's device from ``generator``."""
    def randn_(w, fan_in):
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                            dtype=w.dtype) * fan_in ** -0.5)

    for mod in vae.modules():
        if isinstance(mod, ConvND):
            for name in ("weight", "weight1", "weight2"):
                if hasattr(mod, name):
                    w = getattr(mod, name)
                    randn_(w, math.prod(w.shape[1:]))
        elif isinstance(mod, Linear):
            randn_(mod.weight, mod.d_in)
    return vae


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _conv(x, w, bias, stride, pad):
    conv = F.conv2d if w.dim() == 4 else F.conv3d
    y = conv(x, w.to(x.dtype), stride=stride, padding=pad)
    shape = (1, -1) + (1,) * (y.dim() - 2)
    return y + bias.to(y.dtype).reshape(shape)


def conv_nd(p: ConvND, x: torch.Tensor, stride: int = 1,
            same_pad: bool = True, skip_time_conv: bool = False
            ) -> torch.Tensor:
    """A conv in the reference's dims convention on ``[B, C, F, H, W]``:
    "same" zero padding (or none) and ``stride`` on every axis it
    convolves."""
    if p.dims == 3:
        k = p.weight.shape[-1] // 2 if same_pad else 0
        return _conv(x, p.weight, p.bias, stride, k)
    if p.dims == (2, 1):
        k = p.weight1.shape[-1] // 2 if same_pad else 0
        y = _conv(x, p.weight1, p.bias1, (1, stride, stride), (0, k, k))
        if skip_time_conv:
            return y
        k = p.weight2.shape[2] // 2 if same_pad else 0
        return _conv(y, p.weight2, p.bias2, (stride, 1, 1), (k, 0, 0))
    b, c, f = x.shape[:3]
    flat = x.transpose(1, 2).reshape(b * f, c, *x.shape[3:])
    k = p.weight.shape[-1] // 2 if same_pad else 0
    y = _conv(flat, p.weight, p.bias, stride, k)
    return y.reshape(b, f, *y.shape[1:]).transpose(1, 2)


def _linear(p: Linear, x):
    """A 1x1(x1) conv as a dense channel product on ``[B, C, ...]``."""
    return p(x.movedim(1, -1)).movedim(-1, 1)


def _norm(cfg: LegacyVAEConfig, p, x):
    if p is not None and cfg.norm_layer == "group_norm":
        return group_norm(x, cfg.norm_num_groups, p.weight, p.bias,
                          eps=1e-6, channel_axis=1)
    return pixel_norm(x, axis=1)


def _resnet(cfg, p: ResBlock, x):
    h = F.silu(_norm(cfg, getattr(p, "norm1", None), x))
    h = conv_nd(p.conv1, h)
    h = F.silu(_norm(cfg, getattr(p, "norm2", None), h))
    h = conv_nd(p.conv2, h)
    sc = _linear(p.conv_shortcut, x) if hasattr(p, "conv_shortcut") else x
    return sc + h


def _downsample(p: ConvND, x, in_time: bool):
    """Right / bottom / late zero pad, then a stride-2 conv without
    padding (``video_autoencoder.py:796-810`` with padding=0)."""
    x = F.pad(x, (0, 1, 0, 1, 0, 1 if in_time and p.dims != 2 else 0))
    return conv_nd(p, x, stride=2, same_pad=False,
                   skip_time_conv=p.dims == (2, 1) and not in_time)


def _upsample(p: ConvND, x, in_time: bool):
    x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
    if p.dims != 2 and in_time:
        x = x.repeat_interleave(2, dim=2)
    return conv_nd(p, x, skip_time_conv=p.dims == (2, 1) and not in_time)


def pixel_patchify(x: torch.Tensor, q: int, p_t: int = 1,
                   add_channel_padding: bool = False) -> torch.Tensor:
    """``[B, F, H, W, C]`` -> patches in channels, zero channels PREPENDED
    where the reference pads (``video_autoencoder.py:892-901``)."""
    if q == 1 and p_t == 1:
        return x
    y = rearrange(x, "b (f p) (h q) (w r) c -> b f h w (c p r q)",
                  p=p_t, q=q, r=q)
    if q > p_t and (p_t > 1 or add_channel_padding):
        target = y.shape[-1] * (q // p_t)
        zeros = y.new_zeros(y.shape[:-1] + (target - y.shape[-1],))
        y = torch.cat([zeros, y], dim=-1)
    return y


def pixel_unpatchify(x: torch.Tensor, q: int, p_t: int = 1,
                     out_channels: int = 3,
                     add_channel_padding: bool = False) -> torch.Tensor:
    if q == 1 and p_t == 1:
        return x
    x = x[..., :out_channels * p_t * q * q]
    return rearrange(x, "b f h w (c p r q) -> b (f p) (h q) (w r) c",
                     p=p_t, q=q, r=q)


@torch.no_grad()
def encode(vae: LegacyVAE, media: torch.Tensor) -> torch.Tensor:
    """Pixels ``[B, F, H, W, C]`` -> the posterior's parameters ``[B, F',
    H', W', 2 * latent]`` in the compute dtype."""
    cfg = vae.cfg
    media = media.to(vae.compute_dtype)
    in_time = media.shape[1] != 1
    pst = cfg.pst if in_time else 1
    x = pixel_patchify(media, cfg.patch_size, pst, cfg.add_channel_padding)
    x = x.permute(0, 4, 1, 2, 3)
    enc = vae.encoder
    x = conv_nd(enc.conv_in, x)
    for stage in enc.down_blocks:
        for rp in stage.res_blocks:
            x = _resnet(cfg, rp, x)
        if hasattr(stage, "downsample"):
            x = _downsample(stage.downsample, x, in_time)
    for rp in enc.mid_block.res_blocks:
        x = _resnet(cfg, rp, x)
    x = F.silu(_norm(cfg, getattr(enc, "conv_norm_out", None), x))
    x = conv_nd(enc.conv_out, x).permute(0, 2, 3, 4, 1)
    if cfg.latent_log_var == "uniform":
        last = x[..., -1:]
        x = torch.cat([x, last.expand(*last.shape[:-1], x.shape[-1] - 2)],
                      dim=-1)
    if cfg.use_quant_conv:
        x = vae.quant_conv(x)
    return x


@torch.no_grad()
def decode(vae: LegacyVAE, z: torch.Tensor,
           target_frames: Optional[int] = None) -> torch.Tensor:
    """Latents ``[B, F', H', W', latent]`` -> pixels ``[B, F, H, W, C]`` in
    the compute dtype; time is upsampled unless ``target_frames`` is given
    and the latents already have that many frames."""
    cfg = vae.cfg
    in_time = True if target_frames is None else z.shape[1] < target_frames
    z = z.to(vae.compute_dtype)
    if cfg.use_quant_conv:
        z = vae.post_quant_conv(z)
    dec = vae.decoder
    x = conv_nd(dec.conv_in, z.permute(0, 4, 1, 2, 3))
    for rp in dec.mid_block.res_blocks:
        x = _resnet(cfg, rp, x)
    for stage in dec.up_blocks:
        for rp in stage.res_blocks:
            x = _resnet(cfg, rp, x)
        if hasattr(stage, "upsample"):
            x = _upsample(stage.upsample, x, in_time)
    x = F.silu(_norm(cfg, getattr(dec, "conv_norm_out", None), x))
    x = conv_nd(dec.conv_out, x).permute(0, 2, 3, 4, 1)
    pst = cfg.pst if in_time else 1
    return pixel_unpatchify(x, cfg.patch_size, pst, cfg.out_channels,
                            cfg.add_channel_padding)
