"""LTX causal 3-D video VAE.

Port of ``ltx_video_gpupoor_tpu/models/ltx/vae.py``: ``VAEConfig``,
``LTX_VAE_CONFIG_097`` (:129-153, a pinned copy), ``causal_conv3d``
(:160) as a plain ``conv3d`` (the JAX package's ``framewise_conv_sum`` is
a TPU reformulation), ``_resnet_forward`` (:477), ``_vae_attention``
(:517) and the ``attn_res_x`` mid blocks, ``_space_to_depth_down``
(:558), ``_depth_to_space_up`` (:594), ``_pixel_shuffle_3d``, the pixel
patchifiers, timestep conditioning, ``encode`` (:634), ``decode`` (:675),
``sample_posterior`` (:742), ``normalize_latents`` (:753) and
``un_normalize_latents`` (:761). Encoder blocks: ``res_x``, ``res_x_y``,
the strided ``compress_*`` convolutions and the space-to-depth
``compress_*_res``; decoder blocks: ``res_x``, ``attn_res_x``,
``res_x_y`` and the ``compress_*`` upsamplers.

:class:`CausalVAEDecoder` is the decoder half with the latent statistics
(all that text-to-video needs); :class:`CausalVAE` adds the encoder.
:func:`encode` and :func:`decode` keep the JAX layouts, ``[B, F, H, W,
C]`` in and out; inside, tensors are channels-first ``[B, C, F, H, W]``,
the layout of PyTorch's ``conv3d``, and kernels ``[C_out, C_in, kt, kh,
kw]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from ...core.dtypes import DEFAULT_POLICY, DtypePolicy
from ...ops.attention import attention as mha
from ...ops.norms import group_norm, layer_norm, pixel_norm, rms_norm
from ...ops.quant import Linear
from .transformer3d import timestep_embedding


def _norm_blocks(blocks) -> list[tuple[str, dict]]:
    out = []
    for name, params in blocks:
        if isinstance(params, int):
            params = {"num_layers": params}
        out.append((str(name), dict(params)))
    return out


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 128
    encoder_blocks: tuple = ()
    decoder_blocks: tuple = ()
    base_channels: int = 128
    encoder_base_channels: Optional[int] = None
    decoder_base_channels: Optional[int] = None
    norm_num_groups: int = 32
    patch_size: int = 4
    norm_layer: str = "pixel_norm"
    latent_log_var: str = "uniform"
    use_quant_conv: bool = False
    causal_decoder: bool = False
    timestep_conditioning: bool = False
    spatial_padding_mode: str = "zeros"

    @staticmethod
    def from_dict(cfg: dict) -> "VAEConfig":
        blocks = cfg.get("blocks")
        enc = _norm_blocks(cfg.get("encoder_blocks", blocks))
        dec = _norm_blocks(cfg.get("decoder_blocks", blocks))
        double_z = cfg.get("double_z", True)
        return VAEConfig(
            in_channels=cfg.get("in_channels", 3),
            out_channels=cfg.get("out_channels", 3),
            latent_channels=cfg["latent_channels"],
            encoder_blocks=tuple((n, tuple(sorted(p.items()))) for n, p in enc),
            decoder_blocks=tuple((n, tuple(sorted(p.items()))) for n, p in dec),
            base_channels=cfg.get("base_channels", 128),
            encoder_base_channels=cfg.get("encoder_base_channels"),
            decoder_base_channels=cfg.get("decoder_base_channels"),
            norm_num_groups=cfg.get("norm_num_groups", 32),
            patch_size=cfg.get("patch_size", 1),
            norm_layer=cfg.get("norm_layer", "group_norm"),
            latent_log_var=cfg.get(
                "latent_log_var", "per_channel" if double_z else "none"),
            use_quant_conv=cfg.get("use_quant_conv", True),
            causal_decoder=cfg.get("causal_decoder", False),
            timestep_conditioning=cfg.get("timestep_conditioning", False),
            spatial_padding_mode=cfg.get("spatial_padding_mode", "zeros"),
        )

    def enc_blocks(self) -> list[tuple[str, dict]]:
        return [(n, dict(p)) for n, p in self.encoder_blocks]

    def dec_blocks(self) -> list[tuple[str, dict]]:
        return [(n, dict(p)) for n, p in self.decoder_blocks]

    @property
    def spatial_downscale_factor(self) -> int:
        n = sum(1 for b, _ in self.encoder_blocks
                if b in ("compress_space", "compress_all", "compress_all_res",
                         "compress_space_res", "compress_all_x_y"))
        return 2 ** n * self.patch_size

    @property
    def temporal_downscale_factor(self) -> int:
        n = sum(1 for b, _ in self.encoder_blocks
                if b in ("compress_time", "compress_all", "compress_all_res",
                         "compress_time_res", "compress_all_x_y"))
        return 2 ** n


# LTXV 0.9.x production config (diffusers_config_mapping.py:106-131)
LTX_VAE_CONFIG_097 = {
    "_class_name": "CausalVideoAutoencoder",
    "dims": 3,
    "in_channels": 3,
    "out_channels": 3,
    "latent_channels": 128,
    "blocks": [
        ["res_x", 4],
        ["compress_all", 1],
        ["res_x_y", 1],
        ["res_x", 3],
        ["compress_all", 1],
        ["res_x_y", 1],
        ["res_x", 3],
        ["compress_all", 1],
        ["res_x", 3],
        ["res_x", 4],
    ],
    "scaling_factor": 1.0,
    "norm_layer": "pixel_norm",
    "patch_size": 4,
    "latent_log_var": "uniform",
    "use_quant_conv": False,
    "causal_decoder": False,
}

_UP_STRIDES = {"compress_time": (2, 1, 1), "compress_space": (1, 2, 2),
               "compress_all": (2, 2, 2)}
_DOWN_STRIDES = {**_UP_STRIDES, "compress_all_x_y": (2, 2, 2)}
_DOWN_RES_STRIDES = {"compress_all_res": (2, 2, 2),
                     "compress_space_res": (1, 2, 2),
                     "compress_time_res": (2, 1, 1)}


def _encoder_plan(cfg: VAEConfig):
    """[(block, params, c_in, c_out)] of the encoder."""
    plan = []
    ch = cfg.encoder_base_channels or cfg.base_channels
    for name, bp in cfg.enc_blocks():
        cin = ch
        if name in ("res_x_y", "compress_all_x_y", *_DOWN_RES_STRIDES):
            ch = bp.get("multiplier", 2) * ch
        plan.append((name, bp, cin, ch))
    return plan


def _decoder_plan(cfg: VAEConfig):
    """(conv_in width, [(block, params, c_in, c_out)]) of the decoder."""
    blocks = list(reversed(cfg.dec_blocks()))
    ch = cfg.decoder_base_channels or cfg.base_channels
    for name, bp in blocks:
        if name == "res_x_y":
            ch = ch * bp.get("multiplier", 2)
        if name == "compress_all":
            ch = ch * bp.get("multiplier", 1)
    plan, plan_ch = [], ch
    for name, bp in blocks:
        cin = plan_ch
        if name == "res_x_y":
            plan_ch = plan_ch // bp.get("multiplier", 2)
        elif name == "compress_all":
            plan_ch = plan_ch // bp.get("multiplier", 1)
        plan.append((name, bp, cin, plan_ch))
    return ch, plan


# ---------------------------------------------------------------------------
# Modules (attribute names are the JAX parameter keys)
# ---------------------------------------------------------------------------

class Conv3d(nn.Module):
    def __init__(self, cin, cout, k=3, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, k,
                                               device=device, dtype=dtype),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout, device=device, dtype=dtype),
                                 requires_grad=False)


class NormParams(nn.Module):
    """Affine norm parameters; empty for ``pixel_norm``."""

    def __init__(self, norm_layer: str, channels: int, *, device=None,
                 dtype=torch.float32, force: bool = False):
        super().__init__()
        if force or norm_layer in ("group_norm", "layer_norm"):
            self.weight = nn.Parameter(torch.ones(channels, device=device,
                                                  dtype=dtype),
                                       requires_grad=False)
            self.bias = nn.Parameter(torch.zeros(channels, device=device,
                                                 dtype=dtype),
                                     requires_grad=False)


class TimeEmbedder(nn.Module):
    def __init__(self, cout: int, **kw):
        super().__init__()
        self.linear_1 = Linear(256, cout, **kw)
        self.linear_2 = Linear(cout, cout, **kw)


class ResBlock(nn.Module):
    def __init__(self, cfg: VAEConfig, cin, cout, inject_noise, timestep_cond,
                 **kw):
        super().__init__()
        self.cfg = cfg
        self.norm1 = NormParams(cfg.norm_layer, cin, **kw)
        self.conv1 = Conv3d(cin, cout, **kw)
        self.norm2 = NormParams(cfg.norm_layer, cout, **kw)
        self.conv2 = Conv3d(cout, cout, **kw)
        if cin != cout:
            self.conv_shortcut = Conv3d(cin, cout, 1, **kw)
            self.norm3 = NormParams(cfg.norm_layer, cin, force=True, **kw)
        if inject_noise:
            self.per_channel_scale1 = nn.Parameter(
                torch.zeros(cout, device=kw.get("device"),
                            dtype=kw.get("dtype")), requires_grad=False)
            self.per_channel_scale2 = nn.Parameter(
                torch.zeros(cout, device=kw.get("device"),
                            dtype=kw.get("dtype")), requires_grad=False)
        if timestep_cond:
            self.scale_shift_table = nn.Parameter(
                torch.empty(4, cin, device=kw.get("device"),
                            dtype=kw.get("dtype")), requires_grad=False)

    def _noise(self, h, scale, generator):
        if scale is None or generator is None:
            return h
        noise = torch.randn(h.shape[-2:], generator=generator,
                            device=h.device, dtype=h.dtype)
        return h + noise[None, None, None] * scale.to(h.dtype)[:, None, None, None]

    def forward(self, x, causal, temb, generator):
        cfg = self.cfg
        h = _norm(cfg, self.norm1, x)
        sst = getattr(self, "scale_shift_table", None)
        modulate = sst is not None and temb is not None
        if modulate:
            b, c = x.shape[0], sst.shape[1]
            ada = sst.float()[None] + temb.reshape(b, 4, c)
            shift1, scale1, shift2, scale2 = [
                ada[:, i][:, :, None, None, None].to(x.dtype) for i in range(4)]
            h = h * (1 + scale1) + shift1
        h = causal_conv3d(self.conv1, F.silu(h), causal=causal,
                          spatial_mode=cfg.spatial_padding_mode)
        h = self._noise(h, getattr(self, "per_channel_scale1", None), generator)
        h = _norm(cfg, self.norm2, h)
        if modulate:
            h = h * (1 + scale2) + shift2
        h = causal_conv3d(self.conv2, F.silu(h), causal=causal,
                          spatial_mode=cfg.spatial_padding_mode)
        h = self._noise(h, getattr(self, "per_channel_scale2", None), generator)
        sc = x
        if hasattr(self, "norm3"):
            sc = _channel_layer_norm(sc, self.norm3.weight, self.norm3.bias)
        if hasattr(self, "conv_shortcut"):
            sc = causal_conv3d(self.conv_shortcut, sc)
        return sc + h


class HeadNormWeight(nn.Module):
    def __init__(self, dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype),
                                   requires_grad=False)


class VAEAttention(nn.Module):
    """Self-attention over all voxels with a residual connection and a
    per-head rms qk-norm (the norm weight's width is the head dim)."""

    def __init__(self, cin: int, head_dim: int, **kw):
        super().__init__()
        self.to_q = Linear(cin, cin, **kw)
        self.to_k = Linear(cin, cin, **kw)
        self.to_v = Linear(cin, cin, **kw)
        self.to_out = Linear(cin, cin, **kw)
        self.q_norm = HeadNormWeight(head_dim, **kw)
        self.k_norm = HeadNormWeight(head_dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)                # [B, N, C]
        d = self.q_norm.weight.shape[0]
        heads = c // d

        def split(t):
            return t.reshape(b, -1, heads, d).transpose(1, 2)

        qh = rms_norm(split(self.to_q(tokens)), self.q_norm.weight, eps=1e-5)
        kh = rms_norm(split(self.to_k(tokens)), self.k_norm.weight, eps=1e-5)
        out = mha(qh, kh, split(self.to_v(tokens)))
        out = self.to_out(out.transpose(1, 2).reshape(b, -1, c))
        return (tokens + out).transpose(1, 2).reshape(b, c, f, h, w)


class MidBlock(nn.Module):
    def __init__(self, cfg, cin, num_layers, inject_noise, timestep_cond,
                 attention_head_dim: int = -1, **kw):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            ResBlock(cfg, cin, cin, inject_noise, timestep_cond, **kw)
            for _ in range(num_layers))
        if timestep_cond:
            self.time_embedder = TimeEmbedder(cin * 4, **kw)
        if attention_head_dim > 0:
            hd = attention_head_dim if attention_head_dim < cin else cin
            self.attention_blocks = nn.ModuleList(
                VAEAttention(cin, hd, **kw) for _ in range(num_layers))

    def forward(self, x, causal, timestep, generator):
        temb = None
        if hasattr(self, "time_embedder") and timestep is not None:
            temb = _pixart_time_embed(self.time_embedder, timestep, x.shape[0])
        attn = getattr(self, "attention_blocks", None)
        for i, rb in enumerate(self.res_blocks):
            x = rb(x, causal, temb, generator)
            if attn is not None:
                x = attn[i](x)
        return x


class Upsample(nn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.conv = Conv3d(cin, cout, **kw)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, **kw):
        super().__init__()
        dec_base, plan = _decoder_plan(cfg)
        self.conv_in = Conv3d(cfg.latent_channels, dec_base, **kw)
        blocks = []
        for name, bp, cin, cout in plan:
            if name == "res_x":
                blocks.append(MidBlock(cfg, cin, bp["num_layers"],
                                       bp.get("inject_noise", False),
                                       cfg.timestep_conditioning, **kw))
            elif name == "res_x_y":
                blocks.append(ResBlock(cfg, cin, cout,
                                       bp.get("inject_noise", False), False,
                                       **kw))
            elif name in _UP_STRIDES:
                stride = _UP_STRIDES[name]
                reduction = (bp.get("multiplier", 1)
                             if name == "compress_all" else 1)
                blocks.append(Upsample(
                    cin, int(np.prod(stride)) * cin // reduction, **kw))
            elif name == "attn_res_x":
                blocks.append(MidBlock(
                    cfg, cin, bp["num_layers"], bp.get("inject_noise", False),
                    cfg.timestep_conditioning,
                    attention_head_dim=bp["attention_head_dim"], **kw))
            else:
                raise ValueError(f"unknown decoder block {name}")
        self.up_blocks = nn.ModuleList(blocks)
        final_ch = plan[-1][3] if plan else dec_base
        self.conv_norm_out = NormParams(cfg.norm_layer, final_ch, **kw)
        self.conv_out = Conv3d(final_ch, cfg.out_channels * cfg.patch_size ** 2,
                               **kw)
        if cfg.timestep_conditioning:
            self.register_buffer("timestep_scale_multiplier",
                                 torch.tensor(1000.0, device=kw.get("device")))
            self.last_time_embedder = TimeEmbedder(final_ch * 2, **kw)
            self.last_scale_shift_table = nn.Parameter(
                torch.empty(2, final_ch, device=kw.get("device"),
                            dtype=kw.get("dtype")), requires_grad=False)


class Downsample(nn.Module):
    """The conv of a space-to-depth ``compress_*_res`` block."""

    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.conv = Conv3d(cin, cout, **kw)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, **kw):
        super().__init__()
        plan = _encoder_plan(cfg)
        base = cfg.encoder_base_channels or cfg.base_channels
        self.conv_in = Conv3d(cfg.in_channels * cfg.patch_size ** 2, base,
                              **kw)
        blocks = []
        for name, bp, cin, cout in plan:
            if name == "res_x":
                blocks.append(MidBlock(cfg, cin, bp["num_layers"], False,
                                       False, **kw))
            elif name == "res_x_y":
                blocks.append(ResBlock(cfg, cin, cout, False, False, **kw))
            elif name in _DOWN_STRIDES:
                blocks.append(Conv3d(cin, cout, **kw))
            elif name in _DOWN_RES_STRIDES:
                stride = _DOWN_RES_STRIDES[name]
                blocks.append(Downsample(cin, cout // int(np.prod(stride)),
                                         **kw))
            else:
                raise ValueError(f"unknown encoder block {name}")
        self.down_blocks = nn.ModuleList(blocks)
        last_ch = plan[-1][3] if plan else base
        self.conv_norm_out = NormParams(cfg.norm_layer, last_ch, **kw)
        out_ch = cfg.latent_channels
        if cfg.latent_log_var == "per_channel":
            out_ch *= 2
        elif cfg.latent_log_var in ("uniform", "constant"):
            out_ch += 1
        self.conv_out = Conv3d(last_ch, out_ch, **kw)


class LatentStats(nn.Module):
    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.register_buffer("std_of_means", torch.ones(channels, device=device))
        self.register_buffer("mean_of_means", torch.zeros(channels, device=device))


class CausalVAEDecoder(nn.Module):
    """The VAE's decoder half plus its latent statistics."""

    def __init__(self, cfg: VAEConfig, policy: DtypePolicy = DEFAULT_POLICY,
                 *, device=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = policy.compute_dtype
        kw = dict(device=device, dtype=policy.param_dtype)
        self.decoder = Decoder(cfg, **kw)
        if cfg.use_quant_conv:
            self.post_quant_conv = Conv3d(cfg.latent_channels,
                                          cfg.latent_channels, 1, **kw)
        self.per_channel_statistics = LatentStats(cfg.latent_channels,
                                                  device=device)


class CausalVAE(CausalVAEDecoder):
    """Encoder, decoder and latent statistics."""

    def __init__(self, cfg: VAEConfig, policy: DtypePolicy = DEFAULT_POLICY,
                 *, device=None):
        super().__init__(cfg, policy, device=device)
        kw = dict(device=device, dtype=policy.param_dtype)
        self.encoder = Encoder(cfg, **kw)
        if cfg.use_quant_conv:
            self.quant_conv = Conv3d(2 * cfg.latent_channels,
                                     2 * cfg.latent_channels, 1, **kw)


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------

def causal_conv3d(conv: Conv3d, x: torch.Tensor,
                  stride: tuple[int, int, int] = (1, 1, 1),
                  causal: bool = True,
                  spatial_mode: str = "zeros") -> torch.Tensor:
    """CausalConv3d on ``[B, C, F, H, W]``: first-frame replicate pad in
    time (both ends when not causal), same pad in space."""
    kt, kh, kw = conv.weight.shape[2:]
    if kt > 1:
        if causal:
            front = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1)
            x = torch.cat([front, x], dim=2)
        else:
            half = (kt - 1) // 2
            front = x[:, :, :1].expand(-1, -1, half, -1, -1)
            back = x[:, :, -1:].expand(-1, -1, half, -1, -1)
            x = torch.cat([front, x, back], dim=2)
    ph, pw = kh // 2, kw // 2
    if ph or pw:
        pads = (pw, pw, ph, ph, 0, 0)
        x = F.pad(x, pads, mode="replicate" if spatial_mode == "replicate"
                  else "constant")
    y = F.conv3d(x, conv.weight.to(x.dtype), stride=stride)
    return y + conv.bias.to(y.dtype)[:, None, None, None]


def _channel_layer_norm(x, weight, bias):
    return layer_norm(x.movedim(1, -1), weight, bias, eps=1e-6).movedim(-1, 1)


def _norm(cfg: VAEConfig, p: NormParams, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_layer == "group_norm":
        return group_norm(x, cfg.norm_num_groups, p.weight, p.bias, eps=1e-6,
                          channel_axis=1)
    if cfg.norm_layer == "pixel_norm":
        return pixel_norm(x, axis=1)
    if cfg.norm_layer == "layer_norm":
        return _channel_layer_norm(x, p.weight, p.bias)
    raise ValueError(cfg.norm_layer)


def _pixart_time_embed(p: TimeEmbedder, t: torch.Tensor, batch: int):
    """sinusoidal(256) -> linear -> silu -> linear, in fp32."""
    t = torch.as_tensor(t, dtype=torch.float32).reshape(-1)
    emb = timestep_embedding(t.expand(batch), 256)
    return p.linear_2(F.silu(p.linear_1(emb)))


def _pixel_shuffle_3d(x, stride):
    """``[B, C*prod(stride), F, H, W] -> [B, C, F*s0, H*s1, W*s2]``;
    channels split as (C, p1, p2, p3), as torch PixelShuffleND does."""
    p1, p2, p3 = stride
    return rearrange(x, "b (c p1 p2 p3) d h w -> b c (d p1) (h p2) (w p3)",
                     p1=p1, p2=p2, p3=p3)


def _depth_to_space_up(up: Upsample, x, stride, causal, residual, reduction,
                       spatial_mode):
    if residual:
        num_repeat = int(np.prod(stride)) // reduction
        x_in = _pixel_shuffle_3d(x, stride)
        x_in = torch.cat([x_in] * num_repeat, dim=1)
        if stride[0] == 2:
            x_in = x_in[:, :, 1:]
    y = causal_conv3d(up.conv, x, causal=causal, spatial_mode=spatial_mode)
    y = _pixel_shuffle_3d(y, stride)
    if stride[0] == 2:
        y = y[:, :, 1:]
    if residual:
        y = y + x_in
    return y


def _space_to_depth_down(down: Downsample, x, stride, spatial_mode):
    """``compress_*_res``: a causal conv and a space-to-depth, plus the
    group mean of the input's space-to-depth as the skip branch."""
    if stride[0] == 2:
        x = torch.cat([x[:, :, :1], x], dim=2)
    p1, p2, p3 = stride
    x_in = rearrange(x, "b c (d p1) (h p2) (w p3) -> b (c p1 p2 p3) d h w",
                     p1=p1, p2=p2, p3=p3)
    out_ch = down.conv.weight.shape[0] * int(np.prod(stride))
    group = x_in.shape[1] // out_ch
    x_in = rearrange(x_in, "b (c g) d h w -> b c g d h w", g=group).mean(dim=2)
    y = causal_conv3d(down.conv, x, causal=True, spatial_mode=spatial_mode)
    y = rearrange(y, "b c (d p1) (h p2) (w p3) -> b (c p1 p2 p3) d h w",
                  p1=p1, p2=p2, p3=p3)
    return y + x_in


def _patchify_pixels(x: torch.Tensor, p: int) -> torch.Tensor:
    if p == 1:
        return x
    return rearrange(x, "b c f (h q) (w r) -> b (c r q) f h w", q=p, r=p)


def _unpatchify_pixels(x: torch.Tensor, p: int) -> torch.Tensor:
    if p == 1:
        return x
    return rearrange(x, "b (c r q) f h w -> b c f (h q) (w r)", q=p, r=p)


def encode(vae: CausalVAE, media: torch.Tensor) -> torch.Tensor:
    """Encode pixels ``[B, F, H, W, C]`` in [-1, 1] to the latent mean and
    log-variance ``[B, F', H', W', 2*latent]`` in the policy's compute
    dtype. The encoder is always causal."""
    cfg = vae.cfg
    enc = vae.encoder
    mode = cfg.spatial_padding_mode
    x = media.to(vae.compute_dtype).permute(0, 4, 1, 2, 3)
    x = _patchify_pixels(x, cfg.patch_size)
    x = causal_conv3d(enc.conv_in, x, causal=True, spatial_mode=mode)
    for (name, _, _, _), blk in zip(_encoder_plan(cfg), enc.down_blocks):
        if name == "res_x":
            x = blk(x, True, None, None)
        elif name == "res_x_y":
            x = blk(x, True, None, None)
        elif name in _DOWN_STRIDES:
            x = causal_conv3d(blk, x, stride=_DOWN_STRIDES[name], causal=True,
                              spatial_mode=mode)
        else:
            x = _space_to_depth_down(blk, x, _DOWN_RES_STRIDES[name], mode)
    x = _norm(cfg, enc.conv_norm_out, x)
    x = causal_conv3d(enc.conv_out, F.silu(x), causal=True, spatial_mode=mode)
    if cfg.latent_log_var == "uniform":
        x = torch.cat([x, x[:, -1:].expand(-1, x.shape[1] - 2, -1, -1, -1)],
                      dim=1)
    elif cfg.latent_log_var == "constant":
        x = x[:, :-1]
        x = torch.cat([x, torch.full_like(x, -30.0)], dim=1)
    if cfg.use_quant_conv:
        x = causal_conv3d(vae.quant_conv, x)
    return x.permute(0, 2, 3, 4, 1)


def sample_posterior(encoded: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Split mean / log-variance; the mean (the mode) without a
    generator, else a sample."""
    mean, logvar = encoded.chunk(2, dim=-1)
    if generator is None:
        return mean
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    return mean + std * torch.randn(mean.shape, generator=generator,
                                    device=mean.device, dtype=mean.dtype)


def normalize_latents(latents: torch.Tensor,
                      stats: "LatentStats") -> torch.Tensor:
    """Pixel-latent to DiT space: ``(z - mean) / std`` per channel."""
    mean = stats.mean_of_means.to(latents.dtype)
    std = stats.std_of_means.to(latents.dtype)
    return (latents - mean) / std


def decode(
    vae: CausalVAEDecoder,
    latents: torch.Tensor,
    timestep: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Decode latents ``[B, F', H', W', latent]`` to pixels
    ``[B, F, H, W, C]`` in the policy's compute dtype."""
    cfg = vae.cfg
    if cfg.timestep_conditioning and timestep is None:
        raise ValueError(
            "cfg.timestep_conditioning=True requires a decode timestep")
    dec = vae.decoder
    causal = cfg.causal_decoder
    mode = cfg.spatial_padding_mode
    x = latents.to(vae.compute_dtype).permute(0, 4, 1, 2, 3)
    if cfg.use_quant_conv:
        x = causal_conv3d(vae.post_quant_conv, x)
    x = causal_conv3d(dec.conv_in, x, causal=causal, spatial_mode=mode)

    scaled_t = None
    if cfg.timestep_conditioning:
        scaled_t = (torch.as_tensor(timestep, dtype=torch.float32,
                                    device=x.device)
                    * dec.timestep_scale_multiplier)

    _, plan = _decoder_plan(cfg)
    for (name, bp, _, _), blk in zip(plan, dec.up_blocks):
        if name in ("res_x", "attn_res_x"):
            x = blk(x, causal, scaled_t, generator)
        elif name == "res_x_y":
            x = blk(x, causal, None, generator)
        else:
            x = _depth_to_space_up(blk, x, _UP_STRIDES[name], causal,
                                   bp.get("residual", False),
                                   bp.get("multiplier", 1), mode)
    x = _norm(cfg, dec.conv_norm_out, x)

    if cfg.timestep_conditioning:
        b, c = x.shape[0], x.shape[1]
        emb = _pixart_time_embed(dec.last_time_embedder, scaled_t, b)
        vals = dec.last_scale_shift_table.float()[None] + emb.reshape(b, 2, c)
        shift = vals[:, 0][:, :, None, None, None].to(x.dtype)
        scale = vals[:, 1][:, :, None, None, None].to(x.dtype)
        x = x * (1 + scale) + shift

    x = causal_conv3d(dec.conv_out, F.silu(x), causal=causal,
                      spatial_mode=mode)
    return _unpatchify_pixels(x, cfg.patch_size).permute(0, 2, 3, 4, 1)


def un_normalize_latents(latents: torch.Tensor,
                         stats: LatentStats) -> torch.Tensor:
    mean = stats.mean_of_means.to(latents.dtype)
    std = stats.std_of_means.to(latents.dtype)
    return latents * std + mean


@torch.no_grad()
def init_params(vae: CausalVAEDecoder, generator: torch.Generator
                ) -> CausalVAEDecoder:
    """Random weights in the JAX ``init_params`` distribution (decoder,
    and encoder where the module has one)."""
    def randn(t):
        return torch.randn(t.shape, generator=generator, device=t.device,
                           dtype=t.dtype)

    for mod in vae.modules():
        if isinstance(mod, Conv3d):
            fan_in = math.prod(mod.weight.shape[1:])
            mod.weight.copy_(randn(mod.weight) * fan_in ** -0.5)
        elif isinstance(mod, Linear):
            mod.weight.copy_(randn(mod.weight) * mod.d_in ** -0.5)
    for name, p in vae.named_parameters():
        if name.endswith("scale_shift_table"):
            p.copy_(randn(p) / p.shape[1] ** 0.5)
    return vae
