"""The LTX-Video causal VAE in float32: a frozen copy of the port's
``models/ltx/vae.py`` (encoder, timestep-conditioned decoder, the latent
statistics) and of ``models/ltx/vae_tiling.py``'s temporal tiling, for
what the configurations use (pixel norm; ``res_x`` and ``res_x_y`` blocks
without noise injection; the strided ``compress_*`` and the space-to-depth
``compress_*_res`` downsamplers; the depth-to-space upsamplers, residual or
not; the uniform log-variance), with the port's parameter names and
shapes. Anything else is refused, so that a configuration the copy does
not follow cannot pass.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from h100bench import weights

from .common import Linear, layer_norm, pixel_norm, timestep_embedding

_STRIDES = {"compress_time": (2, 1, 1), "compress_space": (1, 2, 2),
            "compress_all": (2, 2, 2)}
_RES_STRIDES = {"compress_time_res": (2, 1, 1),
                "compress_space_res": (1, 2, 2),
                "compress_all_res": (2, 2, 2)}


def _blocks(cfg, key):
    out = []
    for name, p in cfg[key] if key in cfg else cfg["blocks"]:
        p = {"num_layers": p} if isinstance(p, int) else dict(p)
        if name not in ("res_x", "res_x_y", *_STRIDES, *_RES_STRIDES) or \
                p.get("inject_noise") or \
                (name in _RES_STRIDES and key == "decoder_blocks"):
            raise ValueError(f"VAE block {name} {p} is not in the reference")
        out.append((name, p))
    return out


def check_config(cfg):
    if (cfg.get("norm_layer") != "pixel_norm"
            or cfg.get("latent_log_var") != "uniform"
            or cfg.get("use_quant_conv")
            or not cfg.get("timestep_conditioning")
            or cfg.get("spatial_padding_mode", "zeros") != "zeros"):
        raise ValueError("VAE settings not in the reference")


def _stride(name):
    return _STRIDES.get(name) or _RES_STRIDES[name]


def spatial_factor(cfg):
    n = sum(1 for b, _ in _blocks(cfg, "encoder_blocks")
            if b.startswith("compress") and _stride(b)[1] == 2)
    return 2 ** n * cfg.get("patch_size", 1)


def temporal_factor(cfg):
    n = sum(1 for b, _ in _blocks(cfg, "encoder_blocks")
            if b.startswith("compress") and _stride(b)[0] == 2)
    return 2 ** n


def _encoder_plan(cfg):
    plan, ch = [], cfg.get("base_channels", 128)
    for name, bp in _blocks(cfg, "encoder_blocks"):
        cin = ch
        if name == "res_x_y" or name in _RES_STRIDES:
            ch = bp.get("multiplier", 2) * ch
        plan.append((name, bp, cin, ch))
    return plan


def _decoder_plan(cfg):
    blocks = list(reversed(_blocks(cfg, "decoder_blocks")))
    ch = cfg.get("base_channels", 128)
    for name, bp in blocks:
        if name == "res_x_y":
            ch *= bp.get("multiplier", 2)
        if name == "compress_all":
            ch *= bp.get("multiplier", 1)
    plan, c = [], ch
    for name, bp in blocks:
        cin = c
        if name == "res_x_y":
            c //= bp.get("multiplier", 2)
        elif name == "compress_all":
            c //= bp.get("multiplier", 1)
        plan.append((name, bp, cin, c))
    return ch, plan


class Conv3d(nn.Module):
    def __init__(self, cin, cout, k=3, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, k,
                                               device=device),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout, device=device),
                                 requires_grad=False)


class NormParams(nn.Module):
    def __init__(self, channels, *, device=None, force=False):
        super().__init__()
        if force:
            self.weight = nn.Parameter(torch.ones(channels, device=device),
                                       requires_grad=False)
            self.bias = nn.Parameter(torch.zeros(channels, device=device),
                                     requires_grad=False)


class TimeEmbedder(nn.Module):
    def __init__(self, cout, *, device=None):
        super().__init__()
        self.linear_1 = Linear(256, cout, device=device)
        self.linear_2 = Linear(cout, cout, device=device)


def causal_conv3d(conv, x, stride=(1, 1, 1), causal=True):
    kt, kh, kw = conv.weight.shape[2:]
    if kt > 1:
        if causal:
            x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], 2)
        else:
            half = (kt - 1) // 2
            x = torch.cat([x[:, :, :1].expand(-1, -1, half, -1, -1), x,
                           x[:, :, -1:].expand(-1, -1, half, -1, -1)], 2)
    ph, pw = kh // 2, kw // 2
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph, 0, 0))
    return F.conv3d(x, conv.weight, stride=stride) + \
        conv.bias[:, None, None, None]


def _channel_layer_norm(x, w, b):
    return layer_norm(x.movedim(1, -1), w, b, eps=1e-6).movedim(-1, 1)


def _time_embed(p, t, batch):
    emb = timestep_embedding(torch.as_tensor(t).float().reshape(-1)
                             .expand(batch), 256)
    return p.linear_2(F.silu(p.linear_1(emb)))


class ResBlock(nn.Module):
    def __init__(self, cin, cout, timestep_cond, *, device=None):
        super().__init__()
        self.norm1 = NormParams(cin, device=device)
        self.conv1 = Conv3d(cin, cout, device=device)
        self.norm2 = NormParams(cout, device=device)
        self.conv2 = Conv3d(cout, cout, device=device)
        if cin != cout:
            self.conv_shortcut = Conv3d(cin, cout, 1, device=device)
            self.norm3 = NormParams(cin, device=device, force=True)
        if timestep_cond:
            self.scale_shift_table = nn.Parameter(
                torch.empty(4, cin, device=device), requires_grad=False)

    def forward(self, x, causal, temb):
        h = pixel_norm(x)
        sst = getattr(self, "scale_shift_table", None)
        modulate = sst is not None and temb is not None
        if modulate:
            b, c = x.shape[0], sst.shape[1]
            ada = sst[None] + temb.reshape(b, 4, c)
            sh1, sc1, sh2, sc2 = [ada[:, i][:, :, None, None, None]
                                  for i in range(4)]
            h = h * (1 + sc1) + sh1
        h = causal_conv3d(self.conv1, F.silu(h), causal=causal)
        h = pixel_norm(h)
        if modulate:
            h = h * (1 + sc2) + sh2
        h = causal_conv3d(self.conv2, F.silu(h), causal=causal)
        sc = x
        if hasattr(self, "norm3"):
            sc = _channel_layer_norm(sc, self.norm3.weight, self.norm3.bias)
        if hasattr(self, "conv_shortcut"):
            sc = causal_conv3d(self.conv_shortcut, sc)
        return sc + h


class MidBlock(nn.Module):
    def __init__(self, cin, num_layers, timestep_cond, *, device=None):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            ResBlock(cin, cin, timestep_cond, device=device)
            for _ in range(num_layers))
        if timestep_cond:
            self.time_embedder = TimeEmbedder(cin * 4, device=device)

    def forward(self, x, causal, timestep):
        temb = None
        if hasattr(self, "time_embedder") and timestep is not None:
            temb = _time_embed(self.time_embedder, timestep, x.shape[0])
        for rb in self.res_blocks:
            x = rb(x, causal, temb)
        return x


class Upsample(nn.Module):
    def __init__(self, cin, cout, *, device=None):
        super().__init__()
        self.conv = Conv3d(cin, cout, device=device)


class Downsample(nn.Module):
    def __init__(self, cin, cout, *, device=None):
        super().__init__()
        self.conv = Conv3d(cin, cout, device=device)


def _space_to_depth(down, x, stride):
    """``compress_*_res``: a causal conv and a space-to-depth, plus the
    group mean of the input's space-to-depth as the skip branch."""
    if stride[0] == 2:
        x = torch.cat([x[:, :, :1], x], dim=2)
    p1, p2, p3 = stride
    to_depth = "b c (d p1) (h p2) (w p3) -> b (c p1 p2 p3) d h w"
    skip = rearrange(x, to_depth, p1=p1, p2=p2, p3=p3)
    out_ch = down.conv.weight.shape[0] * p1 * p2 * p3
    skip = rearrange(skip, "b (c g) d h w -> b c g d h w",
                     g=skip.shape[1] // out_ch).mean(dim=2)
    y = rearrange(causal_conv3d(down.conv, x), to_depth, p1=p1, p2=p2, p3=p3)
    return y + skip


class Decoder(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        base, plan = _decoder_plan(cfg)
        self.conv_in = Conv3d(cfg["latent_channels"], base, device=device)
        blocks = []
        for name, bp, cin, cout in plan:
            if name == "res_x":
                blocks.append(MidBlock(cin, bp["num_layers"], True,
                                       device=device))
            elif name == "res_x_y":
                blocks.append(ResBlock(cin, cout, False, device=device))
            else:
                red = bp.get("multiplier", 1) if name == "compress_all" else 1
                blocks.append(Upsample(
                    cin, int(np.prod(_STRIDES[name])) * cin // red,
                    device=device))
        self.up_blocks = nn.ModuleList(blocks)
        final = plan[-1][3]
        self.conv_norm_out = NormParams(final, device=device)
        self.conv_out = Conv3d(final, cfg.get("out_channels", 3)
                               * cfg.get("patch_size", 1) ** 2, device=device)
        self.timestep_scale_multiplier = 1000.0
        self.last_time_embedder = TimeEmbedder(final * 2, device=device)
        self.last_scale_shift_table = nn.Parameter(
            torch.empty(2, final, device=device), requires_grad=False)


class Encoder(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        plan = _encoder_plan(cfg)
        p = cfg.get("patch_size", 1)
        base = cfg.get("base_channels", 128)
        self.conv_in = Conv3d(cfg.get("in_channels", 3) * p ** 2, base,
                              device=device)
        blocks = []
        for name, bp, cin, cout in plan:
            if name == "res_x":
                blocks.append(MidBlock(cin, bp["num_layers"], False,
                                       device=device))
            elif name == "res_x_y":
                blocks.append(ResBlock(cin, cout, False, device=device))
            elif name in _RES_STRIDES:
                blocks.append(Downsample(
                    cin, cout // int(np.prod(_RES_STRIDES[name])),
                    device=device))
            else:
                blocks.append(Conv3d(cin, cout, device=device))
        self.down_blocks = nn.ModuleList(blocks)
        last = plan[-1][3]
        self.conv_norm_out = NormParams(last, device=device)
        self.conv_out = Conv3d(last, cfg["latent_channels"] + 1, device=device)


class VAE(nn.Module):
    """Encoder, decoder and (default) latent statistics, drawn from
    ``seed`` as the group ``"vae"``."""

    def __init__(self, cfg, seed, device):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        self.decoder = Decoder(cfg, device=device)
        self.encoder = Encoder(cfg, device=device)
        weights.fill(self, seed, "vae")
        c = cfg["latent_channels"]
        self.std_of_means = torch.ones(c, device=device)
        self.mean_of_means = torch.zeros(c, device=device)


def normalize(z, vae):
    return (z - vae.mean_of_means) / vae.std_of_means


def un_normalize(z, vae):
    return z * vae.std_of_means + vae.mean_of_means


@torch.no_grad()
def encode(vae, media):
    """Pixels ``[B, F, H, W, 3]`` in [-1, 1] -> normalized latents (the
    posterior's mode) ``[B, F', H', W', C]``."""
    cfg, enc = vae.cfg, vae.encoder
    p = cfg.get("patch_size", 1)
    x = media.float().permute(0, 4, 1, 2, 3)
    x = rearrange(x, "b c f (h q) (w r) -> b (c r q) f h w", q=p, r=p)
    x = causal_conv3d(enc.conv_in, x)
    for (name, _, _, _), blk in zip(_encoder_plan(cfg), enc.down_blocks):
        if name in ("res_x", "res_x_y"):
            x = blk(x, True, None)
        elif name in _RES_STRIDES:
            x = _space_to_depth(blk, x, _RES_STRIDES[name])
        else:
            x = causal_conv3d(blk, x, stride=_STRIDES[name])
    x = causal_conv3d(enc.conv_out, F.silu(pixel_norm(x)))
    mean = x[:, :cfg["latent_channels"]]
    return normalize(mean.permute(0, 2, 3, 4, 1), vae)


@torch.no_grad()
def decode(vae, latents, timestep):
    """Latents ``[B, F', H', W', C]`` (un-normalized) -> pixels
    ``[B, F, H, W, 3]``."""
    cfg, dec = vae.cfg, vae.decoder
    causal = cfg.get("causal_decoder", False)
    x = latents.float().permute(0, 4, 1, 2, 3)
    x = causal_conv3d(dec.conv_in, x, causal=causal)
    scaled_t = torch.as_tensor(timestep, dtype=torch.float32,
                               device=x.device) * dec.timestep_scale_multiplier
    _, plan = _decoder_plan(cfg)
    for (name, bp, _, _), blk in zip(plan, dec.up_blocks):
        if name == "res_x":
            x = blk(x, causal, scaled_t)
        elif name == "res_x_y":
            x = blk(x, causal, None)
        else:
            stride = _STRIDES[name]
            residual = bp.get("residual", False)
            if residual:
                rep = int(np.prod(stride)) // bp.get("multiplier", 1)
                x_in = rearrange(
                    x, "b (c p1 p2 p3) d h w -> b c (d p1) (h p2) (w p3)",
                    p1=stride[0], p2=stride[1], p3=stride[2])
                x_in = torch.cat([x_in] * rep, dim=1)
                if stride[0] == 2:
                    x_in = x_in[:, :, 1:]
            y = causal_conv3d(blk.conv, x, causal=causal)
            y = rearrange(y, "b (c p1 p2 p3) d h w -> b c (d p1) (h p2) (w p3)",
                          p1=stride[0], p2=stride[1], p3=stride[2])
            if stride[0] == 2:
                y = y[:, :, 1:]
            x = y + x_in if residual else y
    x = pixel_norm(x)
    b, c = x.shape[:2]
    emb = _time_embed(dec.last_time_embedder, scaled_t, b)
    vals = dec.last_scale_shift_table[None] + emb.reshape(b, 2, c)
    x = x * (1 + vals[:, 1][:, :, None, None, None]) + \
        vals[:, 0][:, :, None, None, None]
    x = causal_conv3d(dec.conv_out, F.silu(x), causal=causal)
    p = cfg.get("patch_size", 1)
    x = rearrange(x, "b (c r q) f h w -> b c f (h q) (w r)", q=p, r=p)
    return x.permute(0, 2, 3, 4, 1)


def _blend(a, b, extent, axis):
    extent = min(a.shape[axis], b.shape[axis], extent)
    if extent <= 0:
        return b
    shape = [1] * b.dim()
    shape[axis] = extent
    w = (torch.arange(extent, dtype=torch.float32, device=b.device)
         / extent).reshape(shape)
    a_tail = a.narrow(axis, a.shape[axis] - extent, extent)
    blended = a_tail * (1 - w) + b.narrow(axis, 0, extent) * w
    return torch.cat([blended, b.narrow(axis, extent, b.shape[axis] - extent)],
                     dim=axis)


@torch.no_grad()
def decode_tiled(vae, latents, z_tile, timestep):
    """``z_tile`` latent frames a tile (0: untiled), blended as the port's
    ``vae_tiling.tiled_decode`` blends them (overlap factor 1/4)."""
    if not (z_tile > 1 and latents.shape[1] > z_tile + 1):
        return decode(vae, latents, timestep)
    tsf = temporal_factor(vae.cfg)
    tile_t = z_tile * tsf
    blend_extent = int(tile_t * 0.25)
    t_limit = tile_t - blend_extent
    step = int(z_tile * 0.75)
    row = []
    for i in range(0, latents.shape[1], step):
        out = decode(vae, latents[:, i: i + z_tile + 1], timestep)
        row.append(out[:, 1:] if i > 0 else out)
    result = []
    for i, tile in enumerate(row):
        if i > 0:
            tile = _blend(row[i - 1], tile, blend_extent, 1)
            result.append(tile[:, :t_limit])
        else:
            result.append(tile[:, :t_limit + 1])
    return torch.cat(result, dim=1)


def decode_tiles(cfg, latents):
    """The port's ``LTXPipeline._decode_tiles`` rule on one card: untiled
    up to 704x480x121 voxels, else temporal tiles of 4 latent frames when
    one fits that budget (larger requests are not in a cell)."""
    sf, tf = spatial_factor(cfg), temporal_factor(cfg)
    h, w = latents.shape[2] * sf, latents.shape[3] * sf
    frames = (latents.shape[1] - 1) * tf + 1
    envelope = 704 * 480 * 121
    if h * w * frames <= envelope:
        return 0
    if h * w * (4 * tf + 1) <= envelope:
        return 4
    raise ValueError("spatially tiled decodes are not in the reference")
