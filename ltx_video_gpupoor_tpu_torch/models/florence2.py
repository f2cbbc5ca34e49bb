"""Florence-2 (DaViT vision tower + BART seq2seq LM): the prompt
enhancer's image captioner.

Port of ``ltx_video_gpupoor_tpu/models/florence2.py``: the configs and
``config_from_hf`` (:38-121); the DaViT tower (:163-306: conv patch
embeddings, then pairs of a window-attention half and a channel-attention
half, each with depthwise 3x3 convs and a GELU FFN); the multimodal
projector ``project_image_features`` with its learned 2-D and 1-D cosine
temporal embeddings (:313-356); BART's ``encode`` and ``decode_full``
(:363-472); ``build_encoder_embeds``, ``forward`` and ``generate``
(:475-590: greedy, the cross K/V computed once a layer, a static self K/V
cache, forced BOS and EOS); ``convert_hf_state_dict`` and ``load_hf_dir``
(:597-724).

Modules carry the JAX keys as attribute names (``vision.stages.{s}.
blocks.{i}.spatial.qkv``, ``projector.row_embeddings``, ``text.decoder.
layers.{i}.encoder_attn.q``), so ``core/from_jax.py::florence2_state_dict``
carries JAX's weights over; the published names differ from them by
renames only (:func:`hf_names`). Activations follow the weights' dtype;
attention scores are taken in it and the softmax in fp32 (``_mha``, :141),
the layer norms in fp32. No hand kernel: the JAX package reaches no
Pallas kernel here either. Activations are channels-last ``[B, H, W, C]``
as in JAX; the convolutions run on a channels-first view.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import layer_norm
from ..ops.quant import Linear
from .llm import read_hf_dir, resolve_device


@dataclasses.dataclass(frozen=True)
class FlorenceVisionConfig:
    in_channels: int = 3
    depths: tuple = (1, 1, 9, 1)
    patch_size: tuple = (7, 3, 3, 3)
    patch_stride: tuple = (4, 2, 2, 2)
    patch_padding: tuple = (3, 1, 1, 1)
    patch_prenorm: tuple = (False, True, True, True)
    embed_dim: tuple = (128, 256, 512, 1024)
    num_heads: tuple = (4, 8, 16, 32)
    num_groups: tuple = (4, 8, 16, 32)
    window_size: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    projection_dim: int = 1024
    max_temporal_embeddings: int = 100
    max_position_embeddings: int = 50


@dataclasses.dataclass(frozen=True)
class FlorenceTextConfig:
    """BART (the Florence-2 language model)."""
    vocab_size: int = 51289
    d_model: int = 1024
    encoder_layers: int = 12
    decoder_layers: int = 12
    num_heads: int = 16
    ffn_dim: int = 4096
    max_position_embeddings: int = 1024
    scale_embedding: bool = False
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    forced_bos_token_id: Optional[int] = 0
    forced_eos_token_id: Optional[int] = 2


@dataclasses.dataclass(frozen=True)
class FlorenceConfig:
    vision: FlorenceVisionConfig
    text: FlorenceTextConfig
    image_token_id: int = 51289


def config_from_hf(hf: dict) -> FlorenceConfig:
    v = hf.get("vision_config", {})
    t = hf.get("text_config", {})
    vision = FlorenceVisionConfig(
        in_channels=v.get("in_channels", 3),
        depths=tuple(v.get("depths", (1, 1, 9, 1))),
        patch_size=tuple(v.get("patch_size", (7, 3, 3, 3))),
        patch_stride=tuple(v.get("patch_stride", (4, 2, 2, 2))),
        patch_padding=tuple(v.get("patch_padding", (3, 1, 1, 1))),
        patch_prenorm=tuple(v.get("patch_prenorm",
                                  (False, True, True, True))),
        embed_dim=tuple(v.get("embed_dim", (128, 256, 512, 1024))),
        num_heads=tuple(v.get("num_heads", (4, 8, 16, 32))),
        num_groups=tuple(v.get("num_groups", (4, 8, 16, 32))),
        window_size=v.get("window_size", 12),
        mlp_ratio=v.get("mlp_ratio", 4.0),
        qkv_bias=v.get("qkv_bias", True),
        projection_dim=v.get("projection_dim", 1024),
        max_temporal_embeddings=v.get("max_temporal_embeddings", 100),
        max_position_embeddings=v.get("max_position_embeddings", 50),
    )
    text = FlorenceTextConfig(
        vocab_size=t.get("vocab_size", 51289),
        d_model=t.get("d_model", 1024),
        encoder_layers=t.get("encoder_layers", 12),
        decoder_layers=t.get("decoder_layers", 12),
        num_heads=t.get("encoder_attention_heads", 16),
        ffn_dim=t.get("encoder_ffn_dim", 4096),
        max_position_embeddings=t.get("max_position_embeddings", 1024),
        scale_embedding=t.get("scale_embedding", False),
        pad_token_id=t.get("pad_token_id", 1),
        bos_token_id=t.get("bos_token_id", 0),
        eos_token_id=t.get("eos_token_id", 2),
        decoder_start_token_id=t.get("decoder_start_token_id", 2),
        forced_bos_token_id=t.get("forced_bos_token_id", 0),
        forced_eos_token_id=t.get("forced_eos_token_id", 2),
    )
    return FlorenceConfig(vision=vision, text=text,
                          image_token_id=hf.get("image_token_id", 51289))


# ---------------------------------------------------------------------------
# Modules (attribute names are the JAX parameter keys)
# ---------------------------------------------------------------------------

def _param(*shape, **kw):
    return nn.Parameter(torch.empty(*shape, **kw), requires_grad=False)


class _Norm(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d, **kw), requires_grad=False)


class _Conv(nn.Module):
    def __init__(self, cin, cout, k, **kw):
        super().__init__()
        self.weight = _param(cout, cin, k, k, **kw)
        self.bias = nn.Parameter(torch.zeros(cout, **kw), requires_grad=False)


class _Half(nn.Module):
    """One DaViT half block: dw-conv + attention, dw-conv + FFN."""

    def __init__(self, d, mlp_dim, qkv_bias, **kw):
        super().__init__()
        self.conv = _Conv(1, d, 3, **kw)
        self.norm1 = _Norm(d, **kw)
        self.qkv = Linear(d, 3 * d, qkv_bias, **kw)
        self.proj = Linear(d, d, **kw)
        self.conv2 = _Conv(1, d, 3, **kw)
        self.norm2 = _Norm(d, **kw)
        self.fc1 = Linear(d, mlp_dim, **kw)
        self.fc2 = Linear(mlp_dim, d, **kw)


class _DaViTBlock(nn.Module):
    def __init__(self, d, mlp_dim, qkv_bias, **kw):
        super().__init__()
        self.spatial = _Half(d, mlp_dim, qkv_bias, **kw)
        self.channel = _Half(d, mlp_dim, qkv_bias, **kw)


class FlorenceVision(nn.Module):
    def __init__(self, cfg: FlorenceVisionConfig, **kw):
        super().__init__()
        self.stages = nn.ModuleList()
        for si, depth in enumerate(cfg.depths):
            d = cfg.embed_dim[si]
            din = cfg.in_channels if si == 0 else cfg.embed_dim[si - 1]
            stage = nn.Module()
            stage.conv_embed = nn.Module()
            stage.conv_embed.conv = _Conv(din, d, cfg.patch_size[si], **kw)
            stage.conv_embed.norm = _Norm(
                din if cfg.patch_prenorm[si] else d, **kw)
            stage.blocks = nn.ModuleList(
                _DaViTBlock(d, int(d * cfg.mlp_ratio), cfg.qkv_bias, **kw)
                for _ in range(depth))
            self.stages.append(stage)


class FlorenceProjector(nn.Module):
    def __init__(self, cfg: FlorenceConfig, **kw):
        super().__init__()
        d, pd = cfg.vision.embed_dim[-1], cfg.vision.projection_dim
        n = cfg.vision.max_position_embeddings
        self.image_projection = Linear(d, pd, False, **kw)
        self.image_proj_norm = _Norm(pd, **kw)
        self.row_embeddings = _param(n, d // 2, **kw)
        self.column_embeddings = _param(n, d - d // 2, **kw)


class _BartAttn(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        for n in ("q", "k", "v", "o"):
            setattr(self, n, Linear(d, d, **kw))


class _BartLayer(nn.Module):
    def __init__(self, cfg: FlorenceTextConfig, cross: bool, **kw):
        super().__init__()
        d = cfg.d_model
        self.self_attn = _BartAttn(d, **kw)
        self.self_attn_layer_norm = _Norm(d, **kw)
        self.fc1 = Linear(d, cfg.ffn_dim, **kw)
        self.fc2 = Linear(cfg.ffn_dim, d, **kw)
        self.final_layer_norm = _Norm(d, **kw)
        if cross:
            self.encoder_attn = _BartAttn(d, **kw)
            self.encoder_attn_layer_norm = _Norm(d, **kw)


class _BartStack(nn.Module):
    def __init__(self, cfg: FlorenceTextConfig, n: int, cross: bool, **kw):
        super().__init__()
        self.embed_positions = _param(cfg.max_position_embeddings + 2,
                                      cfg.d_model, **kw)
        self.layernorm_embedding = _Norm(cfg.d_model, **kw)
        self.layers = nn.ModuleList(_BartLayer(cfg, cross, **kw)
                                    for _ in range(n))


class FlorenceText(nn.Module):
    def __init__(self, cfg: FlorenceTextConfig, **kw):
        super().__init__()
        self.shared = _param(cfg.vocab_size, cfg.d_model, **kw)
        self.encoder = _BartStack(cfg, cfg.encoder_layers, False, **kw)
        self.decoder = _BartStack(cfg, cfg.decoder_layers, True, **kw)
        self.final_logits_bias = nn.Parameter(
            torch.zeros(cfg.vocab_size, **kw), requires_grad=False)


class Florence2(nn.Module):
    """``vision`` (the DaViT tower), ``projector``, ``text`` (BART). One
    dtype for every weight; the activations run in it."""

    def __init__(self, cfg: FlorenceConfig, *, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.vision = FlorenceVision(cfg.vision, **kw)
        self.projector = FlorenceProjector(cfg, **kw)
        self.text = FlorenceText(cfg.text, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.text.shared.dtype

    @property
    def device(self) -> torch.device:
        return self.text.shared.device


@torch.no_grad()
def init_params(model: Florence2, generator: torch.Generator) -> Florence2:
    """Random weights in the JAX ``init_params`` distribution: every
    linear, conv and table N(0, 0.02**2), zero biases, unit norms. Draws
    on the model's device from ``generator``."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.dim() >= 2 or leaf in (
                "row_embeddings", "column_embeddings", "embed_positions",
                "shared"):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                                dtype=p.dtype) * 0.02)
    return model


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _ln(p: _Norm, x):
    return layer_norm(x, p.weight, p.bias, eps=1e-5)


def _mha(q, k, v, n_heads, bias=None, scale=None):
    """``[B, S, D]`` multi-head attention: scores in the activations'
    dtype, softmax in fp32."""
    b, sq, d = q.shape
    sk = k.shape[1]
    hd = d // n_heads
    q = q.reshape(b, sq, n_heads, hd).transpose(1, 2)
    k = k.reshape(b, sk, n_heads, hd).transpose(1, 2)
    v = v.reshape(b, sk, n_heads, hd).transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-1, -2)) * (
        hd ** -0.5 if scale is None else scale)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, v).transpose(1, 2).reshape(b, sq, d)


def _nhwc_conv(p: _Conv, x, stride=1, padding=1, groups=1):
    y = F.conv2d(x.permute(0, 3, 1, 2), p.weight.to(x.dtype), stride=stride,
                 padding=padding, groups=groups).permute(0, 2, 3, 1)
    return y + p.bias.to(y.dtype)


def _bias(keep: torch.Tensor) -> torch.Tensor:
    return torch.zeros(keep.shape, device=keep.device).masked_fill(
        ~keep, -1e9)


# ---------------------------------------------------------------------------
# DaViT vision tower
# ---------------------------------------------------------------------------

def _window_attn(p: _Half, cfg: FlorenceVisionConfig, x, n_heads):
    """``[B, H, W, C]`` window attention (DaViT's spatial mixer)."""
    b, h, w, c = x.shape
    ws = cfg.window_size
    ph, pw = (-h) % ws, (-w) % ws
    xp = F.pad(x, (0, 0, 0, pw, 0, ph))
    hh, ww = h + ph, w + pw
    xw = (xp.reshape(b, hh // ws, ws, ww // ws, ws, c)
          .permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c))
    q, k, v = p.qkv(xw).chunk(3, dim=-1)
    out = p.proj(_mha(q, k, v, n_heads))
    out = (out.reshape(b, hh // ws, ww // ws, ws, ws, c)
           .permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, c))
    return out[:, :h, :w]


def _channel_attn(p: _Half, x, groups):
    """``[B, N, C]`` grouped channel attention: the C / groups channels of
    a group attend over each other, scaled by the token count."""
    b, n, c = x.shape
    qkv = p.qkv(x).reshape(b, n, 3, groups, c // groups)
    q, k, v = (qkv[:, :, i].permute(0, 2, 3, 1) for i in range(3))
    scores = torch.matmul(q, k.transpose(-1, -2)) * n ** -0.5
    probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
    out = torch.matmul(probs, v).permute(0, 3, 1, 2).reshape(b, n, c)
    return p.proj(out)


def _ffn(p: _Half, x):
    return p.fc2(F.gelu(p.fc1(_ln(p.norm2, x)), approximate="none"))


@torch.no_grad()
def vision_forward(model: Florence2, pixels: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 3]`` -> ``[B, H', W', embed_dim[-1]]`` feature map."""
    cfg = model.cfg.vision
    x = pixels.to(device=model.device, dtype=model.dtype)
    for si, stage in enumerate(model.vision.stages):
        ce = stage.conv_embed
        if cfg.patch_prenorm[si]:
            x = _ln(ce.norm, x)
        x = _nhwc_conv(ce.conv, x, cfg.patch_stride[si],
                       cfg.patch_padding[si])
        if not cfg.patch_prenorm[si]:
            x = _ln(ce.norm, x)
        n_heads, groups = cfg.num_heads[si], cfg.num_groups[si]
        for blk in stage.blocks:
            b, h, w, c = x.shape
            sp = blk.spatial
            x = _nhwc_conv(sp.conv, x, groups=c) + x
            x = x + _window_attn(sp, cfg, _ln(sp.norm1, x), n_heads)
            x = _nhwc_conv(sp.conv2, x, groups=c) + x
            x = x + _ffn(sp, x)
            chp = blk.channel
            x = _nhwc_conv(chp.conv, x, groups=c) + x
            flat = x.reshape(b, h * w, c)
            flat = flat + _channel_attn(chp, _ln(chp.norm1, flat), groups)
            x = _nhwc_conv(chp.conv2, flat.reshape(b, h, w, c), groups=c) + \
                flat.reshape(b, h, w, c)
            flat = x.reshape(b, h * w, c)
            x = (flat + _ffn(chp, flat)).reshape(b, h, w, c)
    return x


# ---------------------------------------------------------------------------
# Multimodal projector
# ---------------------------------------------------------------------------

def _cosine_1d(seq_len: int, dim: int) -> np.ndarray:
    half = dim // 2
    emb = np.exp(np.arange(half) * (-math.log(10000) / half))
    ang = np.arange(seq_len)[:, None] * emb[None]
    out = np.empty((seq_len, dim), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


@torch.no_grad()
def project_image_features(model: Florence2,
                           feat: torch.Tensor) -> torch.Tensor:
    """``[B, H', W', C]`` tower output -> ``[B, H'W' + 1, projection_dim]``:
    learned 2-D positions, the cosine temporal embedding of one frame, the
    spatial mean token first, projection + LN."""
    p = model.projector
    b, h, w, c = feat.shape
    pos = torch.cat([p.column_embeddings[None, :w].expand(h, w, -1),
                     p.row_embeddings[:h, None].expand(h, w, -1)], dim=-1)
    x = (feat + pos[None]).reshape(b, h * w, c)
    x = x + torch.from_numpy(_cosine_1d(1, c)).to(feat.device, feat.dtype)
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
    return _ln(p.image_proj_norm, p.image_projection(x))


# ---------------------------------------------------------------------------
# BART encoder-decoder
# ---------------------------------------------------------------------------

def _bart_attn(p: _BartAttn, xq, xkv, n_heads, bias=None):
    q = p.q(xq) * (xq.shape[-1] // n_heads) ** -0.5
    return p.o(_mha(q, p.k(xkv), p.v(xkv), n_heads, bias=bias, scale=1.0))


def _bart_ffn(p: _BartLayer, x):
    h = p.fc2(F.gelu(p.fc1(x), approximate="none"))
    return _ln(p.final_layer_norm, x + h)


def _embed_scale(cfg: FlorenceTextConfig) -> float:
    return math.sqrt(cfg.d_model) if cfg.scale_embedding else 1.0


@torch.no_grad()
def encode(model: Florence2, embeds: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """BART encoder over input embeddings ``[B, S, d]``; ``mask`` 1 = real."""
    cfg, enc = model.cfg.text, model.text.encoder
    s = embeds.shape[1]
    x = embeds * _embed_scale(cfg) + enc.embed_positions[2:s + 2][None]
    x = _ln(enc.layernorm_embedding, x)
    bias = _bias(mask.to(x.device)[:, None, None, :] > 0)
    for p in enc.layers:
        x = _ln(p.self_attn_layer_norm,
                x + _bart_attn(p.self_attn, x, x, cfg.num_heads, bias))
        x = _bart_ffn(p, x)
    return x


def _logits(model: Florence2, x):
    return F.linear(x, model.text.shared) + model.text.final_logits_bias


@torch.no_grad()
def decode_full(model: Florence2, dec_ids: torch.Tensor,
                enc_out: torch.Tensor, enc_mask: torch.Tensor
                ) -> torch.Tensor:
    """Teacher-forced decoder over ``dec_ids [B, S]`` -> logits."""
    cfg, dec = model.cfg.text, model.text.decoder
    dev = enc_out.device
    dec_ids = dec_ids.to(dev)
    s = dec_ids.shape[1]
    x = (model.text.shared[dec_ids] * _embed_scale(cfg)
         + dec.embed_positions[2:s + 2][None])
    x = _ln(dec.layernorm_embedding, x)
    causal = _bias(torch.ones(s, s, dtype=torch.bool, device=dev).tril())
    xbias = _bias(enc_mask.to(dev)[:, None, None, :] > 0)
    for p in dec.layers:
        x = _ln(p.self_attn_layer_norm,
                x + _bart_attn(p.self_attn, x, x, cfg.num_heads, causal))
        x = _ln(p.encoder_attn_layer_norm,
                x + _bart_attn(p.encoder_attn, x, enc_out, cfg.num_heads,
                               xbias))
        x = _bart_ffn(p, x)
    return _logits(model, x)


@torch.no_grad()
def build_encoder_embeds(model: Florence2, input_ids: torch.Tensor,
                         image_features: Optional[torch.Tensor]
                         ) -> torch.Tensor:
    """Token embeddings with the image features placed at the
    ``image_token_id`` placeholders, the k-th placeholder taking feature
    k (``masked_scatter``). The placeholder id lies past the vocabulary:
    its lookup is clamped, as XLA's gather clamps."""
    shared = model.text.shared
    ids = input_ids.to(shared.device)
    embeds = shared[ids.clamp(0, shared.shape[0] - 1)]
    if image_features is None:
        return embeds
    flat = ids.reshape(-1)
    is_img = flat == model.cfg.image_token_id
    feats = image_features.reshape(-1, image_features.shape[-1])
    order = (torch.cumsum(is_img.long(), 0) - 1).clamp(0, feats.shape[0] - 1)
    out = torch.where(is_img[:, None], feats[order].to(embeds.dtype),
                      embeds.reshape(-1, embeds.shape[-1]))
    return out.reshape(embeds.shape)


def _image_features(model, pixels):
    if pixels is None:
        return None
    return project_image_features(model, vision_forward(model, pixels))


@torch.no_grad()
def forward(model: Florence2, input_ids: torch.Tensor,
            pixels: Optional[torch.Tensor], dec_ids: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full multimodal seq2seq forward -> decoder logits."""
    if mask is None:
        mask = torch.ones(input_ids.shape, dtype=torch.int32)
    embeds = build_encoder_embeds(model, input_ids,
                                  _image_features(model, pixels))
    mask = mask.to(embeds.device)
    return decode_full(model, dec_ids, encode(model, embeds, mask), mask)


@torch.no_grad()
def generate(model: Florence2, input_ids: torch.Tensor,
             pixels: Optional[torch.Tensor], max_new_tokens: int,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy seq2seq generation. Returns ``[B, max_new_tokens]`` int64
    starting with the forced BOS; a finished row repeats EOS. The cross
    K/V are computed once a layer; each step writes one row of the
    decoder's static self K/V cache."""
    cfg = model.cfg.text
    if mask is None:
        mask = torch.ones(input_ids.shape, dtype=torch.int32)
    embeds = build_encoder_embeds(model, input_ids,
                                  _image_features(model, pixels))
    dev = embeds.device
    mask = mask.to(dev)
    enc_out = encode(model, embeds, mask)
    b = input_ids.shape[0]
    d, nh = cfg.d_model, cfg.num_heads
    hd = d // nh
    max_len = max_new_tokens + 1
    dec = model.text.decoder
    xbias = _bias(mask[:, None, None, :] > 0)
    cross = [(p.encoder_attn.k(enc_out), p.encoder_attn.v(enc_out))
             for p in dec.layers]
    cache_k = torch.zeros(cfg.decoder_layers, b, max_len, d,
                          dtype=enc_out.dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    kpos = torch.arange(max_len, device=dev)
    tok = torch.full((b,), cfg.decoder_start_token_id, dtype=torch.int64,
                     device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    toks = torch.full((b, max_new_tokens), cfg.eos_token_id,
                      dtype=torch.int64, device=dev)
    for pos in range(max_new_tokens):
        x = (model.text.shared[tok][:, None] * _embed_scale(cfg)
             + dec.embed_positions[pos + 2][None, None])
        x = _ln(dec.layernorm_embedding, x)
        sbias = _bias((kpos <= pos)[None, None, None, :])
        for i, p in enumerate(dec.layers):
            sa = p.self_attn
            cache_k[i, :, pos] = sa.k(x)[:, 0]
            cache_v[i, :, pos] = sa.v(x)[:, 0]
            h = sa.o(_mha(sa.q(x) * hd ** -0.5, cache_k[i], cache_v[i], nh,
                          bias=sbias, scale=1.0))
            x = _ln(p.self_attn_layer_norm, x + h)
            ea = p.encoder_attn
            h = ea.o(_mha(ea.q(x) * hd ** -0.5, *cross[i], nh, bias=xbias,
                          scale=1.0))
            x = _ln(p.encoder_attn_layer_norm, x + h)
            x = _bart_ffn(p, x)
        nxt = torch.argmax(_logits(model, x[:, 0]).float(), dim=-1)
        if pos == 0 and cfg.forced_bos_token_id is not None:
            nxt = torch.full_like(nxt, cfg.forced_bos_token_id)
        nxt = torch.where(done, torch.full_like(nxt, cfg.eos_token_id), nxt)
        done = done | (nxt == cfg.eos_token_id)
        toks[:, pos] = nxt
        tok = nxt
    return toks


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------

def hf_names(cfg: FlorenceConfig) -> dict:
    """The port's ``state_dict`` key -> the published Florence-2 name of
    the same tensor (the layouts agree: torch's)."""
    out = {}
    for si, depth in enumerate(cfg.vision.depths):
        cp, ours = f"model.vision_tower.convs.{si}.", f"vision.stages.{si}."
        for n in ("conv.weight", "conv.bias", "norm.weight", "norm.bias"):
            out[f"{ours}conv_embed.{n}"] = cp + n
        for bi in range(depth):
            bp = f"model.vision_tower.blocks.{si}.{bi}."
            for half, hname, attn in (("spatial", "spatial_block",
                                       "window_attn"),
                                      ("channel", "channel_block",
                                       "channel_attn")):
                o = f"{ours}blocks.{bi}.{half}."
                h = f"{bp}{hname}."
                for a, t in (("conv", "conv1"), ("conv2", "conv2"),
                             ("norm1", "norm1"), ("norm2", "norm2"),
                             ("qkv", attn + ".qkv"), ("proj", attn + ".proj"),
                             ("fc1", "ffn.fc1"), ("fc2", "ffn.fc2")):
                    for leaf in ("weight", "bias"):
                        out[f"{o}{a}.{leaf}"] = f"{h}{t}.{leaf}"
    pp = "model.multi_modal_projector."
    out["projector.image_projection.weight"] = pp + "image_projection.weight"
    for leaf in ("weight", "bias"):
        out[f"projector.image_proj_norm.{leaf}"] = \
            f"{pp}image_proj_norm.{leaf}"
    for n in ("row_embeddings", "column_embeddings"):
        out[f"projector.{n}"] = f"{pp}image_position_embed.{n}.weight"
    lm = "model.language_model."
    out["text.shared"] = lm + "shared.weight"
    out["text.final_logits_bias"] = "final_logits_bias"
    for side, n, cross in (("encoder", cfg.text.encoder_layers, False),
                           ("decoder", cfg.text.decoder_layers, True)):
        out[f"text.{side}.embed_positions"] = \
            f"{lm}{side}.embed_positions.weight"
        for leaf in ("weight", "bias"):
            out[f"text.{side}.layernorm_embedding.{leaf}"] = \
                f"{lm}{side}.layernorm_embedding.{leaf}"
        for i in range(n):
            o, t = f"text.{side}.layers.{i}.", f"{lm}{side}.layers.{i}."
            attns = ("self_attn", "encoder_attn") if cross else ("self_attn",)
            for a in attns:
                for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                                     ("v", "v_proj"), ("o", "out_proj")):
                    for leaf in ("weight", "bias"):
                        out[f"{o}{a}.{ours}.{leaf}"] = \
                            f"{t}{a}.{theirs}.{leaf}"
            norms = ["self_attn_layer_norm", "final_layer_norm"] + (
                ["encoder_attn_layer_norm"] if cross else [])
            for m in norms + ["fc1", "fc2"]:
                for leaf in ("weight", "bias"):
                    out[f"{o}{m}.{leaf}"] = f"{t}{m}.{leaf}"
    return out


def convert_hf_state_dict(sd: dict, cfg: FlorenceConfig,
                          dtype: Optional[torch.dtype] = None) -> dict:
    """Published Florence-2 safetensors naming -> the ``state_dict`` of
    :class:`Florence2` (``shared`` from ``encoder.embed_tokens`` where the
    file has no ``shared``; a zero ``final_logits_bias`` where it has
    none)."""
    lm = "model.language_model."
    out = {}
    for ours, theirs in hf_names(cfg).items():
        if theirs == lm + "shared.weight" and theirs not in sd:
            theirs = lm + "encoder.embed_tokens.weight"
        if theirs == "final_logits_bias" and theirs not in sd:
            t = torch.zeros(cfg.text.vocab_size)
        else:
            t = torch.as_tensor(sd[theirs])
        if ours == "text.final_logits_bias":
            t = t.reshape(-1)
        out[ours] = t if dtype is None else t.to(dtype)
    return out


def load_hf_dir(path: str, *, device=None,
                dtype: torch.dtype = torch.bfloat16) -> Florence2:
    """:class:`Florence2` from a HF model directory, built on the meta
    device and assigned its weights on ``device`` (the card unless told
    the CPU) in ``dtype``."""
    from ..core.checkpoint import build_module

    hf_cfg, sd = read_hf_dir(path)
    cfg = config_from_hf(hf_cfg)
    return build_module(Florence2(cfg, device="meta", dtype=dtype),
                        convert_hf_state_dict(sd, cfg), "Florence-2",
                        resolve_device(device))
