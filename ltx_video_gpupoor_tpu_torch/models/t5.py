"""T5 / UMT5 text encoder.

Port of ``ltx_video_gpupoor_tpu/models/t5.py``: ``T5Config``, ``T5_XXL``
(:45, google/t5-v1.1-xxl with one shared relative-position bias),
``UMT5_XXL`` (:43, google/umt5-xxl with per-layer position biases, the
Wan text encoder), ``relative_position_bucket``, ``relative_bias``,
``_attn`` (:134) and
``encode`` (:150). T5 attention stays plain PyTorch, as in JAX where it is
an einsum: it needs an additive position bias, and at 256 tokens it is a
small cost next to the DiT. Like the JAX encoder, activations are fp32
whatever the parameter dtype.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..ops.norms import rms_norm
from ..ops.quant import Linear


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    shared_pos: bool = False  # False = UMT5 (per-layer), True = T5 v1.1
    max_dist: int = 128


UMT5_XXL = T5Config()
T5_XXL = T5Config(vocab_size=32128, shared_pos=True)


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int = 32,
                             max_dist: int = 128,
                             bidirectional: bool = True) -> torch.Tensor:
    if bidirectional:
        half = num_buckets // 2
        rel_buckets = (rel_pos > 0).to(torch.int32) * half
        rel_pos = rel_pos.abs()
        nb = half
    else:
        rel_buckets = torch.zeros_like(rel_pos)
        rel_pos = -torch.clamp(rel_pos, max=0)
        nb = num_buckets
    max_exact = nb // 2
    large = max_exact + (
        torch.log(torch.clamp(rel_pos, min=1).float() / max_exact)
        / math.log(max_dist / max_exact) * (nb - max_exact)
    ).to(torch.int32)
    large = torch.clamp(large, max=nb - 1)
    return rel_buckets + torch.where(rel_pos < max_exact, rel_pos, large)


def relative_bias(embedding: torch.Tensor, lq: int, lk: int,
                  num_buckets: int, max_dist: int) -> torch.Tensor:
    """``[num_buckets, H]`` embedding -> ``[1, H, Lq, Lk]`` additive bias."""
    dev = embedding.device
    rel = (torch.arange(lk, device=dev)[None, :]
           - torch.arange(lq, device=dev)[:, None])
    buckets = relative_position_bucket(rel, num_buckets, max_dist)
    return embedding[buckets.long()].permute(2, 0, 1)[None]


class _Attn(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        self.q = Linear(cfg.dim, cfg.dim_attn, False, **kw)
        self.k = Linear(cfg.dim, cfg.dim_attn, False, **kw)
        self.v = Linear(cfg.dim, cfg.dim_attn, False, **kw)
        self.o = Linear(cfg.dim_attn, cfg.dim, False, **kw)


class _FFN(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        self.gate = Linear(cfg.dim, cfg.dim_ffn, False, **kw)
        self.fc1 = Linear(cfg.dim, cfg.dim_ffn, False, **kw)
        self.fc2 = Linear(cfg.dim_ffn, cfg.dim, False, **kw)


class _Norm(nn.Module):
    def __init__(self, dim, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype),
                                   requires_grad=False)


class _Block(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        self.norm1 = _Norm(cfg.dim, **kw)
        self.attn = _Attn(cfg, **kw)
        self.norm2 = _Norm(cfg.dim, **kw)
        self.ffn = _FFN(cfg, **kw)
        if not cfg.shared_pos:
            self.pos_embedding = nn.Parameter(
                torch.empty(cfg.num_buckets, cfg.num_heads,
                            device=kw.get("device"), dtype=kw.get("dtype")),
                requires_grad=False)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, *, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.token_embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.dim, **kw), requires_grad=False)
        self.blocks = nn.ModuleList(_Block(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.norm = _Norm(cfg.dim, **kw)
        if cfg.shared_pos:
            self.pos_embedding = nn.Parameter(
                torch.empty(cfg.num_buckets, cfg.num_heads, **kw),
                requires_grad=False)


def _t5_gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def _attn(p: _Attn, x, mask_bias, pos_bias, num_heads, dim_attn):
    """T5 attention: no 1/sqrt(d) scaling, fp32 softmax, additive bias.
    Under tensor parallelism ``p`` holds a slice of the heads (``q``'s
    local width) and ``pos_bias`` those heads' rows."""
    b, s, _ = x.shape
    hd = dim_attn // num_heads
    num_heads = p.q.d_out // hd
    q = p.q(x).reshape(b, s, num_heads, hd)
    k = p.k(x).reshape(b, s, num_heads, hd)
    v = p.v(x).reshape(b, s, num_heads, hd)
    scores = torch.einsum("binc,bjnc->bnij", q.float(), k.float())
    scores = scores + pos_bias + mask_bias
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bnij,bjnc->binc", probs, v).reshape(b, s, -1)
    return p.o(out)


@torch.no_grad()
def encode(model: T5Encoder, ids: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """Contextual embeddings ``[B, S, dim]`` fp32 from ``[B, S]`` token ids
    and mask (1 = real token); padded positions are garbage, callers carry
    the mask as cross-attention segment ids."""
    cfg = model.cfg
    s = ids.shape[1]
    x = model.token_embedding[ids.long()].float()
    mask_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).float()
    shared = None
    if cfg.shared_pos:
        shared = relative_bias(model.pos_embedding.float(), s, s,
                               cfg.num_buckets, cfg.max_dist)
    for blk in model.blocks:
        pos = shared if shared is not None else relative_bias(
            blk.pos_embedding.float(), s, s, cfg.num_buckets, cfg.max_dist)
        h = rms_norm(x, blk.norm1.weight, eps=1e-6)
        x = x + _attn(blk.attn, h, mask_bias, pos, cfg.num_heads,
                      cfg.dim_attn)
        h = rms_norm(x, blk.norm2.weight, eps=1e-6)
        ff = blk.ffn.fc1(h) * _t5_gelu(blk.ffn.gate(h))
        x = x + blk.ffn.fc2(ff)
    return rms_norm(x, model.norm.weight, eps=1e-6)


@torch.no_grad()
def init_params(model: T5Encoder, generator: torch.Generator) -> T5Encoder:
    """Random weights in the JAX ``init_params`` distribution, drawn on the
    model's device in its dtype."""
    cfg = model.cfg

    def fill(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=p.dtype) * std)

    fill(model.token_embedding, 1.0)
    pos_std = (2 * cfg.num_buckets * cfg.num_heads) ** -0.5
    for blk in model.blocks:
        a, f = blk.attn, blk.ffn
        fill(a.q.weight, (cfg.dim * cfg.dim_attn) ** -0.5)
        fill(a.k.weight, cfg.dim ** -0.5)
        fill(a.v.weight, cfg.dim ** -0.5)
        fill(a.o.weight, (cfg.num_heads * cfg.dim_attn) ** -0.5)
        fill(f.gate.weight, cfg.dim ** -0.5)
        fill(f.fc1.weight, cfg.dim ** -0.5)
        fill(f.fc2.weight, cfg.dim_ffn ** -0.5)
        if not cfg.shared_pos:
            fill(blk.pos_embedding, pos_std)
    if cfg.shared_pos:
        fill(model.pos_embedding, pos_std)
    return model
