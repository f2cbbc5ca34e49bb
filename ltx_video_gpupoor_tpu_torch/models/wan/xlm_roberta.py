"""XLM-Roberta, the text tower of Wan's CLIP.

Port of ``ltx_video_gpupoor_tpu/models/wan/xlm_roberta.py`` (:23-154):
``XLMRobertaConfig`` (XLM-Roberta large: 24 layers, dim 1024, 16 heads of
64, 514 positions), ``encode`` (token, type and position embeddings with
positions ``pad_id + cumsum(mask)``, post-norm blocks) and
``encode_with_head`` (a masked mean pool and the two-layer GELU head of
``XLMRobertaWithHead``). The parameter tree becomes modules whose
attribute names are the JAX keys, so ``core/from_jax.py::state_dict``
carries JAX's weights over (there is no checkpoint loader: the JAX
package has no converter for this tower either). Attention goes through
``ops.attention.attention`` with the pad mask as kv segment ids: at head
dim 64 ``auto`` resolves to the exact tier, kernel K1 with segments on
the card. The linears are dense (``x @ kernel + bias``, as JAX's
``_lin``); activations run in the policy's ``compute_dtype``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ...core.dtypes import DEFAULT_POLICY, DtypePolicy
from ...ops.attention import attention
from ...ops.norms import layer_norm
from ...ops.quant import Linear


@dataclasses.dataclass(frozen=True)
class XLMRobertaConfig:
    vocab_size: int = 250002
    max_seq_len: int = 514
    type_size: int = 1
    pad_id: int = 1
    dim: int = 1024
    num_heads: int = 16
    num_layers: int = 24
    post_norm: bool = True
    eps: float = 1e-5
    head_out_dim: int = 0  # > 0: XLMRobertaWithHead's projection


class _Norm(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d, **kw), requires_grad=False)


class _Attn(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        self.q = Linear(d, d, **kw)
        self.k = Linear(d, d, **kw)
        self.v = Linear(d, d, **kw)
        self.o = Linear(d, d, **kw)


class _MLP(nn.Module):
    def __init__(self, d_in, d_hidden, d_out, bias=True, **kw):
        super().__init__()
        self.fc1 = Linear(d_in, d_hidden, bias, **kw)
        self.fc2 = Linear(d_hidden, d_out, bias, **kw)


class _Block(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        self.attn = _Attn(d, **kw)
        self.norm1 = _Norm(d, **kw)
        self.ffn = _MLP(d, 4 * d, d, **kw)
        self.norm2 = _Norm(d, **kw)


class XLMRoberta(nn.Module):
    """``token_embedding [V, D]``, ``type_embedding``, ``pos_embedding
    [max_seq_len, D]``, ``norm``, ``blocks`` and, with ``head_out_dim``,
    ``head`` (two linears without bias)."""

    def __init__(self, cfg: XLMRobertaConfig,
                 policy: DtypePolicy = DEFAULT_POLICY, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = policy.compute_dtype
        kw = dict(device=device, dtype=policy.param_dtype)
        d = cfg.dim
        self.token_embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, d, **kw), requires_grad=False)
        self.type_embedding = nn.Parameter(
            torch.empty(cfg.type_size, d, **kw), requires_grad=False)
        self.pos_embedding = nn.Parameter(
            torch.empty(cfg.max_seq_len, d, **kw), requires_grad=False)
        self.norm = _Norm(d, **kw)
        self.blocks = nn.ModuleList(_Block(d, **kw)
                                    for _ in range(cfg.num_layers))
        if cfg.head_out_dim:
            self.head = _MLP(d, (d + cfg.head_out_dim) // 2, cfg.head_out_dim,
                             bias=False, **kw)


def _block(cfg: XLMRobertaConfig, p: _Block, x, kv_seg):
    b, s, d = x.shape
    n = cfg.num_heads
    hd = d // n

    def attn(h):
        q, k, v = (lin(h).reshape(b, s, n, hd).transpose(1, 2)
                   for lin in (p.attn.q, p.attn.k, p.attn.v))
        q_seg = torch.ones(b, s, dtype=torch.int32, device=x.device)
        out = attention(q, k, v, q_seg, kv_seg)
        return p.attn.o(out.transpose(1, 2).reshape(b, s, d))

    def ffn(h):
        return p.ffn.fc2(F.gelu(p.ffn.fc1(h), approximate="none"))

    if cfg.post_norm:
        x = layer_norm(x + attn(x), p.norm1.weight, p.norm1.bias, eps=cfg.eps)
        return layer_norm(x + ffn(x), p.norm2.weight, p.norm2.bias,
                          eps=cfg.eps)
    x = x + attn(layer_norm(x, p.norm1.weight, p.norm1.bias, eps=cfg.eps))
    return x + ffn(layer_norm(x, p.norm2.weight, p.norm2.bias, eps=cfg.eps))


@torch.no_grad()
def encode(model: XLMRoberta, ids: torch.Tensor) -> torch.Tensor:
    """ids ``[B, L]`` -> features ``[B, L, dim]`` in the compute dtype; a
    pad id neither attends nor is attended to."""
    cfg = model.cfg
    ids = ids.to(model.token_embedding.device)
    mask = (ids != cfg.pad_id).to(torch.int32)
    positions = cfg.pad_id + torch.cumsum(mask, dim=1) * mask
    x = (model.token_embedding[ids].float()
         + model.type_embedding[torch.zeros_like(ids)].float()
         + model.pos_embedding[positions].float())
    if cfg.post_norm:
        x = layer_norm(x, model.norm.weight, model.norm.bias, eps=cfg.eps)
    x = x.to(model.compute_dtype)
    kv_seg = mask.contiguous()
    for blk in model.blocks:
        x = _block(cfg, blk, x, kv_seg)
    if not cfg.post_norm:
        x = layer_norm(x, model.norm.weight, model.norm.bias, eps=cfg.eps)
    return x


@torch.no_grad()
def encode_with_head(model: XLMRoberta, ids: torch.Tensor) -> torch.Tensor:
    """``XLMRobertaWithHead``: the masked mean of :func:`encode`'s
    features through the GELU head -> ``[B, head_out_dim]``."""
    if not model.cfg.head_out_dim:
        raise ValueError("encode_with_head needs head_out_dim > 0")
    x = encode(model, ids)
    mask = (ids.to(x.device) != model.cfg.pad_id).to(x.dtype)[..., None]
    pooled = (x * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)
    h = F.gelu(model.head.fc1(pooled), approximate="none")
    return model.head.fc2(h)


@torch.no_grad()
def init_params(model: XLMRoberta, generator: torch.Generator) -> XLMRoberta:
    """Random weights in the JAX ``init_params`` distribution: linears
    N(0, 1/d_in) with zero biases, the embeddings N(0, 0.02**2), unit
    norms. Draws on the model's device from ``generator``."""
    def randn(t):
        return torch.randn(t.shape, generator=generator, device=t.device,
                           dtype=t.dtype)

    for mod in model.modules():
        if isinstance(mod, Linear) and not mod.quantized:
            mod.weight.copy_(randn(mod.weight) * mod.d_in ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
    for p in (model.token_embedding, model.type_embedding,
              model.pos_embedding):
        p.copy_(randn(p) * 0.02)
    return model
