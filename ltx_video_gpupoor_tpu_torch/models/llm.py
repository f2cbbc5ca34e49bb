"""Decoder-only LLM family (Llama-3.x / Qwen2.5): the prompt enhancer's
and the Wan prompt extender's language model.

Port of ``ltx_video_gpupoor_tpu/models/llm.py``: ``LLMConfig``,
``LLAMA_3_2_3B``, ``QWEN_2_5_3B``, ``config_from_hf`` (:42-103),
``rope_tables`` with the ``llama3`` rescaling and the M-RoPE sections
(:149-184), ``forward`` (:268) and ``generate`` (:302), and the HF
conversion ``convert_hf_state_dict``, ``read_hf_dir``, ``load_hf_dir``
(:415-481) on the port's own safetensors reader.

One config covers both families: Qwen2 is Llama plus attention-input
biases (``qkv_bias``). The parameter tree becomes modules whose attribute
names are the JAX keys (``token_embedding``, ``blocks.{i}.attn.q``,
``norm``, ``lm_head``), so ``core/from_jax.py::state_dict`` carries JAX's
weights over. The compute dtype follows the weights (bf16 serving, fp32
parity tests), as in JAX.

Numerics follow JAX: Q.K^T from the compute dtype with fp32 accumulation
into fp32 scores, an additive -1e9 bias, an fp32 softmax, probabilities
cast back for P.V (``:232-240``); no hand kernel (the JAX package reaches
no Pallas kernel here either). ``generate`` is a prefill that fills a
static KV cache ``[L, B, S + max_new, n_kv, hd]``, then single-token steps
against it in a Python loop over that one preallocated cache. Sampling:
greedy is ``argmax``; otherwise ``argmax(logits / T + gumbel_t)``, JAX's
``jax.random.categorical``, with the per-step Gumbel noise drawn from a
``torch.Generator`` or handed over (``gumbel=``), as the parity tests hand
over the noise JAX draws from its step keys.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import rms_norm
from ..ops.quant import Linear


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 128256
    dim: int = 3072
    num_layers: int = 28
    num_heads: int = 24
    num_kv_heads: int = 8
    ffn_dim: int = 8192
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    qkv_bias: bool = False          # True for Qwen2
    tie_embeddings: bool = True
    head_dim: Optional[int] = None  # defaults to dim // num_heads
    # "llama3" RoPE rescaling (Llama-3.1+ / 3.2); None = plain RoPE
    rope_scaling: Optional[str] = None
    rope_factor: float = 32.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_pos: int = 8192
    # Qwen2.5-VL multimodal RoPE: per-axis channel sections (t, h, w)
    # summing to hd/2; None = standard 1D RoPE
    mrope_section: Optional[tuple] = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.dim // self.num_heads


# unsloth/Llama-3.2-3B-Instruct (the LTX enhancer LLM)
LLAMA_3_2_3B = LLMConfig(rope_scaling="llama3")
# Qwen/Qwen2.5-3B-Instruct (the Wan prompt extender)
QWEN_2_5_3B = LLMConfig(
    vocab_size=151936, dim=2048, num_layers=36, num_heads=16,
    num_kv_heads=2, ffn_dim=11008, rope_theta=1000000.0, rms_eps=1e-6,
    qkv_bias=True,
)


def config_from_hf(hf: dict) -> LLMConfig:
    """Map a HF ``config.json`` dict (LlamaConfig / Qwen2Config fields)
    onto :class:`LLMConfig`."""
    arch = (hf.get("architectures") or [""])[0].lower()
    rs = hf.get("rope_scaling") or {}
    return LLMConfig(
        vocab_size=hf["vocab_size"],
        dim=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        ffn_dim=hf["intermediate_size"],
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-6),
        qkv_bias="qwen2" in arch,
        tie_embeddings=hf.get("tie_word_embeddings", False),
        head_dim=hf.get("head_dim"),
        rope_scaling=rs.get("rope_type") or rs.get("type"),
        rope_factor=rs.get("factor", 32.0),
        rope_low_freq_factor=rs.get("low_freq_factor", 1.0),
        rope_high_freq_factor=rs.get("high_freq_factor", 4.0),
        rope_original_max_pos=rs.get(
            "original_max_position_embeddings", 8192),
    )


class _Norm(nn.Module):
    def __init__(self, d, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, **kw), requires_grad=False)


class _Attn(nn.Module):
    def __init__(self, cfg: LLMConfig, **kw):
        super().__init__()
        hd, nh, nkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
        self.q = Linear(cfg.dim, nh * hd, cfg.qkv_bias, **kw)
        self.k = Linear(cfg.dim, nkv * hd, cfg.qkv_bias, **kw)
        self.v = Linear(cfg.dim, nkv * hd, cfg.qkv_bias, **kw)
        self.o = Linear(nh * hd, cfg.dim, False, **kw)


class _MLP(nn.Module):
    def __init__(self, cfg: LLMConfig, **kw):
        super().__init__()
        self.gate = Linear(cfg.dim, cfg.ffn_dim, False, **kw)
        self.up = Linear(cfg.dim, cfg.ffn_dim, False, **kw)
        self.down = Linear(cfg.ffn_dim, cfg.dim, False, **kw)


class _Block(nn.Module):
    def __init__(self, cfg: LLMConfig, **kw):
        super().__init__()
        self.input_norm = _Norm(cfg.dim, **kw)
        self.attn = _Attn(cfg, **kw)
        self.post_norm = _Norm(cfg.dim, **kw)
        self.mlp = _MLP(cfg, **kw)


class LLM(nn.Module):
    """``token_embedding [V, D]``, ``blocks``, ``norm`` and, without tied
    embeddings, ``lm_head`` (a linear ``D -> V``). One dtype for every
    weight; the activations run in it."""

    def __init__(self, cfg: LLMConfig, *, device=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.token_embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.dim, **kw), requires_grad=False)
        self.blocks = nn.ModuleList(_Block(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.norm = _Norm(cfg.dim, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.dim, cfg.vocab_size, False, **kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.token_embedding.dtype

    @property
    def device(self) -> torch.device:
        return self.token_embedding.device


@torch.no_grad()
def init_params(model: LLM, generator: torch.Generator) -> LLM:
    """Random weights in the JAX ``init_params`` distribution: linears
    N(0, 1/d_in), zero biases, the embedding N(0, 0.02**2), unit norms.
    Draws on the model's device from ``generator``."""
    for mod in model.modules():
        if isinstance(mod, Linear):
            w = mod.weight
            w.copy_(torch.randn(w.shape, generator=generator, device=w.device,
                                dtype=w.dtype) * mod.d_in ** -0.5)
    e = model.token_embedding
    e.copy_(torch.randn(e.shape, generator=generator, device=e.device,
                        dtype=e.dtype) * 0.02)
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def rope_tables(cfg: LLMConfig, positions: torch.Tensor):
    """cos/sin tables ``[..., hd]`` (fp32) in the HF half-split convention
    (cos duplicated over both halves), incl. the "llama3" frequency
    rescaling; ``positions [3, B, S]`` with ``mrope_section`` take the
    t/h/w axis per channel chunk."""
    hd = cfg.hd
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32,
                     device=positions.device) / hd))
    if cfg.rope_scaling == "llama3":
        wavelen = 2.0 * math.pi / inv_freq
        low_wl = cfg.rope_original_max_pos / cfg.rope_low_freq_factor
        high_wl = cfg.rope_original_max_pos / cfg.rope_high_freq_factor
        smooth = (cfg.rope_original_max_pos / wavelen
                  - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
        smoothed = ((1.0 - smooth) * inv_freq / cfg.rope_factor
                    + smooth * inv_freq)
        inv_freq = torch.where(
            wavelen > low_wl, inv_freq / cfg.rope_factor,
            torch.where(wavelen < high_wl, inv_freq, smoothed))
    ang = positions[..., None].to(torch.float32) * inv_freq  # [..., hd/2]
    if cfg.mrope_section is not None and positions.dim() == 3:
        parts, start = [], 0
        for i, sec in enumerate(cfg.mrope_section):
            parts.append(ang[i % 3, ..., start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)  # [B, S, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def _apply_rope(x, cos, sin):
    # x: [B, S, H, hd]; cos/sin: [S, hd] or [B, S, hd]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf = x.float()
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


def _attn(p: _Attn, cfg: LLMConfig, x, cos, sin, bias, cache=None,
          cache_pos=0):
    """GQA attention over the sequence itself (``cache`` None) or over a
    layer's static cache ``(k, v)`` of shape ``[B, max_len, nkv, hd]``,
    written at ``cache_pos`` first. ``bias`` broadcasts to
    ``[B, 1, S, K]``."""
    b, s, _ = x.shape
    hd, nh, nkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    q = _apply_rope(p.q(x).reshape(b, s, nh, hd), cos, sin)
    k = _apply_rope(p.k(x).reshape(b, s, nkv, hd), cos, sin)
    v = p.v(x).reshape(b, s, nkv, hd)
    if cache is not None:
        ck, cv = cache
        ck[:, cache_pos:cache_pos + s] = k
        cv[:, cache_pos:cache_pos + s] = v
        k, v = ck, cv
    rep = nh // nkv
    # head h reads kv head h // rep: group the query heads by kv head
    qg = q.reshape(b, s, nkv, rep, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]          # [B, nkv, 1, hd, K]
    scores = torch.matmul(qg.float(), kt.float()) * hd ** -0.5
    scores = scores + bias[:, :, None]              # [B, nkv, rep, S, K]
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v.permute(0, 2, 1, 3)[:, :, None])
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, nh * hd)
    return p.o(out)


def _block(p: _Block, cfg: LLMConfig, x, cos, sin, bias, cache=None,
           cache_pos=0):
    h = rms_norm(x, p.input_norm.weight, eps=cfg.rms_eps)
    x = x + _attn(p.attn, cfg, h, cos, sin, bias, cache, cache_pos)
    h = rms_norm(x, p.post_norm.weight, eps=cfg.rms_eps)
    return x + p.mlp.down(F.silu(p.mlp.gate(h)) * p.mlp.up(h))


def _logits(model: LLM, x):
    x = rms_norm(x, model.norm.weight, eps=model.cfg.rms_eps)
    if model.cfg.tie_embeddings:
        return F.linear(x, model.token_embedding.to(x.dtype))
    return model.lm_head(x)


def _causal_bias(mask: torch.Tensor, s: int, extra: int = 0):
    """``[B, 1, S, S + extra]`` fp32: 0 where a query sees a real key at or
    before it, -1e9 elsewhere (the ``extra`` cache slots past the prompt
    included)."""
    causal = torch.ones(s, s, dtype=torch.bool, device=mask.device).tril()
    keep = causal[None, None] & (mask[:, None, None, :] > 0)
    keep = F.pad(keep, (0, extra))
    return torch.zeros(keep.shape, device=mask.device).masked_fill(
        ~keep, -1e9)


def _inputs(model: LLM, ids, mask, positions, embeds):
    dev = model.device
    ids = ids.to(dev)
    b, s = ids.shape
    x = model.token_embedding[ids] if embeds is None else embeds.to(dev)
    x = x.to(model.dtype)
    mask = (torch.ones(b, s, dtype=torch.int32, device=dev) if mask is None
            else mask.to(dev))
    if positions is None:
        # HF convention for left-padded batches: positions count real tokens
        positions = torch.cumsum(mask, dim=1) - 1
    return ids, x, mask, positions.to(dev)


@torch.no_grad()
def forward(model: LLM, ids: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence causal forward -> logits ``[B, S, vocab]`` in the
    weights' dtype. ``mask [B, S]`` (1 = real, left-pad aware),
    ``positions [B, S]`` or ``[3, B, S]`` (M-RoPE), ``embeds [B, S, dim]``
    in place of the token embedding."""
    cfg = model.cfg
    ids, x, mask, positions = _inputs(model, ids, mask, positions, embeds)
    cos, sin = rope_tables(cfg, positions)
    bias = _causal_bias(mask, ids.shape[1])
    for blk in model.blocks:
        x = _block(blk, cfg, x, cos, sin, bias)
    return _logits(model, x)


def _sample(logits, temperature, gumbel_t, generator):
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if gumbel_t is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        gumbel_t = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits / temperature + gumbel_t.to(logits.device),
                        dim=-1)


@torch.no_grad()
def generate(model: LLM, ids: torch.Tensor, mask: torch.Tensor,
             max_new_tokens: int, eos_ids: tuple = (),
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             gumbel: Optional[torch.Tensor] = None,
             positions: Optional[torch.Tensor] = None,
             decode_pos0: Optional[torch.Tensor] = None,
             embeds: Optional[torch.Tensor] = None,
             return_logits: bool = False):
    """Prefill + single-token decode. ``ids [B, S]`` LEFT-padded, ``mask``
    1 = real token. Returns ``[B, max_new_tokens]`` int64; after an EOS a
    row repeats the first EOS id (callers truncate). ``temperature=0`` is
    greedy; otherwise ``gumbel [max_new_tokens, B, vocab]`` if given, else
    noise drawn from ``generator``. ``positions`` / ``decode_pos0`` /
    ``embeds`` serve the M-RoPE path: prefill positions, the first
    generated token's position per row (default: the real-token count),
    pre-scattered input embeddings. With ``return_logits`` also the
    ``[B, max_new_tokens, vocab]`` logits each token was drawn from (the
    cache's check against a full forward)."""
    cfg = model.cfg
    ids, x, mask, positions = _inputs(model, ids, mask, positions, embeds)
    dev = x.device
    b, s = ids.shape
    max_len = s + max_new_tokens
    cos, sin = rope_tables(cfg, positions)
    bias = _causal_bias(mask, s, max_new_tokens)
    cache_k = torch.zeros(cfg.num_layers, b, max_len, cfg.num_kv_heads,
                          cfg.hd, dtype=x.dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    for i, blk in enumerate(model.blocks):
        x = _block(blk, cfg, x, cos, sin, bias, (cache_k[i], cache_v[i]), 0)
    logits = _logits(model, x[:, -1:])[:, 0]

    if decode_pos0 is None:
        decode_pos0 = mask.sum(dim=1)
    decode_pos0 = torch.as_tensor(decode_pos0, device=dev)
    eos_fill = eos_ids[0] if eos_ids else 0
    kpos = torch.arange(max_len, device=dev)
    prompt_keep = F.pad(mask > 0, (0, max_new_tokens))
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    toks = torch.full((b, max_new_tokens), eos_fill, dtype=torch.int64,
                      device=dev)
    seen = []
    for step in range(max_new_tokens):
        if return_logits:
            seen.append(logits)
        tok = _sample(logits, temperature,
                      None if gumbel is None else gumbel[step], generator)
        tok = torch.where(done, torch.full_like(tok, eos_fill), tok)
        for e in eos_ids:
            done = done | (tok == e)
        toks[:, step] = tok
        if step + 1 == max_new_tokens:
            break          # the last token's logits are not needed
        emb = model.token_embedding[tok][:, None, :].to(x.dtype)
        c, sn = rope_tables(cfg, (decode_pos0 + step)[:, None])
        # attend to: the prompt's real tokens + the generated ones so far
        keep = (prompt_keep & (kpos < s)) | ((kpos >= s)
                                             & (kpos < s + step + 1))
        abias = torch.zeros(keep.shape, device=dev).masked_fill(
            ~keep, -1e9)[:, None, None, :]
        h = emb
        for i, blk in enumerate(model.blocks):
            h = _block(blk, cfg, h, c, sn, abias,
                       (cache_k[i], cache_v[i]), s + step)
        logits = _logits(model, h)[:, 0]
    return (toks, torch.stack(seen, dim=1)) if return_logits else toks


# ---------------------------------------------------------------------------
# HF checkpoint conversion
# ---------------------------------------------------------------------------

def hf_names(cfg: LLMConfig) -> dict:
    """The port's ``state_dict`` key -> the published HF Llama / Qwen2
    name of the same tensor (the layouts agree: torch's ``[out, in]``)."""
    out = {"token_embedding": "model.embed_tokens.weight",
           "norm.weight": "model.norm.weight"}
    for i in range(cfg.num_layers):
        pre, ours = f"model.layers.{i}.", f"blocks.{i}."
        for o, theirs in (("q", "q_proj"), ("k", "k_proj"),
                          ("v", "v_proj"), ("o", "o_proj")):
            out[f"{ours}attn.{o}.weight"] = f"{pre}self_attn.{theirs}.weight"
            if cfg.qkv_bias and o != "o":
                out[f"{ours}attn.{o}.bias"] = f"{pre}self_attn.{theirs}.bias"
        out[f"{ours}input_norm.weight"] = f"{pre}input_layernorm.weight"
        out[f"{ours}post_norm.weight"] = \
            f"{pre}post_attention_layernorm.weight"
        for o in ("gate", "up", "down"):
            out[f"{ours}mlp.{o}.weight"] = f"{pre}mlp.{o}_proj.weight"
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = "lm_head.weight"
    return out


def convert_hf_state_dict(sd: dict, cfg: LLMConfig,
                          dtype: Optional[torch.dtype] = None) -> dict:
    """A HF Llama/Qwen2 state dict (``model.layers.N.self_attn.q_proj.
    weight`` ...) -> the ``state_dict`` of :class:`LLM`: key renames and a
    cast (a tensor the file lacks is left to ``build_module`` to name)."""
    return {ours: torch.as_tensor(sd[theirs]) if dtype is None
            else torch.as_tensor(sd[theirs]).to(dtype)
            for ours, theirs in hf_names(cfg).items() if theirs in sd}


def read_hf_dir(path: str) -> tuple[dict, dict]:
    """(config dict, raw state dict) from a HF model directory:
    ``config.json`` + every safetensors shard, through the port's
    safetensors reader. Shared by the Llama/Qwen2, Qwen2.5-VL and
    Florence-2 loaders."""
    from ..core.checkpoint import load_safetensors

    with open(os.path.join(path, "config.json")) as fh:
        hf_cfg = json.load(fh)
    sd = {}
    for f in sorted(os.listdir(path)):
        if f.endswith(".safetensors"):
            tensors, _meta = load_safetensors(os.path.join(path, f))
            sd.update(tensors)
    return hf_cfg, sd


def load_hf_dir(path: str, *, device=None,
                dtype: torch.dtype = torch.bfloat16) -> LLM:
    """:class:`LLM` from a HF model directory, built on the meta device
    and assigned its weights on ``device`` (the card unless told the
    CPU) in ``dtype``."""
    from ..core.checkpoint import build_module

    hf_cfg, sd = read_hf_dir(path)
    cfg = config_from_hf(hf_cfg)
    return build_module(LLM(cfg, device="meta", dtype=dtype),
                        convert_hf_state_dict(sd, cfg), "LLM",
                        resolve_device(device))


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``: the card unless told otherwise;
    asking for the card without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass device='cpu' for the CPU)")
    return dev
