"""LTX-Video 3D diffusion transformer (DiT).

Port of ``ltx_video_gpupoor_tpu/models/ltx/transformer3d.py``:
``LTXTransformerConfig``, ``init_params`` (:112), ``timestep_embedding``,
``_block_forward`` (:256-422: adaLN-single, qk RMS-norm, RoPE, self- and
cross-attention, the GELU FFN and its token-chunked form ``_ffn``
(:228), the STG skip strategies, the fused adaLN prologue tier, kernel
K5, :278-308 and :398-412, and the bounded-score tier, kernel K3,
:337), ``compute_freqs`` (:425) and ``forward`` (:442).

The parameter tree becomes modules whose attribute names are the JAX
keys (``core/from_jax.py`` relies on that); the per-layer ``lax.scan``
becomes a loop over ``blocks``. Every linear is an ``ops.quant.Linear``,
so ``quantize_params(model, mode="dynamic")`` moves the whole DiT onto kernel K2, and
attention runs through ``ops.attention`` (kernels K1, K3, K4, K6 by
mode). With ``LTXV_TPU_FUSED_PROLOGUE`` set, the norm, the modulation
and the q/k/v (and ``proj_in``) linears of a block run as kernel K5
under the gates of the JAX block. Activations run in the policy's
``compute_dtype``; modulation and the timestep path stay fp32.

TeaCache's ``previous_residual`` / ``compute`` / ``return_residual``
(:454-456, :529-551) skip the block stack on the host. The ``ulysses:``
branch (:337-349): under ``parallel/usp.py`` each rank holds a slice of
the tokens whose RoPE rows are their global ones, and the self-attention
runs ``parallel/ulysses.py`` (the cross-attention takes the base mode: q
rows against replicated context). Under tensor parallelism
(``parallel/sharding.py``) a block holds ``H/tp`` heads: the heads come
from ``to_q``'s (local) width, the q/k RMS norms all-reduce their sum of
squares, and AttentionSkip mixes in this rank's slice of the normed input.
Not ported: the rope-on-heads layout (an opt-in relayout of the TPU
path); see ROADMAP.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...core.dtypes import DEFAULT_POLICY, DtypePolicy
from ...ops import fused_prologue as _fp
from ...ops.attention import attention, attention_packed, parse_sp
from ...ops.norms import layer_norm, rms_norm
from ...ops.quant import Linear
from ...ops.rope import apply_rotary_emb, ltx_freqs_cis


@dataclasses.dataclass(frozen=True)
class LTXTransformerConfig:
    num_attention_heads: int = 32
    attention_head_dim: int = 64
    in_channels: int = 128
    out_channels: int = 128
    num_layers: int = 28
    cross_attention_dim: int = 2048
    caption_channels: int = 4096
    qk_norm: Optional[str] = "rms_norm"
    # static |logit| bound that selects the attention kernels' max-free
    # softmax (kernel K3; only with qk_norm). An empirical bound on
    # trained attention sharpness: logits beyond it tie at the bound.
    attention_score_bound: Optional[float] = None
    standardization_norm: str = "rms_norm"  # or "layer_norm"
    activation_fn: str = "gelu-approximate"  # or "geglu" / "gelu"
    norm_eps: float = 1e-6
    attention_bias: bool = True
    positional_embedding_theta: float = 10000.0
    positional_embedding_max_pos: tuple = (20, 2048, 2048)
    timestep_scale_multiplier: float = 1000.0
    ffn_mult: int = 4
    frequency_embedding_size: int = 256
    # token-chunked FFN (1 = off): bounds the 4x-wide intermediate
    ffn_chunks: int = 1

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def ffn_dim(self) -> int:
        return self.inner_dim * self.ffn_mult


class SkipLayerStrategy:
    AttentionSkip = "attention_skip"
    AttentionValues = "attention_values"
    Residual = "residual"
    TransformerBlock = "transformer_block"


class NormWeight(nn.Module):
    def __init__(self, dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype),
                                   requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: LTXTransformerConfig, **kw):
        super().__init__()
        d = cfg.inner_dim
        self.to_q = Linear(d, d, cfg.attention_bias, **kw)
        self.to_k = Linear(d, d, cfg.attention_bias, **kw)
        self.to_v = Linear(d, d, cfg.attention_bias, **kw)
        self.to_out = Linear(d, d, True, **kw)
        if cfg.qk_norm:
            self.q_norm = NormWeight(d, **kw)
            self.k_norm = NormWeight(d, **kw)

    # set by parallel/sharding.py on a tensor-parallel rank
    tp = None

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        mod = getattr(self, name, None)
        return x if mod is None else rms_norm(x, mod.weight, eps=1e-5,
                                              tp=self.tp)


class FeedForward(nn.Module):
    def __init__(self, cfg: LTXTransformerConfig, **kw):
        super().__init__()
        mult = 2 if cfg.activation_fn == "geglu" else 1
        self.proj_in = Linear(cfg.inner_dim, cfg.ffn_dim * mult, **kw)
        self.proj_out = Linear(cfg.ffn_dim, cfg.inner_dim, **kw)

    def forward(self, activation_fn: str, x: torch.Tensor,
                chunks: int = 1) -> torch.Tensor:
        """The FFN, over ``chunks`` token chunks if more than one (the
        JAX ``_ffn``: the tokens are padded to a multiple of the count)."""
        if chunks <= 1:
            return self.activate_project(activation_fn, self.proj_in(x))
        s = x.shape[1]
        pad = (-s) % chunks
        xp = F.pad(x, (0, 0, 0, pad)) if pad else x
        out = torch.cat([
            self.activate_project(activation_fn, self.proj_in(c))
            for c in xp.chunk(chunks, dim=1)], dim=1)
        return out[:, :s] if pad else out

    def activate_project(self, activation_fn: str,
                         h: torch.Tensor) -> torch.Tensor:
        """Activation and ``proj_out`` on the output of ``proj_in``."""
        if activation_fn == "geglu":
            h, gate = h.chunk(2, dim=-1)
            h = h * F.gelu(gate)
        elif activation_fn == "gelu-approximate":
            h = F.gelu(h, approximate="tanh")
        elif activation_fn == "gelu":
            h = F.gelu(h)
        else:
            raise ValueError(activation_fn)
        return self.proj_out(h)


def _grouped(x: torch.Tensor, vals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """View ``x [B, S, D]`` as ``[B, G, S/G, D]`` against per-group values
    ``[B, G, D]`` (the JAX package repeats the values over tokens instead,
    ``_broadcast_groups``; same numbers)."""
    b, s, d = x.shape
    g = vals.shape[1]
    if s % g:
        raise ValueError(f"{s} tokens do not split into {g} groups")
    return x.reshape(b, g, s // g, d), vals[:, :, None]


def _modulate(x, scale, shift):
    xg, sc = _grouped(x, scale)
    return (xg * (1 + sc) + shift[:, :, None]).reshape(x.shape)


def _gated(gate, x):
    xg, gt = _grouped(x, gate)
    return (gt * xg).reshape(x.shape)


class Block(nn.Module):
    def __init__(self, cfg: LTXTransformerConfig, **kw):
        super().__init__()
        self.cfg = cfg
        self.scale_shift_table = nn.Parameter(
            torch.empty(6, cfg.inner_dim, device=kw.get("device"),
                        dtype=kw.get("dtype")), requires_grad=False)
        self.attn1 = Attention(cfg, **kw)
        self.attn2 = Attention(cfg, **kw)
        self.ff = FeedForward(cfg, **kw)

    def _std_norm(self, x):
        if self.cfg.standardization_norm == "rms_norm":
            return rms_norm(x, eps=self.cfg.norm_eps)
        return layer_norm(x, eps=self.cfg.norm_eps)

    def forward(
        self,
        x: torch.Tensor,                  # [B, S, D]
        context: torch.Tensor,            # [B, Sc, D]
        kv_seg: torch.Tensor,             # [B, Sc] int32, 0 = padding
        q_seg: torch.Tensor,              # [B, S] int32 ones
        ada: torch.Tensor,                # [B, G, 6, D] fp32
        freqs: tuple[torch.Tensor, torch.Tensor],
        skip_mask: Optional[torch.Tensor],  # [B] 1 = keep; None = all keep
        skip_strategy: Optional[str],
        attn_mode: str,
    ) -> torch.Tensor:
        cfg = self.cfg
        b, s, d = x.shape
        hd = cfg.attention_head_dim
        # this rank's heads (all of them unless tensor-parallel)
        heads = self.attn1.to_q.d_out // hd
        ada_v = self.scale_shift_table.float()[None, None] + ada
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = [
            ada_v[:, :, i].to(x.dtype) for i in range(6)]
        sb = cfg.attention_score_bound if cfg.qk_norm else None
        original_x = x

        # the fused adaLN prologue tier (opt-in): norm + modulate +
        # activation quantizer + the int8 q/k/v and proj_in products as
        # kernel K5. AttentionSkip needs h itself, so it stays unfused.
        g = ada.shape[1]
        use_fused = (
            _fp.enabled_mode() is not None
            and cfg.standardization_norm == "rms_norm"
            and not (skip_mask is not None
                     and skip_strategy == SkipLayerStrategy.AttentionSkip)
            and _fp.supports([self.attn1.to_q, self.attn1.to_k,
                              self.attn1.to_v], s, g))

        # self-attention
        a1 = self.attn1
        if use_fused:
            qkv = _fp.apply_fused(x, ada_v[:, :, 1], ada_v[:, :, 0],
                                  [a1.to_q, a1.to_k, a1.to_v],
                                  eps=cfg.norm_eps)
            q, k, v = qkv.chunk(3, dim=-1)
            q = a1.norm("q_norm", q)
            k = a1.norm("k_norm", k)
            h = None
        else:
            h = _modulate(self._std_norm(x), scale_msa, shift_msa)
            q = a1.norm("q_norm", a1.to_q(h))
            k = a1.norm("k_norm", a1.to_k(h))
            v = a1.to_v(h)
        cos, sin = freqs
        if a1.tp is not None:
            # the tables span the packed heads: this rank's slice
            cos, sin = a1.tp.local(cos), a1.tp.local(sin)
        q = apply_rotary_emb(q, cos, sin)
        k = apply_rotary_emb(k, cos, sin)
        base_mode, sp_axis = parse_sp(attn_mode)
        if sp_axis is not None:
            # USP: tokens sequence-sharded over sp_axis (parallel/usp.py);
            # RoPE above used this shard's GLOBAL coordinates, so only the
            # attention itself needs the exchange
            from ...parallel.ulysses import ulysses_attention

            def to_heads(t):
                return t.reshape(b, s, heads, hd).transpose(1, 2)

            attn_raw = ulysses_attention(
                to_heads(q), to_heads(k), to_heads(v), axis_name=sp_axis,
                attn_mode=base_mode, score_bound=sb,
            ).transpose(1, 2).reshape(b, s, heads * hd)
        else:
            attn_raw = attention_packed(q, k, v, heads, mode=base_mode,
                                        score_bound=sb)
        if skip_mask is not None:
            m = skip_mask.to(x.dtype)[:, None, None]
            if skip_strategy == SkipLayerStrategy.AttentionSkip:
                if a1.tp is not None:
                    h = a1.tp.local(h)
                attn_raw = attn_raw * m + h * (1 - m)
            elif skip_strategy == SkipLayerStrategy.AttentionValues:
                attn_raw = attn_raw * m + v * (1 - m)
        x = x + _gated(gate_msa, a1.to_out(attn_raw))

        # cross-attention
        a2 = self.attn2
        sc = context.shape[1]
        q = a2.norm("q_norm", a2.to_q(x))
        k = a2.norm("k_norm", a2.to_k(context))
        v = a2.to_v(context)
        ca = attention(
            q.reshape(b, s, heads, hd).transpose(1, 2),
            k.reshape(b, sc, heads, hd).transpose(1, 2),
            v.reshape(b, sc, heads, hd).transpose(1, 2),
            q_seg, kv_seg, mode=base_mode, score_bound=sb,
        )
        x = x + a2.to_out(ca.transpose(1, 2).reshape(b, s, heads * hd))

        # feed-forward
        if (use_fused and cfg.ffn_chunks <= 1
                and cfg.activation_fn in ("geglu", "gelu-approximate", "gelu")
                and _fp.supports([self.ff.proj_in], s, g)):
            hp = _fp.apply_fused(x, ada_v[:, :, 4], ada_v[:, :, 3],
                                 [self.ff.proj_in], eps=cfg.norm_eps)
            ffn = self.ff.activate_project(cfg.activation_fn, hp)
        else:
            h = _modulate(self._std_norm(x), scale_mlp, shift_mlp)
            ffn = self.ff(cfg.activation_fn, h, cfg.ffn_chunks)
        x = x + _gated(gate_mlp, ffn)

        if skip_mask is not None and \
                skip_strategy == SkipLayerStrategy.TransformerBlock:
            m = skip_mask.to(x.dtype)[:, None, None]
            x = x * m + original_x * (1 - m)
        return x


class AdaLNSingle(nn.Module):
    def __init__(self, cfg: LTXTransformerConfig, **kw):
        super().__init__()
        d = cfg.inner_dim
        self.emb_linear_1 = Linear(cfg.frequency_embedding_size, d, **kw)
        self.emb_linear_2 = Linear(d, d, **kw)
        self.linear = Linear(d, 6 * d, **kw)


class CaptionProjection(nn.Module):
    def __init__(self, cfg: LTXTransformerConfig, **kw):
        super().__init__()
        self.linear_1 = Linear(cfg.caption_channels, cfg.inner_dim, **kw)
        self.linear_2 = Linear(cfg.inner_dim, cfg.inner_dim, **kw)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding ``[cos | sin]`` (diffusers, flip_sin_to_cos)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def compute_freqs(cfg: LTXTransformerConfig, indices_grid: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Step-invariant RoPE tables for :meth:`LTXTransformer3D.forward`."""
    d = cfg.inner_dim
    return ltx_freqs_cis(
        indices_grid, d, theta=cfg.positional_embedding_theta,
        max_pos=cfg.positional_embedding_max_pos,
        half_layout=(d % 6) % 2 == 0)


class LTXTransformer3D(nn.Module):
    """The denoiser: ``forward`` returns the velocity ``[B, S, C_out]``."""

    def __init__(self, cfg: LTXTransformerConfig,
                 policy: DtypePolicy = DEFAULT_POLICY, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = policy.compute_dtype
        kw = dict(device=device, dtype=policy.param_dtype)
        d = cfg.inner_dim
        self.patchify_proj = Linear(cfg.in_channels, d, **kw)
        self.adaln = AdaLNSingle(cfg, **kw)
        self.caption_projection = CaptionProjection(cfg, **kw)
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.scale_shift_table = nn.Parameter(
            torch.empty(2, d, device=device, dtype=policy.param_dtype),
            requires_grad=False)
        self.proj_out = Linear(d, cfg.out_channels, **kw)

    def forward(
        self,
        latents: torch.Tensor,        # [B, S, C_in] patchified tokens
        indices_grid: torch.Tensor,   # [B, 3, S] fractional coords
        timestep: torch.Tensor,       # [B] or [B, G] in [0, 1]
        caption: torch.Tensor,        # [B, Sc, caption_channels]
        caption_mask: Optional[torch.Tensor] = None,   # [B, Sc]
        skip_layer_mask: Optional[torch.Tensor] = None,  # [L, B] 1 = keep
        skip_layer_strategy: Optional[str] = None,
        attn_mode: str = "auto",
        freqs: Optional[tuple] = None,
        previous_residual: Optional[torch.Tensor] = None,  # [B, S, D]
        compute: bool = True,
        return_residual: bool = False,
        remat: bool = False,
    ):
        """The velocity ``[B, S, C_out]`` (or ``(velocity, residual)`` with
        ``return_residual``). TeaCache (JAX :454-456, :529-551): with a
        ``previous_residual`` and ``compute=False`` the block stack is
        skipped, so the step launches no block, and the previous step's
        block-stack delta is added to this step's embedding; the residual
        returned is ``x - x_in`` as the JAX function computes it.
        ``remat`` (the trainer's, under autograd): each block is a
        ``torch.utils.checkpoint`` segment, which keeps only its input and
        recomputes the rest in the backward. The JAX trainer wraps the
        whole forward in one ``jax.checkpoint`` instead; the function and
        its gradients are the same, and here only one block's residuals
        (the ``xla`` tier's fp32 scores) live at a time."""
        cfg = self.cfg
        d = cfg.inner_dim
        b, s, _ = latents.shape
        dev = latents.device
        x = self.patchify_proj(latents.to(self.compute_dtype))

        t = torch.as_tensor(timestep, dtype=torch.float32, device=dev)
        if t.dim() == 1:
            t = t[:, None]
        t = t * cfg.timestep_scale_multiplier
        g = t.shape[1]

        ada_mod = self.adaln
        emb = timestep_embedding(t.reshape(-1), cfg.frequency_embedding_size)
        emb = F.silu(ada_mod.emb_linear_1(emb))
        embedded = ada_mod.emb_linear_2(emb)                     # [B*G, D]
        ada = ada_mod.linear(F.silu(embedded))
        ada = ada.reshape(b, g, 6, d).float()
        embedded = embedded.reshape(b, g, d).float()

        cp = self.caption_projection
        ctx = cp.linear_1(caption.to(x.dtype))
        ctx = cp.linear_2(F.gelu(ctx, approximate="tanh"))

        if freqs is None:
            freqs = compute_freqs(cfg, indices_grid)

        sc = ctx.shape[1]
        kv_seg = (caption_mask.to(device=dev, dtype=torch.int32)
                  if caption_mask is not None
                  else torch.ones(b, sc, dtype=torch.int32, device=dev))
        q_seg = torch.ones(b, s, dtype=torch.int32, device=dev)
        if skip_layer_mask is not None:
            skip_layer_mask = torch.as_tensor(skip_layer_mask).cpu()
        x_in = x
        if previous_residual is None or compute:
            for i, blk in enumerate(self.blocks):
                # a layer whose streams all keep needs no blend (x*1 + y*0
                # == x)
                skip = None
                if skip_layer_mask is not None and skip_layer_strategy \
                        and bool((skip_layer_mask[i] != 1).any()):
                    skip = skip_layer_mask[i].to(dev)
                args = (x, ctx, kv_seg.contiguous(), q_seg, ada, freqs, skip,
                        skip_layer_strategy, attn_mode)
                if remat and torch.is_grad_enabled():
                    # the blocks draw no random numbers
                    x = checkpoint(blk, *args, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = blk(*args)
        else:
            x = x + previous_residual.to(x.dtype)
        residual = x - x_in if return_residual else None

        table = self.scale_shift_table.float()
        vals = table[None, None] + embedded[:, :, None]      # [B, G, 2, D]
        shift = vals[:, :, 0].to(x.dtype)
        scale = vals[:, :, 1].to(x.dtype)
        x = _modulate(layer_norm(x, eps=1e-6), scale, shift)
        out = self.proj_out(x)
        if return_residual:
            return out, residual
        return out


@torch.no_grad()
def init_params(model: LTXTransformer3D, generator: torch.Generator
                ) -> LTXTransformer3D:
    """Random weights in the JAX ``init_params`` distribution: linear
    kernels N(0, 1/d_in), zero biases, unit norm weights, tables
    N(0, 1/d). Draws on the model's device from ``generator``."""
    d = model.cfg.inner_dim
    for mod in model.modules():
        if isinstance(mod, Linear) and not mod.quantized:
            w = mod.weight
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=w.device, dtype=w.dtype)
                    * mod.d_in ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith("scale_shift_table"):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=p.dtype) / d ** 0.5)
    return model
