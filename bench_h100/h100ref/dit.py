"""The LTX-Video DiT in float32: a frozen copy of the port's
``models/ltx/transformer3d.py`` forward (adaLN-single, qk RMS norm, RoPE,
self- and cross-attention, the tanh-GELU FFN, the AttentionValues STG
strategy), without the kernel tiers, sequence or tensor parallelism,
TeaCache or the fused prologue. Parameter names and shapes are the port's,
so :mod:`h100bench.weights` fills both alike. The linears are the dynamic
int8 linear the configuration states (:class:`.common.Linear`), one block
resident in float32 at a time while it is drawn and quantized.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from h100bench import weights

from .common import (Linear, apply_rotary, attention, layer_norm, ltx_freqs,
                     rms_norm, timestep_embedding)


class NormWeight(nn.Module):
    def __init__(self, dim, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device),
                                   requires_grad=False)


class Attention(nn.Module):
    def __init__(self, d, *, device=None):
        super().__init__()
        self.to_q = Linear(d, d, device=device)
        self.to_k = Linear(d, d, device=device)
        self.to_v = Linear(d, d, device=device)
        self.to_out = Linear(d, d, device=device)
        self.q_norm = NormWeight(d, device=device)
        self.k_norm = NormWeight(d, device=device)


class FeedForward(nn.Module):
    def __init__(self, d, ffn, *, device=None):
        super().__init__()
        self.proj_in = Linear(d, ffn, device=device)
        self.proj_out = Linear(ffn, d, device=device)


def _modulate(x, scale, shift):
    b, s, d = x.shape
    g = scale.shape[1]
    xg = x.reshape(b, g, s // g, d)
    return (xg * (1 + scale[:, :, None]) + shift[:, :, None]).reshape(x.shape)


def _gated(gate, x):
    b, s, d = x.shape
    g = gate.shape[1]
    return (gate[:, :, None] * x.reshape(b, g, s // g, d)).reshape(x.shape)


class Block(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
        self.scale_shift_table = nn.Parameter(
            torch.empty(6, d, device=device), requires_grad=False)
        self.attn1 = Attention(d, device=device)
        self.attn2 = Attention(d, device=device)
        self.ff = FeedForward(d, d * cfg.get("ffn_mult", 4), device=device)

    def forward(self, x, ctx, ada, freqs, skip):
        """``skip`` ``[B]`` (1 keep, 0 the perturbed stream) or None."""
        cfg = self.cfg
        b, s, d = x.shape
        heads, hd = cfg["num_attention_heads"], cfg["attention_head_dim"]
        eps = cfg.get("norm_eps", 1e-6)
        ada_v = self.scale_shift_table[None, None] + ada
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = [
            ada_v[:, :, i] for i in range(6)]

        def to_heads(t):
            return t.reshape(b, t.shape[1], heads, hd).transpose(1, 2)

        a1 = self.attn1
        h = _modulate(rms_norm(x, eps=eps), sc_msa, sh_msa)
        q = rms_norm(a1.to_q(h), a1.q_norm.weight, eps=1e-5)
        k = rms_norm(a1.to_k(h), a1.k_norm.weight, eps=1e-5)
        v = a1.to_v(h)
        cos, sin = freqs
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        o = attention(to_heads(q), to_heads(k), to_heads(v))
        o = o.transpose(1, 2).reshape(b, s, d)
        if skip is not None:
            m = skip[:, None, None]
            o = o * m + v * (1 - m)
        x = x + _gated(g_msa, a1.to_out(o))

        a2 = self.attn2
        q = rms_norm(a2.to_q(x), a2.q_norm.weight, eps=1e-5)
        k = rms_norm(a2.to_k(ctx), a2.k_norm.weight, eps=1e-5)
        v = a2.to_v(ctx)
        o = attention(to_heads(q), to_heads(k), to_heads(v))
        x = x + a2.to_out(o.transpose(1, 2).reshape(b, s, d))

        h = _modulate(rms_norm(x, eps=eps), sc_mlp, sh_mlp)
        ffn = self.ff.proj_out(F.gelu(self.ff.proj_in(h), approximate="tanh"))
        return x + _gated(g_mlp, ffn)


class AdaLNSingle(nn.Module):
    def __init__(self, d, freq_dim, *, device=None):
        super().__init__()
        self.emb_linear_1 = Linear(freq_dim, d, device=device)
        self.emb_linear_2 = Linear(d, d, device=device)
        self.linear = Linear(d, 6 * d, device=device)


class CaptionProjection(nn.Module):
    def __init__(self, cap, d, *, device=None):
        super().__init__()
        self.linear_1 = Linear(cap, d, device=device)
        self.linear_2 = Linear(d, d, device=device)


class Outer(nn.Module):
    """The DiT's tensors outside its blocks."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
        self.patchify_proj = Linear(cfg["in_channels"], d, device=device)
        self.adaln = AdaLNSingle(d, cfg.get("frequency_embedding_size", 256),
                                 device=device)
        self.caption_projection = CaptionProjection(
            cfg["caption_channels"], d, device=device)
        self.scale_shift_table = nn.Parameter(
            torch.empty(2, d, device=device), requires_grad=False)
        self.proj_out = Linear(d, cfg["out_channels"], device=device)


def _quantize(module):
    for mod in module.modules():
        if isinstance(mod, Linear):
            mod.quantize_()
    return module


class DiT:
    """The whole DiT, drawn from ``seed`` group by group, its linears
    quantized as drawn."""

    def __init__(self, cfg, seed, device):
        self.cfg = cfg
        self.outer = _quantize(weights.fill(Outer(cfg, device=device), seed,
                                            "dit.outer"))
        self.blocks = [
            _quantize(weights.fill(Block(cfg, device=device), seed,
                                   f"dit.block.{i}"))
            for i in range(cfg["num_layers"])]

    def freqs(self, coords):
        cfg = self.cfg
        d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
        return ltx_freqs(coords, d, cfg.get("positional_embedding_theta",
                                            10000.0),
                         cfg.get("positional_embedding_max_pos",
                                 (20, 2048, 2048)))

    @torch.no_grad()
    def __call__(self, latents, timestep, caption, freqs, skip_layer_mask):
        """The velocity ``[B, S, C]``; ``timestep`` ``[B, G]``,
        ``skip_layer_mask`` ``[L, B]`` or None."""
        cfg, o = self.cfg, self.outer
        b, s, _ = latents.shape
        d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
        x = o.patchify_proj(latents)
        t = timestep.float() * cfg.get("timestep_scale_multiplier", 1000.0)
        g = t.shape[1]
        emb = timestep_embedding(t.reshape(-1),
                                 cfg.get("frequency_embedding_size", 256))
        emb = F.silu(o.adaln.emb_linear_1(emb))
        embedded = o.adaln.emb_linear_2(emb)
        ada = o.adaln.linear(F.silu(embedded)).reshape(b, g, 6, d)
        embedded = embedded.reshape(b, g, d)
        cp = o.caption_projection
        ctx = cp.linear_2(F.gelu(cp.linear_1(caption), approximate="tanh"))
        for i, blk in enumerate(self.blocks):
            skip = None
            if skip_layer_mask is not None and bool(
                    (skip_layer_mask[i] != 1).any()):
                skip = skip_layer_mask[i].to(x.device).float()
            x = blk(x, ctx, ada, freqs, skip)
        vals = o.scale_shift_table[None, None] + embedded[:, :, None]
        x = _modulate(layer_norm(x, eps=1e-6), vals[:, :, 1], vals[:, :, 0])
        return o.proj_out(x)
