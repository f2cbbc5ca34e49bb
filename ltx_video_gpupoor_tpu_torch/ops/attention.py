"""Attention dispatch.

Port of ``ltx_video_gpupoor_tpu/ops/attention.py``: :func:`resolve_mode`
(:85-129), :func:`attention` (:132) and :func:`attention_packed` (:254),
same signatures. ``auto`` follows the JAX package's TPU policy on every
device: the exact tier (K1) at head dims up to 64, the int8 QK+PV tier
(K4) at 128 and above or an unknown head dim. ``pallas_int8`` and
``pallas_int8pv`` run K4's two tiers. The 128-multiple padding (:172-191)
is gone: the kernels mask their own ragged edge. Every other tier raises
``NotImplementedError`` naming its ROADMAP entry.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention, flash_attention_int8

_TO_PORT = {
    "pallas_hp": "ROADMAP queue 2 K6 (head-packed kernel)",
    "xla": "ROADMAP queue 1 step 2 (the port has no XLA tier; its plain "
           "version is ops.flash_attention.reference_attention)",
}
_K3 = "score_bound: the bounded-score tier is ROADMAP queue 2 K3"


def resolve_mode(mode: str, score_bound: float | None = None,
                 head_dim: int | None = None) -> str:
    """Resolve ``auto`` to a concrete tier, as the JAX package does on the
    TPU: ``pallas`` (K1) for ``head_dim <= 64``, ``pallas_int8pv`` (K4)
    for larger or unknown head dims. A ``score_bound`` asks for the
    bounded tier (K3), which raises, except under an explicit
    ``pallas_int8pv``, which drops the bound as in JAX."""
    if mode.startswith("ulysses:"):
        raise NotImplementedError(
            f"attention mode {mode!r}: sequence parallelism is ROADMAP "
            "queue 1 step 15")
    if mode == "auto":
        if score_bound is not None:
            raise NotImplementedError(_K3)
        return ("pallas" if head_dim is not None and head_dim <= 64
                else "pallas_int8pv")
    if mode in ("pallas", "pallas_int8"):
        if score_bound is not None:
            raise NotImplementedError(_K3)
        return mode
    if mode == "pallas_int8pv":
        return mode
    if mode in _TO_PORT:
        raise NotImplementedError(f"attention mode {mode!r}: {_TO_PORT[mode]}")
    raise ValueError(f"unknown attention mode {mode!r}")


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    causal: bool = False,
    mode: str = "auto",
    score_bound: float | None = None,
) -> torch.Tensor:
    """Multi-head attention over ``[B, H, S, D]``; segment id 0 = padding."""
    mode = resolve_mode(mode, score_bound, head_dim=q.shape[-1])
    if q_segment_ids is not None:
        q_segment_ids = q_segment_ids.to(torch.int32).contiguous()
    if kv_segment_ids is not None:
        kv_segment_ids = kv_segment_ids.to(torch.int32).contiguous()
    if mode == "pallas":
        return flash_attention(q, k, v, q_segment_ids, kv_segment_ids,
                               scale=scale, causal=causal)
    return flash_attention_int8(q, k, v, q_segment_ids, kv_segment_ids,
                                scale=scale, causal=causal,
                                pv_int8=mode == "pallas_int8pv")


def attention_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    *,
    scale: float | None = None,
    mode: str = "auto",
    score_bound: float | None = None,
) -> torch.Tensor:
    """Self-attention over head-packed ``[B, S, H*D]`` tensors. The head
    split is a strided view that the kernels read in place, and on the
    card K1's output keeps that layout, so neither transpose copies."""
    b, s, hd_total = q.shape
    d = hd_total // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    o = attention(split(q), split(k), split(v), scale=scale, mode=mode,
                  score_bound=score_bound)
    return o.transpose(1, 2).reshape(b, s, hd_total)
