"""Attention dispatch.

Port of ``ltx_video_gpupoor_tpu/ops/attention.py``: :func:`attention`
(:132) and :func:`attention_packed` (:254), same signatures. The
128-multiple padding (:172-191) is gone: kernel K1 masks its own ragged
edge. Modes ``auto`` and ``pallas`` resolve to K1's exact tier; every other
tier raises ``NotImplementedError`` naming its ROADMAP entry.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention

_TO_PORT = {
    "pallas_hp": "ROADMAP queue 2 K6 (head-packed kernel)",
    "pallas_int8": "ROADMAP queue 2 K4 (int8 QK tier)",
    "pallas_int8pv": "ROADMAP queue 2 K4 (int8 QK+PV tier)",
    "xla": "ROADMAP queue 1 step 2 (the port has no XLA tier; its plain "
           "version is ops.flash_attention.reference_attention)",
}


def resolve_mode(mode: str, score_bound: float | None = None) -> str:
    """``auto``/``pallas`` -> ``pallas`` (K1, exact); others raise."""
    if mode.startswith("ulysses:"):
        raise NotImplementedError(
            f"attention mode {mode!r}: sequence parallelism is ROADMAP "
            "queue 1 step 16")
    if score_bound is not None:
        raise NotImplementedError(
            "score_bound: the bounded-score tier is ROADMAP queue 2 K3")
    if mode in ("auto", "pallas"):
        return "pallas"
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
    resolve_mode(mode, score_bound)
    if q_segment_ids is not None:
        q_segment_ids = q_segment_ids.to(torch.int32).contiguous()
    if kv_segment_ids is not None:
        kv_segment_ids = kv_segment_ids.to(torch.int32).contiguous()
    return flash_attention(q, k, v, q_segment_ids, kv_segment_ids,
                           scale=scale, causal=causal)


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
    split is a strided view that K1 reads in place, and on the card its
    output keeps that layout, so neither transpose copies."""
    b, s, hd_total = q.shape
    d = hd_total // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    o = attention(split(q), split(k), split(v), scale=scale, mode=mode,
                  score_bound=score_bound)
    return o.transpose(1, 2).reshape(b, s, hd_total)
