"""Attention dispatch.

Port of ``ltx_video_gpupoor_tpu/ops/attention.py``: :func:`resolve_mode`
(:85-129), :func:`attention` (:132) and :func:`attention_packed` (:254),
same signatures. ``auto`` follows the JAX package's TPU policy on every
device: with a ``score_bound`` the bounded-score tier of the exact kernel
(K3), else the exact tier (K1) at head dims up to 64 and the int8 QK+PV
tier (K4) at 128 and above or an unknown head dim. ``pallas_int8`` and
``pallas_int8pv`` run K4's two tiers; an explicit ``pallas_int8pv`` drops
the bound (:192-196), and ``pallas_int8`` with a bound raises, as the JAX
kernel has no such combination on the port's path. ``pallas_hp`` runs the
head-packed kernel (K6) from :func:`attention_packed` and is ``pallas``
for head-split callers (:162-165). :func:`set_attention_mode` (:63) and
the ``LTXV_TPU_ATTN`` environment variable (:40) pin what ``auto`` means
for the whole process, as the CLI's ``--attention`` does. The
128-multiple padding (:172-191,
:289-298) is gone: the kernels mask their own ragged edge. ``xla`` and
``ulysses:`` raise ``NotImplementedError`` naming their ROADMAP entry.
"""

from __future__ import annotations

import os

import torch

from .flash_attention import (
    flash_attention,
    flash_attention_hp,
    flash_attention_int8,
)

_TO_PORT = {
    "xla": "ROADMAP queue 1 step 2 (the port has no XLA tier; its plain "
           "version is ops.flash_attention.reference_attention)",
}
_VALID_MODES = ("auto", "pallas", "pallas_hp", "pallas_int8", "pallas_int8pv")


def _checked_mode(mode: str, what: str) -> str:
    if mode in _TO_PORT:
        raise NotImplementedError(f"{what}{mode!r}: {_TO_PORT[mode]}")
    if mode not in _VALID_MODES:
        raise ValueError(f"{what}{mode!r}: expected one of {_VALID_MODES}")
    return mode


# Process-wide override: what ``auto`` resolves through. From LTXV_TPU_ATTN,
# so a deployment can pin a tier without code; empty means unset.
_FORCED_MODE = _checked_mode(os.environ.get("LTXV_TPU_ATTN") or "auto",
                             "LTXV_TPU_ATTN=")


def set_attention_mode(mode: str) -> None:
    """Pin the tier that ``auto`` means in this process (the CLI's
    ``--attention``); ``"auto"`` hands the choice back to the policy."""
    global _FORCED_MODE
    _FORCED_MODE = _checked_mode(mode, "attention mode ")


def get_attention_mode() -> str:
    return _FORCED_MODE


def resolve_mode(mode: str, score_bound: float | None = None,
                 head_dim: int | None = None) -> str:
    """Resolve ``auto`` to a concrete tier, as the JAX package does on the
    TPU: ``pallas`` when a ``score_bound`` is given (the bounded tier, K3,
    which an int8 P cannot serve), else ``pallas`` (K1) for ``head_dim <=
    64`` and ``pallas_int8pv`` (K4) for larger or unknown head dims. Every
    other mode is returned as it is."""
    if mode.startswith("ulysses:"):
        raise NotImplementedError(
            f"attention mode {mode!r}: sequence parallelism is ROADMAP "
            "queue 1 step 15")
    if mode == "auto":
        mode = _FORCED_MODE
    if mode == "auto":
        if score_bound is not None:
            return "pallas"
        return ("pallas" if head_dim is not None and head_dim <= 64
                else "pallas_int8pv")
    if mode in _VALID_MODES:
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
    """Multi-head attention over ``[B, H, S, D]``; segment id 0 = padding.
    ``score_bound``: a static bound on the |logits| that the caller can
    vouch for (qk-normed attention); it selects the bounded tier (K3)."""
    mode = resolve_mode(mode, score_bound, head_dim=q.shape[-1])
    if mode == "pallas_hp":
        # hp serves head-packed callers (attention_packed) only
        mode = "pallas"
    if q_segment_ids is not None:
        q_segment_ids = q_segment_ids.to(torch.int32).contiguous()
    if kv_segment_ids is not None:
        kv_segment_ids = kv_segment_ids.to(torch.int32).contiguous()
    if mode == "pallas":
        return flash_attention(q, k, v, q_segment_ids, kv_segment_ids,
                               scale=scale, causal=causal,
                               score_bound=score_bound)
    if mode == "pallas_int8" and score_bound is not None:
        raise NotImplementedError(
            "pallas_int8 with a score_bound (int8 QK under the fixed "
            "offset): ROADMAP queue 1 step 12")
    # pallas_int8pv: int8 P needs the running max, so the bound is dropped
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
    """Self-attention over head-packed ``[B, S, H*D]`` tensors.
    ``pallas_hp`` takes the head-packed kernel (K6) when ``d`` is 64 or 128
    and no ``score_bound`` is set (at d=64 the JAX package also wants an
    even head count, and the port keeps that gate so that both take the
    same tier); q, k and v must then have one length. Every other case
    splits the heads: the split is a strided view that the kernels read in
    place, and on the card their output keeps that layout, so neither
    transpose copies."""
    b, s, hd_total = q.shape
    d = hd_total // heads
    mode = resolve_mode(mode, score_bound, head_dim=d)
    if (mode == "pallas_hp" and d in (64, 128) and score_bound is None
            and (d == 128 or heads % 2 == 0)):
        if k.shape[1] != s or v.shape[1] != s:
            raise ValueError(
                "attention_packed hp path requires q/k/v of equal length")
        return flash_attention_hp(q, k, v, heads=heads, scale=scale)

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    o = attention(split(q), split(k), split(v), scale=scale, mode=mode,
                  score_bound=score_bound)
    return o.transpose(1, 2).reshape(b, s, hd_total)
