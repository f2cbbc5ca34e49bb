"""Attention dispatch.

Port of ``ltx_video_gpupoor_tpu/ops/attention.py``: :func:`resolve_mode`
(:85-129), :func:`attention` (:132) and :func:`attention_packed` (:254),
same signatures. ``auto`` follows the JAX package's TPU policy on every
device: with a ``score_bound`` the bounded-score tier of the exact kernel
(K3), else the exact tier (K1) at head dims up to 64 and the int8 QK+PV
tier (K4) at 128 and above or an unknown head dim. ``pallas_int8`` and
``pallas_int8pv`` run K4's two tiers; an explicit ``pallas_int8pv`` drops
the bound (:192-196), and ``pallas_int8`` with a bound runs the int8 Q.K^T
under the fixed offset (K3q), as the JAX kernel does. ``pallas_hp`` runs the
head-packed kernel (K6) from :func:`attention_packed` and is ``pallas``
for head-split callers (:162-165). ``xla`` runs
:func:`~.flash_attention.reference_attention`, the plain fp32 attention,
on either device (:167-170; a ``score_bound`` is ignored there, as in
JAX). :func:`set_attention_mode` (:63) and
the ``LTXV_TPU_ATTN`` environment variable (:40) pin what ``auto`` means
for the whole process, as the CLI's ``--attention`` does. The
128-multiple padding (:172-191,
:289-298) is gone: the kernels mask their own ragged edge. ``ulysses:``
raises ``NotImplementedError`` naming its ROADMAP step. fp32 operands
(``FP32_POLICY``) take the same tiers through K1f, the fp32 kernel;
:func:`kernel_route` names the kernel a call launches.
"""

from __future__ import annotations

import os

import torch

from .flash_attention import (
    flash_attention,
    flash_attention_hp,
    flash_attention_int8,
    k1f_variant,
    reference_attention,
)

_VALID_MODES = ("auto", "pallas", "pallas_hp", "pallas_int8", "pallas_int8pv",
                "xla")


def _checked_mode(mode: str, what: str) -> str:
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
    raise ValueError(f"unknown attention mode {mode!r}")


def _hp_serves(mode: str, d: int, heads: int, score_bound) -> bool:
    """Whether :func:`attention_packed` takes the head-packed kernel."""
    return (mode == "pallas_hp" and d in (64, 128) and score_bound is None
            and (d == 128 or heads % 2 == 0))


def kernel_route(mode: str, *, dtype: torch.dtype, head_dim: int,
                 score_bound: float | None = None, heads: int | None = None
                 ) -> str:
    """The kernel that an attention call on CUDA tensors of ``dtype``
    launches in ``mode``: ``"K1"``, ``"K3"``, ``"K4"``, ``"K3q"``, ``"K6"``
    for bf16, ``"K1f <variant>"`` (:data:`~.flash_attention.K1F_VARIANTS`)
    for fp32, or ``"xla"`` (the plain version). ``heads`` given: an
    :func:`attention_packed` call. :func:`attention` and
    :func:`attention_packed` dispatch by the same rules."""
    mode = resolve_mode(mode, score_bound, head_dim=head_dim)
    fp32 = dtype == torch.float32
    if heads is not None and _hp_serves(mode, head_dim, heads, score_bound):
        return "K1f exact" if fp32 else "K6"
    if mode == "xla":
        return "xla"
    bounded = score_bound is not None
    if mode in ("pallas", "pallas_hp"):
        return f"K1f {k1f_variant(bounded=bounded)}" if fp32 \
            else ("K3" if bounded else "K1")
    pv_int8 = mode == "pallas_int8pv"
    bounded = bounded and not pv_int8
    if fp32:
        return f"K1f {k1f_variant(qk_int8=True, pv_int8=pv_int8, bounded=bounded)}"
    return "K3q" if bounded else "K4"


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
    vouch for (qk-normed attention); it selects the bounded tier (K3, or
    K3q under ``pallas_int8``)."""
    mode = resolve_mode(mode, score_bound, head_dim=q.shape[-1])
    if mode == "pallas_hp":
        # hp serves head-packed callers (attention_packed) only
        mode = "pallas"
    if q_segment_ids is not None:
        q_segment_ids = q_segment_ids.to(torch.int32).contiguous()
    if kv_segment_ids is not None:
        kv_segment_ids = kv_segment_ids.to(torch.int32).contiguous()
    if mode == "xla":
        return reference_attention(q, k, v, q_segment_ids, kv_segment_ids,
                                   scale=scale, causal=causal)
    if mode == "pallas":
        return flash_attention(q, k, v, q_segment_ids, kv_segment_ids,
                               scale=scale, causal=causal,
                               score_bound=score_bound)
    pv_int8 = mode == "pallas_int8pv"
    if pv_int8:
        # int8 P needs the running max, so the bound is dropped
        score_bound = None
    return flash_attention_int8(q, k, v, q_segment_ids, kv_segment_ids,
                                scale=scale, causal=causal, pv_int8=pv_int8,
                                score_bound=score_bound)


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
    if _hp_serves(mode, d, heads, score_bound):
        if k.shape[1] != s or v.shape[1] != s:
            raise ValueError(
                "attention_packed hp path requires q/k/v of equal length")
        return flash_attention_hp(q, k, v, heads=heads, scale=scale)

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    o = attention(split(q), split(k), split(v), scale=scale, mode=mode,
                  score_bound=score_bound)
    return o.transpose(1, 2).reshape(b, s, hd_total)
