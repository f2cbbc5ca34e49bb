"""Attention kernel K1 and its plain version.

Port of ``ltx_video_gpupoor_tpu/ops/flash_attention.py``:

- :func:`reference_attention` is ``reference_attention`` (:908-944), the
  plain PyTorch version: fp32 scores, segment/causal masks, fully masked
  rows give 0. It also takes the kernel's static ``kv_valid`` tail.
- :func:`flash_attention` is ``flash_attention`` (:412) in its exact
  online-softmax tier, backed by ``csrc/flash_attention.cu`` (which
  replaces ``_flash_kernel``, :160). It takes any sequence length (the
  kernel masks its own ragged edge), so the TPU's 128-multiple rule,
  block fitting and sub-block plans have no counterpart here.

Layout ``[B, H, S, D]``; the kernel reads any strides whose last one is 1,
so head-split views of ``[B, S, H*D]`` projections need no copy. The
bounded-score (K3), int8 (K4) and head-packed (K6) tiers are still to be
ported (ROADMAP queue 2).
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _check_seg_pair(q_segment_ids, kv_segment_ids):
    if kv_segment_ids is not None and q_segment_ids is None:
        raise ValueError("kv_segment_ids given without q_segment_ids")
    if q_segment_ids is not None and kv_segment_ids is None:
        raise ValueError("q_segment_ids given without kv_segment_ids")


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    causal: bool = False,
    kv_valid: int | None = None,
) -> torch.Tensor:
    """Unfused attention in fp32: the plain version of K1."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    _check_seg_pair(q_segment_ids, kv_segment_ids)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    dev = q.device
    if q_segment_ids is not None:
        qs = q_segment_ids[:, None, :, None]
        ks = kv_segment_ids[:, None, None, :]
        s = torch.where((qs == ks) & (ks > 0), s, NEG_INF)
    if kv_valid is not None:
        cols = torch.arange(skv, device=dev)[None, :]
        s = torch.where(cols < kv_valid, s, NEG_INF)
    if causal:
        rows = torch.arange(sq, device=dev)[:, None]
        cols = torch.arange(skv, device=dev)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.clamp(m, min=NEG_INF / 2))
    p = torch.where(m > NEG_INF / 2, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    o = o / torch.where(l > 0, l, 1.0)
    return o.to(q.dtype)


def _check_cuda_operands(q, k, v, q_seg, kv_seg):
    b, h, sq, d = q.shape
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != h \
            or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in (64, 128):
        raise ValueError(f"K1 takes head dims 64 and 128, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"K1 takes bfloat16, got {name} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a unit stride on the head dim")
        if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} strides must be 16-byte aligned")
        if max(t.stride()) >= 2**31:
            raise ValueError(f"{name} strides must fit the kernel's int32")
    if q_seg is not None:
        for name, t, n in (("q_segment_ids", q_seg, sq),
                           ("kv_segment_ids", kv_seg, k.shape[2])):
            if t.shape != (b, n) or t.dtype != torch.int32 \
                    or not t.is_contiguous() or t.device != q.device:
                raise ValueError(
                    f"{name} must be contiguous int32 [{b}, {n}] on "
                    f"{q.device}, got {t.dtype} {tuple(t.shape)}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    causal: bool = False,
    kv_valid: int | None = None,
) -> torch.Tensor:
    """Exact flash attention over ``[B, H, S, D]``.

    CPU tensors take :func:`reference_attention`; CUDA tensors launch K1
    (bf16, D in {64, 128}) or raise. The output has q's dtype and, on the
    card, q's memory layout."""
    _check_seg_pair(q_segment_ids, kv_segment_ids)
    if q.device.type == "cpu":
        return reference_attention(
            q, k, v, q_segment_ids, kv_segment_ids, scale=scale,
            causal=causal, kv_valid=kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or the CPU, not {q.device}")
    _check_cuda_operands(q, k, v, q_segment_ids, kv_segment_ids)
    from . import _lib

    b, h, sq, d = q.shape
    skv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)  # q's layout: head-split views stay views
    seg_q = q_segment_ids.data_ptr() if q_segment_ids is not None else None
    seg_kv = kv_segment_ids.data_ptr() if kv_segment_ids is not None else None
    code = _lib.library().k1_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        seg_q, seg_kv, b, h, sq, skv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3],
        -1 if kv_valid is None else int(kv_valid), int(bool(causal)),
        ctypes.c_float(float(scale) * LOG2E),
        _lib.stream_ptr(q.device),
    )
    _lib.check(code, "K1 flash_attention launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention_flops(b: int, h: int, sq: int, skv: int, d: int) -> int:
    """Operations of one unmasked call (two matmuls of 2*Sq*Skv*D each)."""
    return 4 * b * h * sq * skv * d
