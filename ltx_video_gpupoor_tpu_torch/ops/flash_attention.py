"""Attention kernels K1 (exact), K3 (bounded scores), K4 (int8), K3q
(int8 Q.K^T, bounded scores) and K6 (head-packed) and their plain versions.

Port of ``ltx_video_gpupoor_tpu/ops/flash_attention.py``:

- :func:`reference_attention` is ``reference_attention`` (:908-944), the
  plain PyTorch version of K1: fp32 scores, segment/causal masks, fully
  masked rows give 0. It also takes the kernel's static ``kv_valid`` tail.
- :func:`flash_attention` is ``flash_attention`` (:412) in its exact
  online-softmax tier, backed by ``csrc/flash_attention_wgmma.cu`` (which
  replaces ``_flash_kernel``, :160). It takes any sequence length (the
  kernel masks its own ragged edge). With ``score_bound=`` it is the
  bounded-score tier (:294-313), kernel K3 (the same source, K1's block
  at a fixed exponent offset), whose plain version is
  :func:`bounded_attention_plain`.
- :func:`flash_attention_hp` is ``flash_attention_hp`` (:804, Pallas
  ``_hp_kernel`` :663), kernel K6: exact attention that reads and writes
  the projections' ``[B, S, H*D]`` layout, the other entry of K1's source;
  its plain version is :func:`flash_attention_hp_plain`. The 128-padding
  and the even head count that the TPU kernel needs at D=64 are gone.
- :func:`mask_kind` chooses, from a call's static properties, which
  instance of K1/K6's block runs: the one without mask code, the one that
  compares columns in the last kv tile only, or the general one.
- :func:`flash_attention_int8` is the same function with ``qk_int8=True``
  (``pv_int8`` either way): the quantize prologue (:484-533) is
  :func:`int8_prologue`, shared by both versions; the plain version is
  :func:`int8_attention_plain` and the kernel ``csrc/flash_attention_int8.cu``
  (K4, the int8 branches of ``_flash_kernel``: scores :218-239, P.V
  :270-292, the x127 fold :321-327, finalize :393-401). Its QK+PV tier
  reads V transposed and in its own kv order, which the prologue writes
  (:func:`k4_v_layout`). With ``pv_int8=False`` and ``score_bound=`` it is
  the int8 Q.K^T branch under the bounded softmax (:218-239 into
  :296-313), kernel K3q (the QK tier's instance in the same source); the
  plain version is :func:`int8_attention_plain` with ``score_bound=``.

The int8 tiers' numerics depend on JAX's compiled kv block: K scales are
per block in the QK+PV tier, and P is quantized against the running max
as of each block. :func:`fit_blocks` is a pinned copy of the JAX block
fitting (equal-tested), and both versions use its kv block for the K
scales; the plain version also steps its online softmax by that block
(JAX's ``nsub=1`` plan). The kernel steps by 128-row tiles, so it agrees
with JAX's numerics to int8 noise, not bit for bit; stepped by the
kernel's tile, the plain version runs the kernel's math, and
:func:`int8_tile_bound` states how far the two may lie apart.

fp32 operands (``FP32_POLICY``) take kernel K1f on the card,
``csrc/flash_attention_fp32.cu``: the same functions in fp32 (the TPU
kernel runs in its input dtype, :343-352), each fp32 product taken as
three TF32 ``wgmma`` products of the operands' big and small parts (split
TF32; V^T inside each 8-row group in :data:`K1F_PV_ORDER`), in five variants
(:data:`K1F_VARIANTS`, chosen by :func:`k1f_variant`): exact, bounded, and
the int8 tiers' scores with an fp32 V (QK tier, bounded or not) or int8
P.V (QK+PV tier). :func:`flash_attention`, :func:`flash_attention_hp` and
:func:`flash_attention_int8` route fp32 CUDA tensors there; the plain
versions are the same functions as for bf16. K1f's kv tile in the int8
tiers is :data:`K1F_TILE_KV` rows, so its QK+PV tier agrees with the plain
version stepped by that tile (its fp32-score variants take 32-row tiles
at D=128, which no plain version depends on).

Layout ``[B, H, S, D]``; the kernels read any strides whose last one is 1,
so head-split views of ``[B, S, H*D]`` projections need no copy.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
M_FLOOR = -1e20
LOG2E = 1.4426950408889634
LOG2_127 = 6.9886846867721655  # log2(127): the int8-PV exponent fold
LN2_F32 = 0.6931471824645996    # float32(ln 2)
INV127_F32 = 0.007874015718698502  # float32(1 / 127)
# the scale of JAX's ones column of V times the x127 fold, float32(
# float32(1/127)**2 * 127): it rounds to float32(1/127)
SUM_COL_SCALE = INV127_F32

# the JAX package's default blocks and scores-tile budget (:32-41)
DEFAULT_BLOCK_Q = 768
DEFAULT_BLOCK_KV = 4096
SCORES_TILE_ELEMS = 1 << 21
K4_TILE_KV = 128  # K4's kv tile (BKV in csrc/flash_attention_int8.cu)
# K4's kv order inside each 32-row chunk in the QK+PV tier: logical column
# 4t + i (+16) holds kv row 2t + (0, 1, 8, 9)[i] (+16), the score columns
# that thread t of a quad holds in the wgmma accumulator, so that its s8 P
# fragment (4 consecutive k-bytes) packs from registers (k4_v_layout)
K4_KV_ORDER = tuple(half + 2 * t + i for half in (0, 16) for t in range(4)
                    for i in (0, 1, 8, 9))
# K4 against its plain version at K4_TILE_KV (int8_tile_bound): P codes
# that may round apart in a row, and the largest mean |difference| as a
# share of the mean |output|
K4_TILE_FLIPS = 4
K4_TILE_MEAN_REL = 5e-4
# K1/K6: the kv tile of csrc/flash_attention_wgmma.cu and the instances of
# its block by the mask code they carry (the C entry's ``mask_kind``)
K1_TILE_KV = 128
MASK_KINDS = ("none", "tail", "general")
# K1f: the fp32 kernel's variants (the C entry's ``variant``) and kv tile
K1F_VARIANTS = ("exact", "bounded", "qk8", "qk8_bounded", "pv8")
K1F_TILE_KV = 64
# K1f's split-TF32 P.V: inside each 8-row group of V^T, k index t + 4i
# holds kv row 2t + i, so that the score columns a thread holds in the
# fp32 accumulator (2t, 2t + 1) are its TF32 A fragment (k indices t and
# t + 4)
K1F_PV_ORDER = tuple(2 * t + i for i in (0, 1) for t in range(4))


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


def bounded_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    *,
    score_bound: float,
    scale: float | None = None,
    causal: bool = False,
    kv_valid: int | None = None,
) -> torch.Tensor:
    """The plain version of K3 (JAX ``_update``, :296-313): softmax with
    the fixed exponent offset ``p = exp2(min(s, sb) - sb)``, ``sb =
    score_bound * log2(e)``, no running max. A masked score gives p = 0
    exactly (in JAX and in the kernel its exp2 underflows to 0; here a
    ``where`` says so), so a row that sees no key returns 0. P meets V in
    V's dtype. The denominator is the fp32 sum of p at a head dim that
    is a multiple of 128; elsewhere JAX reads it off a ones column of V,
    so it sums the p rounded to V's dtype."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    _check_seg_pair(q_segment_ids, kv_segment_ids)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * (scale * LOG2E)
    dev = q.device
    keep = _masks(q_segment_ids, kv_segment_ids,
                  torch.arange(sq, device=dev), torch.arange(skv, device=dev),
                  kv_valid, causal)
    sb = score_bound * LOG2E
    p = torch.exp2(torch.clamp(s, max=sb) - sb)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    pr = p.to(v.dtype).float()
    l = (pr if d % 128 else p).sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", pr, v.float())
    o = o / torch.where(l > 0, l, 1.0)
    return o.to(q.dtype)


def mask_kind(skv: int, kv_valid: int | None = None, *,
              segments: bool = False, causal: bool = False) -> str:
    """Which instance of K1/K6's block a call takes (one of
    :data:`MASK_KINDS`), from what the call fixes before it runs:

    - ``"general"`` with segment ids or ``causal``: segment ids compare in
      every kv tile; causal skips the tiles above the diagonal and compares
      on the diagonal tile;
    - ``"tail"`` where the keys in sight, ``min(skv, kv_valid)``, end inside
      a kv tile of :data:`K1_TILE_KV` rows: only that last tile compares
      columns (the TPU kernel peels the block that straddles ``kv_valid``
      the same way);
    - ``"none"`` otherwise: the block carries no mask code at all."""
    if segments or causal:
        return "general"
    kv_end = skv if kv_valid is None else max(0, min(skv, int(kv_valid)))
    return "tail" if kv_end % K1_TILE_KV else "none"


def _check_layout(kernel: str, name: str, t: torch.Tensor, dtype, device):
    # on every launch: each tensor attribute is read once
    if t.dtype != dtype:
        raise ValueError(f"{kernel} takes {str(dtype)[6:]} {name}, got "
                         f"{t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    sb, sh, ss, sd = t.stride()
    if sd != 1:
        raise ValueError(f"{name} needs a unit stride on the head dim")
    es = t.element_size()
    if (sb * es) % 16 or (sh * es) % 16 or (ss * es) % 16 \
            or t.data_ptr() % 16:
        raise ValueError(f"{name} strides must be 16-byte aligned")
    if max(sb, sh, ss) >= 2**31:
        raise ValueError(f"{name} strides must fit the kernel's int32")


def _check_cuda_operands(q, k, v, q_seg, kv_seg, kernel="K1",
                         dtype=torch.bfloat16):
    b, h, sq, d = q.shape
    if k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != h \
            or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in (64, 128):
        raise ValueError(f"{kernel} takes head dims 64 and 128, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(kernel, name, t, dtype, q.device)
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
    score_bound: float | None = None,
) -> torch.Tensor:
    """Exact flash attention over ``[B, H, S, D]``; with ``score_bound``
    the bounded-score tier (logits beyond the bound tie at it).

    CPU tensors take :func:`reference_attention` (or
    :func:`bounded_attention_plain`); CUDA tensors launch K1 (K3 with a
    bound; bf16, D in {64, 128}; both run the block instance that
    :func:`mask_kind` names), K1f for fp32 operands, or raise. The output has q's dtype and, on
    the card, q's memory layout. K1 launches count in ``launches``, K3's
    in ``bounded_launches``."""
    _check_seg_pair(q_segment_ids, kv_segment_ids)
    if q.device.type == "cpu":
        if score_bound is not None:
            return bounded_attention_plain(
                q, k, v, q_segment_ids, kv_segment_ids, scale=scale,
                causal=causal, kv_valid=kv_valid, score_bound=score_bound)
        return reference_attention(
            q, k, v, q_segment_ids, kv_segment_ids, scale=scale,
            causal=causal, kv_valid=kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or the CPU, not {q.device}")
    if q.dtype == torch.float32:
        return flash_attention_fp32(q, k, v, q_segment_ids, kv_segment_ids,
                                    scale=scale, causal=causal,
                                    kv_valid=kv_valid,
                                    score_bound=score_bound)
    _check_cuda_operands(q, k, v, q_segment_ids, kv_segment_ids)
    from . import _lib

    b, h, sq, d = q.shape
    skv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)  # q's layout: head-split views stay views
    seg_q = q_segment_ids.data_ptr() if q_segment_ids is not None else None
    seg_kv = kv_segment_ids.data_ptr() if kv_segment_ids is not None else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            seg_q, seg_kv, b, h, sq, skv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            -1 if kv_valid is None else max(0, int(kv_valid)),
            int(bool(causal)))
    if not scale > 0:
        raise ValueError(f"K1 takes a positive scale, got {scale}")
    kind = MASK_KINDS.index(mask_kind(
        skv, kv_valid, segments=q_segment_ids is not None, causal=causal))
    scale_log2 = ctypes.c_float(float(scale) * LOG2E)
    if score_bound is None:
        code = _lib.library().k1_flash_attention_bf16(
            *args, kind, scale_log2, _lib.stream_ptr(q.device))
        _lib.check(code, "K1 flash_attention launch")
        flash_attention.launches += 1
    else:
        code = _lib.library().k3_flash_attention_bounded_bf16(
            *args, kind, scale_log2,
            ctypes.c_float(float(score_bound) * LOG2E),
            _lib.stream_ptr(q.device))
        _lib.check(code, "K3 bounded flash_attention launch")
        flash_attention.bounded_launches += 1
    return out


flash_attention.launches = 0
flash_attention.bounded_launches = 0


# --------------------------------------------------------------------------
# K6: the head-packed kernel
# --------------------------------------------------------------------------

def flash_attention_hp_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    heads: int,
    scale: float | None = None,
    kv_valid: int | None = None,
) -> torch.Tensor:
    """The plain version of K6: :func:`reference_attention` on the head
    split of ``[B, S, H*D]``, merged back."""
    b, s, hd_total = q.shape
    d = hd_total // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    o = reference_attention(split(q), split(k), split(v), scale=scale,
                            kv_valid=kv_valid)
    return o.transpose(1, 2).reshape(b, s, hd_total)


def flash_attention_hp(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    heads: int,
    scale: float | None = None,
    kv_valid: int | None = None,
) -> torch.Tensor:
    """Exact attention over head-packed ``[B, S, H*D]`` tensors, D in
    {64, 128}, any S and any head count; ``kv_valid`` masks a kv tail.

    CPU tensors take :func:`flash_attention_hp_plain`; CUDA tensors (bf16,
    unit last stride: a slice of a fused q/k/v projection is read in
    place) launch K6, fp32 ones K1f on the same strides, or raise. The output is a new ``[B, S, H*D]``."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"q, k, v must be [B, S, H*D]: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, s, hd_total = q.shape
    if hd_total % heads:
        raise ValueError(f"width {hd_total} does not split into {heads} heads")
    d = hd_total // heads
    if d not in (64, 128):
        raise ValueError(f"flash_attention_hp supports d in (64, 128), "
                         f"got {d}")
    if q.device.type == "cpu":
        return flash_attention_hp_plain(q, k, v, heads=heads, scale=scale,
                                        kv_valid=kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA or the CPU, not {q.device}")
    if q.dtype == torch.float32:
        # K1f reads the head-packed layout through the strides of its
        # head-split view and writes [B, S, H*D] the same way
        def split(t):
            return t.view(b, t.shape[1], heads, d).transpose(1, 2)

        out = torch.empty((b, s, hd_total), dtype=q.dtype, device=q.device)
        flash_attention_fp32(split(q), split(k), split(v), scale=scale,
                             kv_valid=kv_valid, out=split(out))
        return out
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"K6 takes bf16 {name}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(2) != 1 or t.data_ptr() % 16 \
                or any(st % 8 for st in t.stride()[:2]):
            raise ValueError(f"K6 needs {name} with a unit last stride and "
                             f"16-byte aligned rows, got strides {t.stride()}")
        if max(t.stride()) * max(t.shape[0], 1) >= 2**31:
            raise ValueError(f"{name} strides must fit the kernel's int32")
    from . import _lib

    if scale is None:
        scale = d ** -0.5
    if not scale > 0:
        raise ValueError(f"K6 takes a positive scale, got {scale}")
    out = torch.empty((b, s, hd_total), dtype=q.dtype, device=q.device)
    code = _lib.library().k6_flash_attention_hp_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, k.shape[1], heads, d,
        *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], *out.stride()[:2],
        -1 if kv_valid is None else max(0, int(kv_valid)),
        MASK_KINDS.index(mask_kind(k.shape[1], kv_valid)),
        ctypes.c_float(float(scale) * LOG2E), _lib.stream_ptr(q.device))
    _lib.check(code, "K6 flash_attention_hp launch")
    flash_attention_hp.launches += 1
    return out


flash_attention_hp.launches = 0


# --------------------------------------------------------------------------
# K4: the int8 tiers
# --------------------------------------------------------------------------

def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def fit_blocks(sq: int, skv: int, block_q: int = DEFAULT_BLOCK_Q,
               block_kv: int = DEFAULT_BLOCK_KV) -> tuple[int, int]:
    """Pinned copy of the JAX ``fit_blocks`` (:130-157): the largest
    128-multiple divisor of each (128-padded) length under the cap, the
    kv cap further bound by the scores-tile budget."""
    def fit(cap, s):
        cap = min(cap, s)
        best, b = 128, 128
        while b <= cap:
            if s % b == 0:
                best = b
            b += 128
        return best

    block_q = fit(block_q, sq)
    block_kv = fit(min(block_kv, max(128, SCORES_TILE_ELEMS // block_q)), skv)
    return block_q, block_kv


def _k4_v_view(vt: torch.Tensor) -> torch.Tensor:
    """A K4 V^T buffer ``[B, H, D, Spad]`` seen as its kv rows, 8-D ``(b,
    h, chunk, half, a, t, c, d)``: kv row ``32 chunk + 16 half + 8a + 2t
    + c`` lies at column ``32 chunk + 16 half + 4t + 2a + c``
    (:data:`K4_KV_ORDER`)."""
    b, h, d, sp = vt.shape
    return vt.view(b, h, d, sp // 32, 2, 4, 2, 2).permute(0, 1, 3, 4, 6, 5,
                                                          7, 2)


def k4_v_layout(v: torch.Tensor) -> torch.Tensor:
    """``[B, H, S, D]`` int8 codes (or floats that hold them) -> int8
    ``[B, H, D, Spad]`` (Spad = S rounded up to :data:`K4_TILE_KV`, zero
    columns past S): V transposed, so that the kv axis is the one K4's s8
    P.V reads contiguously (8-bit wgmma reads B K-major only), with the kv
    rows of each 32-row chunk in :data:`K4_KV_ORDER`. One strided copy, no
    index tensor. P.V over the permuted columns of P is P.V."""
    b, h, s, d = v.shape
    sp = round_up(s, K4_TILE_KV)
    if sp != s:
        v = F.pad(v, (0, 0, 0, sp - s))
    vt = torch.empty(b, h, d, sp, dtype=torch.int8, device=v.device)
    _k4_v_view(vt).copy_(v.reshape(b, h, sp // 32, 2, 2, 4, 2, d))
    return vt


def k4_v_rows(vt: torch.Tensor, s: int) -> torch.Tensor:
    """The inverse of :func:`k4_v_layout`: int8 ``[B, H, S, D]``, the
    first ``s`` kv rows (a copy)."""
    b, h, d, sp = vt.shape
    return _k4_v_view(vt).reshape(b, h, sp, d)[:, :, :s]


class Int8Operands(NamedTuple):
    """What the quantize prologue hands to K4 or to its plain version.

    The tensors are laid out as K4 reads them, and the plain version
    reads the same ones. ``q_scale`` carries the softmax scale times
    log2(e); ``k_scale`` has one entry per ``k_block`` kv rows (the kv
    block in the QK+PV tier, 1 in the QK tier) over Skv rounded up to
    :data:`K4_TILE_KV` (zero past Skv); ``v`` is, in the QK+PV tier, the
    int8 codes as :func:`k4_v_layout` lays them out (:func:`k4_v_rows`
    gives them back as rows); ``v_scale`` (QK+PV tier) multiplies the
    int32 P.V per channel, JAX's ``v_scale * 127``; ``kv_block`` is the
    JAX kernel's kv block."""

    q8: torch.Tensor          # int8 [B, H, Sq, D]
    q_scale: torch.Tensor     # fp32 [B, H, Sq]
    k8: torch.Tensor          # int8 [B, H, Skv, D]
    k_scale: torch.Tensor     # fp32 [B, H, round_up(Skv, 128) / k_block]
    k_block: int
    v: torch.Tensor           # int8 [B, H, D, Spad] or the input [B, H, Skv, D]
    v_scale: torch.Tensor | None   # fp32 [B, H, D]
    kv_block: int


def _absmax_scale(x: torch.Tensor, dims) -> torch.Tensor:
    """``max(amax|x|, 1e-6) / 127`` over ``dims``, as XLA computes it:
    a multiply by float32(1/127) (XLA rewrites a division by a constant;
    the IEEE quotient differs by an ulp in about 4% of rows)."""
    return torch.clamp(x.abs().amax(dim=dims), min=1e-6) * INV127_F32


def int8_prologue(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float | None = None, pv_int8: bool = True,
                  block_kv: int = DEFAULT_BLOCK_KV) -> Int8Operands:
    """The int8 tiers' quantize prologue (JAX :484-533), plain torch ops.
    ``block_kv`` is the kv block requested of JAX's kernel; the k scales
    take the block that :func:`fit_blocks` makes of it.

    The k and v scales take their absmax over every kv row (rows that a
    segment mask hides included, as in JAX; its zero padding rows add
    nothing). The QK+PV tier's v codes are written straight into K4's V^T
    layout, so a launch copies nothing."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    spad = round_up(skv, K4_TILE_KV)
    _, kv_block = fit_blocks(round_up(sq, 128), spad, DEFAULT_BLOCK_Q,
                             block_kv)
    qf = q.float()
    q_s = _absmax_scale(qf, -1)
    q8 = torch.round(qf / q_s[..., None]).to(torch.int8)
    del qf
    q_scale = (q_s * (scale * LOG2E)).contiguous()
    kf = k.float()
    if pv_int8:
        nkv = spad // kv_block
        kp = F.pad(kf, (0, 0, 0, spad - skv))
        k_s = _absmax_scale(kp.reshape(b, h, nkv, kv_block, d), (3, 4))
        k8 = torch.round(kp.reshape(b, h, nkv, kv_block, d)
                         / k_s[..., None, None])
        k8 = k8.reshape(b, h, -1, d)[:, :, :skv].to(torch.int8)
        k_block = kv_block
    else:
        k_s = _absmax_scale(kf, -1)
        k8 = torch.round(kf / k_s[..., None]).to(torch.int8)
        k_s = F.pad(k_s, (0, spad - skv))
        k_block = 1
    del kf
    v_scale = None
    if pv_int8:
        vf = torch.empty(b, h, spad, d, device=v.device)
        vf[:, :, :skv] = v
        vf[:, :, skv:] = 0
        v_s = _absmax_scale(vf, 2)                        # [B, H, D]
        v = k4_v_layout(torch.round(vf / v_s[:, :, None, :]))
        del vf
        v_scale = (v_s * INV127_F32 * 127.0).contiguous()
    return Int8Operands(q8, q_scale, k8, k_s.contiguous(), k_block, v,
                        v_scale, kv_block)


def _masks(q_seg, kv_seg, rows, cols, kv_valid, causal):
    """[B or 1, 1, rows, cols] bool: which scores stay (None = all)."""
    keep = None

    def both(a, m):
        return m if a is None else a & m

    if q_seg is not None:
        qs = q_seg[:, None, rows, None]
        ks = kv_seg[:, None, None, cols]
        keep = both(keep, (qs == ks) & (ks > 0))
    if kv_valid is not None:
        keep = both(keep, (cols < kv_valid)[None, None, None, :])
    if causal:
        keep = both(keep, (rows[:, None] >= cols[None, :])[None, None])
    return keep


def _exp2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` as XLA lowers it, ``exp(float32(ln 2) * x)``.
    ``torch.exp2`` differs from it by an ulp in most elements, which
    flips ``round(p)`` codes of the int8-PV tier about 5 times per 1e6
    scores; this form flipped none in 4e6."""
    return torch.exp(x * LN2_F32)


def _int8_tiles(ops: Int8Operands, q_seg, kv_seg, causal, kv_valid,
                block_kv):
    """K4's masked scores in the exp2 domain, tile by tile: yields
    ``(r0, r1, c0, c1, s)`` for q rows ``r0:r1`` (chunks that keep a tile
    at ``B*H*2**22`` scores) against kv rows ``c0:c1`` (steps of
    ``block_kv``), kv innermost. The int8 products are exact in fp32 (at
    most ``127**2 * D``, below 2**24 for D <= 1024)."""
    b, h, sq, d = ops.q8.shape
    skv = ops.k8.shape[2]
    s_dtype = torch.float32 if d <= 1024 else torch.float64
    dev = ops.q8.device
    q_chunk = max(1, (1 << 22) // block_kv)
    for r0 in range(0, sq, q_chunk):
        r1 = min(r0 + q_chunk, sq)
        rows = torch.arange(r0, r1, device=dev)
        qc = ops.q8[:, :, r0:r1].to(s_dtype)
        qs = ops.q_scale[:, :, r0:r1, None]
        for c0 in range(0, skv, block_kv):
            c1 = min(c0 + block_kv, skv)
            cols = torch.arange(c0, c1, device=dev)
            s32 = (qc @ ops.k8[:, :, c0:c1].to(s_dtype).transpose(-1, -2)
                   ).float()
            ks = ops.k_scale[:, :, None, cols // ops.k_block]
            if ops.v_scale is not None:  # per-block k scale: qs * ks first
                s = s32 * (qs * ks)
            else:
                s = (s32 * qs) * ks
            del s32
            keep = _masks(q_seg, kv_seg, rows, cols, kv_valid, causal)
            if keep is not None:
                s = torch.where(keep, s, NEG_INF)
            yield r0, r1, c0, c1, s


def int8_attention_plain(
    ops: Int8Operands,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    *,
    causal: bool = False,
    kv_valid: int | None = None,
    out_dtype: torch.dtype = torch.float32,
    block_kv: int | None = None,
    score_bound: float | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of K4: JAX's int8 kernel body with one
    sub-block per kv block (``nsub=1``), stepping its online softmax over
    ``block_kv`` rows at a time: by default ``ops.kv_block``, JAX's
    block; ``K4_TILE_KV`` steps as the kernel does, which makes P's
    quantization the kernel's. (The k scales keep ``ops.k_block``.) P.V
    runs in float64: a kv block may sum 127**2 * 4096 > 2**24.

    With ``score_bound`` (QK tier operands only: JAX refuses int8 P under
    a fixed offset, :477-483) it is the plain version of K3q, JAX's
    bounded ``_update`` (:296-313) on the int8 scores: ``p =
    exp2(min(s, sb) - sb)``, ``sb = score_bound * log2(e)``, no running
    max, so ``block_kv`` only orders the sums.

    At a head dim that is not a 128 multiple JAX appends a ones column
    to V, so the denominator sums the rounded p: ``127 * sum(p8)`` times
    the column's scale (QK+PV tier), the bf16 p (QK tier)."""
    _check_seg_pair(q_segment_ids, kv_segment_ids)
    b, h, sq, d = ops.q8.shape
    v, v_scale = ops.v, ops.v_scale
    pv_int8 = v_scale is not None
    bounded = score_bound is not None
    if pv_int8 and bounded:
        raise ValueError("pv_int8 requires the online-softmax path; drop "
                         "score_bound")
    if pv_int8:
        v = k4_v_rows(v, ops.k8.shape[2])
    sum_rounded = d % 128 != 0
    if block_kv is None:
        block_kv = ops.kv_block
    dev = ops.q8.device
    out = torch.empty(b, h, sq, d, dtype=out_dtype, device=dev)
    sb = score_bound * LOG2E if bounded else None
    for r0, r1, c0, c1, s in _int8_tiles(ops, q_segment_ids, kv_segment_ids,
                                         causal, kv_valid, block_kv):
        if c0 == 0:
            m = torch.full((b, h, r1 - r0, 1), M_FLOOR, device=dev)
            l = torch.zeros((b, h, r1 - r0, 1), device=dev)
            acc = torch.zeros((b, h, r1 - r0, d), device=dev)
        if bounded:
            p = _exp2(torch.clamp(s, max=sb) - sb)
            del s
            pr = p.to(v.dtype).float()
            acc += pr @ v[:, :, c0:c1].float()
            l += (pr if sum_rounded else p).sum(-1, keepdim=True)
            del p, pr
        else:
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = _exp2(m - m_new)
            if pv_int8:
                p = _exp2(s - (m_new - LOG2_127))
                del s
                p8 = torch.round(p).double()
                pv = (p8 @ v[:, :, c0:c1].double()).float() * \
                    v_scale[:, :, None, :]
                if sum_rounded:
                    l_blk = (p8.sum(-1, keepdim=True) * 127).float() * \
                        SUM_COL_SCALE
                else:
                    l_blk = p.sum(-1, keepdim=True)
                del p8
            else:
                p = _exp2(s - m_new)
                del s
                pr = p.to(v.dtype).float()
                pv = pr @ v[:, :, c0:c1].float()
                l_blk = (pr if sum_rounded else p).sum(-1, keepdim=True)
                del pr
            del p
            l = alpha * l + l_blk
            acc = acc * alpha + pv
            m = m_new
        if c1 == ops.k8.shape[2]:
            out[:, :, r0:r1] = (acc / torch.where(l > 0, l, 1.0)
                                ).to(out_dtype)
    return out


def int8_row_mass(
    ops: Int8Operands,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    *,
    causal: bool = False,
    kv_valid: int | None = None,
) -> torch.Tensor:
    """fp32 ``[B, H, Sq]``: each q row's softmax mass over K4's scores in
    units of its largest term, ``sum_j 2**(s_j - max s)``: at least 1
    where a key is kept, 0 where none is."""
    b, h, sq, _ = ops.q8.shape
    dev = ops.q8.device
    mass = torch.empty(b, h, sq, device=dev)
    for r0, r1, c0, c1, s in _int8_tiles(ops, q_segment_ids, kv_segment_ids,
                                         causal, kv_valid, ops.kv_block):
        if c0 == 0:
            m = torch.full((b, h, r1 - r0, 1), M_FLOOR, device=dev)
            l = torch.zeros((b, h, r1 - r0, 1), device=dev)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        l = l * _exp2(m - m_new) + _exp2(s - m_new).sum(-1, keepdim=True)
        m = m_new
        if c1 == ops.k8.shape[2]:
            mass[:, :, r0:r1] = l[..., 0]
    return mass


def int8_tile_bound(
    ops: Int8Operands,
    plain: torch.Tensor,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    *,
    causal: bool = False,
    kv_valid: int | None = None,
) -> torch.Tensor:
    """How far K4's bf16 output may lie from ``plain``, the plain version
    stepped by ``K4_TILE_KV`` on the same operands, element by element.

    The two run the same math; fp32 summation order and exp2f's
    approximation differ. Where that rounds a P code (QK+PV tier) or a
    bf16 p (QK tier) the other way, the row moves by at most ``vmax /
    (127 * mass)`` (``vmax`` the channel's largest ``|v|``, ``mass`` from
    :func:`int8_row_mass`; a bf16 p moves by less). The bound allows
    ``K4_TILE_FLIPS`` such roundings, then one bf16 rounding apart. A
    wrong row's error is of the size of its output, which at a large
    mass lies far above the bound."""
    mass = int8_row_mass(ops, q_segment_ids, kv_segment_ids, causal=causal,
                         kv_valid=kv_valid)
    if ops.v_scale is not None:
        vmax = ops.v_scale * 127.0                       # [B, H, D]
    else:
        vmax = ops.v.float().abs().amax(dim=2)
    flips = (K4_TILE_FLIPS / 127.0) * vmax[:, :, None, :] \
        / mass.clamp(min=1.0)[..., None]
    _, e = torch.frexp(plain.float().abs() + flips)
    # bf16 has 8 significant bits: its ulp below 2**e is 2**(e - 8)
    return flips + torch.ldexp(torch.ones_like(flips), e - 8)


def _check_int8_operands(ops: Int8Operands, device):
    for name, t in (("q8", ops.q8), ("k8", ops.k8)):
        _check_layout("K4", name, t, torch.int8, device)
    b, h, sq, d = ops.q8.shape
    spad = round_up(ops.k8.shape[2], K4_TILE_KV)
    if ops.v_scale is None:
        _check_layout("K4", "v", ops.v, torch.bfloat16, device)
    elif ops.v.shape != (b, h, d, spad) or ops.v.dtype != torch.int8 \
            or not ops.v.is_contiguous() or ops.v.device != device:
        raise ValueError(f"K4 takes int8 v as k4_v_layout lays it out, "
                         f"contiguous {(b, h, d, spad)} on {device}; got "
                         f"{ops.v.dtype} {tuple(ops.v.shape)}")
    if ops.k_block % K4_TILE_KV and ops.k_block != 1:
        raise ValueError(f"K4 takes k scales per row or per {K4_TILE_KV}-"
                         f"multiple kv block, got {ops.k_block}")
    for name, t, shape in (("q_scale", ops.q_scale, (b, h, sq)),
                           ("k_scale", ops.k_scale,
                            (b, h, spad // ops.k_block)),
                           ("v_scale", ops.v_scale, (b, h, d))):
        if t is None:
            continue
        if t.shape != shape or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != device:
            raise ValueError(f"K4 {name} must be contiguous fp32 {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)}")


def int8_attention_cuda(
    ops: Int8Operands,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    *,
    causal: bool = False,
    kv_valid: int | None = None,
    out: torch.Tensor | None = None,
    score_bound: float | None = None,
) -> torch.Tensor:
    """Launch K4 on prologue operands that lie on the card, or with
    ``score_bound`` K3q (QK tier operands only); the result is bf16,
    written into ``out`` (any 16-byte aligned layout) if given. Each
    launch adds one to ``flash_attention_int8.launches`` (K4) or
    ``flash_attention_int8.bounded_launches`` (K3q)."""
    from . import _lib

    _check_seg_pair(q_segment_ids, kv_segment_ids)
    _check_int8_operands(ops, ops.q8.device)
    pv_int8 = ops.v_scale is not None
    if pv_int8 and score_bound is not None:
        raise ValueError("pv_int8 requires the online-softmax path; drop "
                         "score_bound")
    b, h, sq, d = ops.q8.shape
    skv = ops.k8.shape[2]
    if out is None:
        out = torch.empty(b, h, sq, d, dtype=torch.bfloat16,
                          device=ops.q8.device)
    elif out.shape != ops.q8.shape:
        raise ValueError(f"K4 out must be {tuple(ops.q8.shape)}")
    else:
        _check_layout("K4", "out", out, torch.bfloat16, ops.q8.device)
    seg_q = q_segment_ids.data_ptr() if q_segment_ids is not None else None
    seg_kv = kv_segment_ids.data_ptr() if kv_segment_ids is not None else None
    kind = MASK_KINDS.index(mask_kind(
        skv, kv_valid, segments=q_segment_ids is not None, causal=causal))
    args = (ops.q8.data_ptr(), ops.k8.data_ptr(), ops.v.data_ptr(),
            out.data_ptr(), seg_q, seg_kv, ops.q_scale.data_ptr(),
            ops.k_scale.data_ptr())
    shape = (b, h, sq, skv, d, *ops.q8.stride()[:3], *ops.k8.stride()[:3],
             *ops.v.stride()[:3], *out.stride()[:3])
    valid = -1 if kv_valid is None else max(0, int(kv_valid))
    if score_bound is None:
        code = _lib.library().k4_flash_attention_int8(
            *args, ops.v_scale.data_ptr() if pv_int8 else None, *shape,
            ops.k_block, ops.k_scale.shape[2], valid, int(bool(causal)),
            int(pv_int8), kind, _lib.stream_ptr(ops.q8.device))
        _lib.check(code, "K4 flash_attention_int8 launch")
        flash_attention_int8.launches += 1
    else:
        code = _lib.library().k3q_flash_attention_int8_bounded(
            *args, *shape, ops.k_scale.shape[2], valid, int(bool(causal)),
            kind, ctypes.c_float(float(score_bound) * LOG2E),
            _lib.stream_ptr(ops.q8.device))
        _lib.check(code, "K3q bounded flash_attention_int8 launch")
        flash_attention_int8.bounded_launches += 1
    return out


def flash_attention_int8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    causal: bool = False,
    kv_valid: int | None = None,
    pv_int8: bool = True,
    score_bound: float | None = None,
) -> torch.Tensor:
    """int8 flash attention over ``[B, H, S, D]``: the QK+PV tier
    (``pallas_int8pv``) or, with ``pv_int8=False``, the QK tier
    (``pallas_int8``), at JAX's default blocks; the QK tier with
    ``score_bound`` is the bounded one (K3q). ``pv_int8`` with a bound
    raises (in the plain version or the launch), as in JAX.

    CPU tensors take :func:`int8_attention_plain`; CUDA tensors (bf16,
    D in {64, 128}) launch K4 (K3q), fp32 ones K1f's int8 variants on the
    same prologue operands, or raise. The output has q's dtype
    and, on the card, q's memory layout."""
    _check_seg_pair(q_segment_ids, kv_segment_ids)
    fp32 = q.dtype == torch.float32
    if q.device.type == "cuda":
        _check_cuda_operands(
            q, k, v, q_segment_ids, kv_segment_ids,
            "K1f" if fp32 else "K4" if score_bound is None else "K3q",
            torch.float32 if fp32 else torch.bfloat16)
    elif q.device.type != "cpu":
        raise ValueError(f"K4 runs on CUDA or the CPU, not {q.device}")
    ops = int8_prologue(q, k, v, scale=scale, pv_int8=pv_int8)
    kw = dict(causal=causal, kv_valid=kv_valid, score_bound=score_bound)
    if q.device.type == "cpu":
        return int8_attention_plain(ops, q_segment_ids, kv_segment_ids,
                                    out_dtype=q.dtype, **kw)
    if fp32:
        return int8_attention_fp32(ops, q_segment_ids, kv_segment_ids,
                                   out=torch.empty_like(q), **kw)
    return int8_attention_cuda(ops, q_segment_ids, kv_segment_ids,
                               out=torch.empty_like(q), **kw)


flash_attention_int8.launches = 0
flash_attention_int8.bounded_launches = 0


# --------------------------------------------------------------------------
# K1f: the fp32 kernel
# --------------------------------------------------------------------------

def k1f_variant(*, qk_int8: bool = False, pv_int8: bool = False,
                bounded: bool = False) -> str:
    """Which of :data:`K1F_VARIANTS` an fp32 call runs: the int8 QK+PV
    tier (``pv8``, never bounded, as in JAX), the int8 QK tier (``qk8``,
    ``qk8_bounded``: K3q's function), or fp32 scores (``exact``,
    ``bounded``: K1's and K3's)."""
    if pv_int8:
        if bounded:
            raise ValueError("pv_int8 requires the online-softmax path; drop "
                             "score_bound")
        return "pv8"
    if qk_int8:
        return "qk8_bounded" if bounded else "qk8"
    return "bounded" if bounded else "exact"


def _k1f_launch(q, k, v, out, q_seg, kv_seg, *, variant, kv_valid, causal,
                scale_log2=0.0, bound_log2=0.0, q_scale=None, k_scale=None,
                v_scale=None, k_block=1):
    """One launch of K1f; ``k``'s shape gives Skv (for ``pv8`` ``v`` is
    K4's V^T and its strides are (b, h, d))."""
    from . import _lib

    b, h, sq, d = q.shape
    skv = k.shape[2]
    kind = MASK_KINDS.index(mask_kind(
        skv, kv_valid, segments=q_seg is not None, causal=causal))

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = _lib.library().k1f_flash_attention_fp32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ptr(q_seg), ptr(kv_seg), ptr(q_scale), ptr(k_scale), ptr(v_scale),
        b, h, sq, skv, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], -1 if kv_valid is None else max(0, int(kv_valid)),
        int(bool(causal)), kind, K1F_VARIANTS.index(variant), k_block,
        1 if k_scale is None else k_scale.shape[2],
        ctypes.c_float(scale_log2), ctypes.c_float(bound_log2),
        _lib.stream_ptr(q.device))
    _lib.check(code, f"K1f flash_attention_fp32 ({variant}) launch")
    flash_attention_fp32.launches += 1
    flash_attention_fp32.by_variant[variant] += 1
    return out


def _check_fp32_out(out, shape, device):
    if out.shape != shape:
        raise ValueError(f"K1f out must be {tuple(shape)}, got "
                         f"{tuple(out.shape)}")
    _check_layout("K1f", "out", out, torch.float32, device)


def flash_attention_fp32(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    *,
    scale: float | None = None,
    causal: bool = False,
    kv_valid: int | None = None,
    score_bound: float | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """K1f on fp32 CUDA tensors ``[B, H, S, D]`` (D in {64, 128}, any
    16-byte aligned strides with a unit last one): exact attention, or
    with ``score_bound`` the bounded tier; the plain versions are
    :func:`reference_attention` and :func:`bounded_attention_plain`. The
    result is fp32 in ``out`` (q's layout by default). Every launch adds
    one to ``flash_attention_fp32.launches`` and to its variant's entry of
    ``flash_attention_fp32.by_variant``."""
    _check_seg_pair(q_segment_ids, kv_segment_ids)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_fp32 launches the CUDA kernel")
    _check_cuda_operands(q, k, v, q_segment_ids, kv_segment_ids, "K1f",
                         torch.float32)
    if out is None:
        out = torch.empty_like(q)   # q's strides, checked above
    else:
        _check_fp32_out(out, q.shape, q.device)
    if scale is None:
        scale = q.shape[3] ** -0.5
    if not scale > 0:
        raise ValueError(f"K1f takes a positive scale, got {scale}")
    bounded = score_bound is not None
    return _k1f_launch(
        q, k, v, out, q_segment_ids, kv_segment_ids,
        variant=k1f_variant(bounded=bounded), kv_valid=kv_valid,
        causal=causal, scale_log2=float(scale) * LOG2E,
        bound_log2=float(score_bound) * LOG2E if bounded else 0.0)


flash_attention_fp32.launches = 0
flash_attention_fp32.by_variant = dict.fromkeys(K1F_VARIANTS, 0)


def int8_attention_fp32(
    ops: Int8Operands,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    *,
    causal: bool = False,
    kv_valid: int | None = None,
    out: torch.Tensor | None = None,
    score_bound: float | None = None,
) -> torch.Tensor:
    """K1f's int8 variants on prologue operands of fp32 inputs that lie on
    the card: the QK tier (``qk8``; with ``score_bound`` ``qk8_bounded``,
    K3q's function) reads an fp32 ``ops.v``, the QK+PV tier (``pv8``) K4's
    int8 V^T. The result is fp32 in ``out``; the plain version is
    :func:`int8_attention_plain` (stepped by :data:`K1F_TILE_KV` for the
    same P codes in the QK+PV tier)."""
    _check_seg_pair(q_segment_ids, kv_segment_ids)
    dev = ops.q8.device
    for name, t in (("q8", ops.q8), ("k8", ops.k8)):
        _check_layout("K1f", name, t, torch.int8, dev)
    b, h, sq, d = ops.q8.shape
    if d not in (64, 128):
        raise ValueError(f"K1f takes head dims 64 and 128, got {d}")
    pv_int8 = ops.v_scale is not None
    spad = round_up(ops.k8.shape[2], K4_TILE_KV)
    if pv_int8:
        if ops.v.shape != (b, h, d, spad) or ops.v.dtype != torch.int8 \
                or not ops.v.is_contiguous() or ops.v.device != dev:
            raise ValueError("K1f takes int8 v as k4_v_layout lays it out")
    else:
        _check_layout("K1f", "v", ops.v, torch.float32, dev)
    for name, t in (("q_scale", ops.q_scale), ("k_scale", ops.k_scale),
                    ("v_scale", ops.v_scale)):
        if t is not None and (t.dtype != torch.float32
                              or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"K1f {name} must be contiguous fp32 on {dev}")
    if q_segment_ids is not None:
        _check_cuda_operands(ops.q8, ops.k8, ops.k8, q_segment_ids,
                             kv_segment_ids, "K1f", torch.int8)
    if out is None:
        out = torch.empty(b, h, sq, d, dtype=torch.float32, device=dev)
    _check_fp32_out(out, ops.q8.shape, dev)
    bounded = score_bound is not None
    return _k1f_launch(
        ops.q8, ops.k8, ops.v, out, q_segment_ids, kv_segment_ids,
        variant=k1f_variant(qk_int8=True, pv_int8=pv_int8, bounded=bounded),
        kv_valid=kv_valid, causal=causal,
        bound_log2=float(score_bound) * LOG2E if bounded else 0.0,
        q_scale=ops.q_scale, k_scale=ops.k_scale, v_scale=ops.v_scale,
        k_block=ops.k_block)


def attention_flops(b: int, h: int, sq: int, skv: int, d: int) -> int:
    """Operations of one unmasked call (two matmuls of 2*Sq*Skv*D each)."""
    return 4 * b * h * sq * skv * d
