// K1, K3 and K6: flash attention forward, bf16, for sm_90a, on wgmma.
//
// K1 replaces the exact tier of the Pallas TPU kernel
// ltx_video_gpupoor_tpu/ops/flash_attention.py::_flash_kernel (reached
// through flash_attention, :412 -> pl.pallas_call :631), K3 the same
// kernel's bounded-score branch (_update, :294-313; flash_attention with
// score_bound=) and K6 the head-packed kernel _hp_kernel (:663, reached
// through flash_attention_hp, :804 -> pl.pallas_call :866). The three
// entries run one block; K6 hands it the strides of the projections'
// [B, S, H*D] layout (head h starts D*h values into a token's row), which
// on the TPU needed a kernel of its own.
//
// K1 and K6 compute o = softmax(q k^T * scale) v, bf16 in and out, fp32
// scores and sums, D in {64, 128} (and 80 for K1 and K3, CLIP ViT-H/14's
// heads), any Sq and Skv, any strides with a unit last stride (head-split views and slices of a fused q/k/v projection are
// read in place). Masks: a static kv_valid tail, segment ids (attend iff
// q_seg == kv_seg and kv_seg > 0) and causal. A row that sees no key
// returns exactly 0: the running max starts at M_FLOOR, a masked score
// sits at NEG_INF, so its exp2 underflows to 0 and the sum l stays 0.
// K3 computes o = sum_j p_j v_j / sum_j p_j with p = exp2(min(s, sb) - sb),
// s = q k^T * scale * log2(e) and the fixed offset sb = score_bound *
// log2(e): no running max, no rescale of the accumulator; a score over the
// bound ties at it, a masked one gives p = 0. Its denominator is the fp32
// sum of p at D=128 and the sum of the bf16-rounded p at D=64, where the
// TPU kernel reads it off a ones column of V (bounded_attention_plain in
// ops/flash_attention.py is the contract).
// A head of DV = 80 runs in the D = 128 layout: the tensor maps' inner
// extent is 80, so TMA fills the panels' columns 80..127 with zeros (no
// copy), Q.K^T and P.V see zero channels, and the epilogue stores 80
// columns. Its denominator, in K1 too, is the sum of the bf16-rounded p
// that the TPU kernel reads off its ones column at a head dim that is not
// a 128 multiple (flash_attention.py:510-523). The scale is the caller's
// (80^-0.5 by default).
//
// What bounds it on an H100: the tensor cores (4*B*H*Sq*Skv*D operations at
// 989 TFLOP/s) and, at D=64, just as much the exponentials: one ex2 a score
// on the special-function units (16 a clock on each of 132 SMs) takes as
// long as the two products of a 64-wide head, so the two cannot both be
// hidden and the tensor bound alone is out of reach there. K3's step drops
// the max, its shuffles and the rescale, which leaves the ex2 and the
// products. Memory does not bound it: every K/V tile is used by 128 q rows
// and stays in L2 across the q tiles of a head.
//
// Design. One block = 128 q rows of one (batch, head), in two consumer
// warpgroups of 64 rows each.
// - Both products run on wgmma.mma_async. Q.K^T is m64n128k16 with Q (loaded
//   once) and the K tile read from shared memory through descriptors; P.V is
//   m64nDk16 with P taken from registers (the fp32 score accumulator, after
//   exp2, packed to bf16, already has the A-fragment layout) and the V tile
//   [kv, D] read through a transposed-B descriptor. No thread issues a
//   shared-memory load for K or V.
// - K and V tiles of 128 kv rows arrive under the math: one thread issues TMA
//   loads (cp.async.bulk.tensor) into a ring of stages (four at D=64, two at
//   D=128), K and V each with a full and an empty mbarrier a stage. One 4-D
//   tensor map an operand over (D, S, H, B) with the caller's strides covers
//   [B, H, S, D], head-split views and K6's packed rows alike, writes the
//   128-byte swizzle that wgmma reads, and zero-fills rows past S. A tile is
//   D/64 panels of [128 rows x 64 values] (a panel row is the swizzle span).
// - The products of one tile run under the softmax of the next: Q.K^T of
//   tile j and P.V of tile j - 1 are issued together, the exponentials of
//   tile j run while P.V is in flight, and (K1, K6) the accumulator takes the
//   new max's factor once P.V has landed.
// - Mask code runs only where it must. The block is instantiated for three
//   mask kinds, chosen on the host from the call's static properties: none;
//   tail (only the last kv tile, the one that straddles min(Skv, kv_valid),
//   compares columns); general (segment ids compare in every tile; causal
//   skips the tiles above the diagonal and compares on the diagonal tile).
// - The exponent is one FMA and one ex2.approx a score: p = exp2(s*c - m),
//   c = scale * log2(e), m the running max of s*c; K3's is a multiply, a
//   min, a subtract and the ex2.
// - Who issues the loads, and whether the warpgroups take turns, differs by
//   head dim: see Cfg. Registers a thread (ptxas, nvcc 12.9): 158-168 at
//   D=64 with a producer (384 threads), 154 without, 186-195 at D=128 (256
//   threads); K3 156-168, 154 and 186; no spills; one block an SM (145 and
//   161 KB of shared memory).
// The block itself (its layout, loads, products, softmax step and the loop
// over the kv tiles) lives in attention_block.cuh, which K7 and K8 run too;
// this file holds the kernel around it and the host side.

#include <cmath>

#include "attention_block.cuh"

namespace {

// BOUNDED: K3's softmax at the fixed offset bound_log2 (K1 and K6 ignore it);
// DV: the head's values, D or (80, in the D = 128 layout) fewer
template <int D, int MASK, bool PRODUCER, bool BOUNDED, int DV = D>
__global__ void __launch_bounds__(PRODUCER ? 384 : 256, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   bf16* __restrict__ o, const int* __restrict__ q_seg,
                   const int* __restrict__ kv_seg, int Sq, int Skv,
                   long long osb, long long osh, long long oss,
                   int kv_end, int causal, float scale_log2,
                   float bound_log2) {
  extern __shared__ uint8_t smem_raw[];
  const Ring rg = ring_layout<D>(smem_raw);

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int wg = threadIdx.x >> 7;

  int kv_lim = kv_end;  // columns at or past it are masked for every row
  if (MASK == MASK_GENERAL && causal && q0 + BQ < kv_lim) kv_lim = q0 + BQ;
  const int n_tiles = (kv_lim + BKV - 1) / BKV;

  if (threadIdx.x == 0) ring_init<D>(rg);
  __syncthreads();

  if (PRODUCER && wg == 2) {
    // ---- producer warpgroup: one thread keeps the K and V rings full ----
    if (threadIdx.x == 256 && n_tiles > 0) {
      produce<D>(rg, &qmap, &kmap, &vmap, q0, h, b, n_tiles);
    }
    return;
  }

  // ---- consumers: 64 q rows a warpgroup ----
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = q0 + wg * 64;
  Rows r;
  r.row0 = wg_row0 + warp * 16 + g;
  r.row1 = r.row0 + 8;
  r.qs0 = r.qs1 = 0;
  r.kv_seg = nullptr;
  r.Skv = Skv;
  r.kv_lim = kv_lim;
  r.causal = causal;
  if (MASK == MASK_GENERAL && q_seg != nullptr) {
    r.qs0 = r.row0 < Sq ? q_seg[(long long)b * Sq + r.row0] : 0;
    r.qs1 = r.row1 < Sq ? q_seg[(long long)b * Sq + r.row1] : 0;
    r.kv_seg = kv_seg + (long long)b * Skv;
  }
  // does kv tile j need the compare at all?
  auto needs_mask = [&](int j) {
    if (MASK == MASK_TAIL) return j == n_tiles - 1;
    if (MASK == MASK_GENERAL) {
      return r.kv_seg != nullptr || (j + 1) * BKV > kv_lim ||
             (causal && (j + 1) * BKV - 1 > wg_row0);
    }
    return false;
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = M_FLOOR, m1 = M_FLOOR, l0 = 0.f, l1 = 0.f;

  if (n_tiles > 0) {
    const Tiles tl = {&qmap, &kmap, &vmap, q0, h, b, n_tiles, 0, 0,
                      scale_log2, bound_log2};
    // K3 at D=64 and every instance at DV=80 sum the bf16-rounded p, as
    // the TPU kernel's ones column
    constexpr bool ROUNDED = DV != D || (BOUNDED && D % 128 != 0);
    attend_tiles<D, MASK, PRODUCER, false, ROUNDED, BOUNDED>(
        rg, tl, r, needs_mask, acc, m0, m1, l0, l1);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_rows<D, DV>(acc, l0 > 0.f ? l0 : 1.f, l1 > 0.f ? l1 : 1.f,
                o + b * osb + h * osh, oss, r.row0, r.row1, Sq, t);
}

// ---- host side ------------------------------------------------------------------

struct Call {
  const void *q, *k, *v;
  void* o;
  const int *q_seg, *kv_seg;
  int B, H, Sq, Skv;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int kv_end, causal;
  float scale_log2, bound_log2;
  cudaStream_t stream;
};

template <int D, int MASK, bool PRODUCER, bool BOUNDED, int DV>
int launch_layout(const Call& c) {
  CUtensorMap qmap = {}, kmap = {}, vmap = {};
  if (c.kv_end > 0) {  // with no key in sight the block loads nothing
    if (!make_map(&qmap, c.q, DV, c.Sq, c.H, c.B, c.qss, c.qsh, c.qsb) ||
        !make_map(&kmap, c.k, DV, c.Skv, c.H, c.B, c.kss, c.ksh, c.ksb) ||
        !make_map(&vmap, c.v, DV, c.Skv, c.H, c.B, c.vss, c.vsh, c.vsb)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  auto kernel = flash_wgmma_kernel<D, MASK, PRODUCER, BOUNDED, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<D>::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c.Sq + BQ - 1) / BQ, c.H, c.B);
  kernel<<<grid, PRODUCER ? 384 : 256, Cfg<D>::SMEM_BYTES, c.stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(c.o), c.q_seg, c.kv_seg, c.Sq,
      c.Skv, c.osb, c.osh, c.oss, c.kv_end, c.causal, c.scale_log2,
      c.bound_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MASK, bool BOUNDED, int DV = D>
int launch_instance(const Call& c) {
  if constexpr (D == 64) {
    if (c.kv_end > Cfg<D>::STAGES * BKV) {
      return launch_layout<D, MASK, true, BOUNDED, DV>(c);
    }
  }
  return launch_layout<D, MASK, false, BOUNDED, DV>(c);
}

// mask_kind is the caller's choice (ops/flash_attention.py::mask_kind); a
// kind that masks less than the call needs is refused
template <bool BOUNDED>
int launch(const Call& c, int D, int kv_valid, int mask_kind) {
  if (c.Sq <= 0 || c.B <= 0 || c.H <= 0) return cudaGetLastError();
  Call call = c;
  call.kv_end = c.Skv;
  if (kv_valid >= 0 && kv_valid < call.kv_end) call.kv_end = kv_valid;
  int need = MASK_NONE;
  if (call.kv_end % BKV != 0) need = MASK_TAIL;
  if (c.q_seg != nullptr || c.causal) need = MASK_GENERAL;
  if (mask_kind < need || mask_kind > MASK_GENERAL ||
      !(c.scale_log2 > 0.f) || (c.q_seg == nullptr) != (c.kv_seg == nullptr) ||
      (BOUNDED && !std::isfinite(c.bound_log2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (D == 64) {
    if (mask_kind == MASK_NONE) {
      return launch_instance<64, MASK_NONE, BOUNDED>(call);
    }
    if (mask_kind == MASK_TAIL) {
      return launch_instance<64, MASK_TAIL, BOUNDED>(call);
    }
    return launch_instance<64, MASK_GENERAL, BOUNDED>(call);
  }
  if (D == 128) {
    if (mask_kind == MASK_NONE) {
      return launch_instance<128, MASK_NONE, BOUNDED>(call);
    }
    if (mask_kind == MASK_TAIL) {
      return launch_instance<128, MASK_TAIL, BOUNDED>(call);
    }
    return launch_instance<128, MASK_GENERAL, BOUNDED>(call);
  }
  if (D == 80) {  // the D = 128 layout, 80 columns loaded and stored
    if (mask_kind == MASK_NONE) {
      return launch_instance<128, MASK_NONE, BOUNDED, 80>(call);
    }
    if (mask_kind == MASK_TAIL) {
      return launch_instance<128, MASK_TAIL, BOUNDED, 80>(call);
    }
    return launch_instance<128, MASK_GENERAL, BOUNDED, 80>(call);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K1: q, k, v and out [B, H, S, D] views with element strides (b, h, s) and a
// unit last stride, D 64, 80 or 128; kv_valid -1 = none; mask_kind 0 none,
// 1 tail, 2 general
extern "C" int k1_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o,
    const void* q_seg, const void* kv_seg,
    int B, int H, int Sq, int Skv, int D,
    int qsb, int qsh, int qss, int ksb, int ksh, int kss,
    int vsb, int vsh, int vss, int osb, int osh, int oss,
    int kv_valid, int causal, int mask_kind, float scale_log2, void* stream) {
  const Call c = {q, k, v, o, static_cast<const int*>(q_seg),
                  static_cast<const int*>(kv_seg), B, H, Sq, Skv,
                  qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                  0, causal, scale_log2, 0.f,
                  static_cast<cudaStream_t>(stream)};
  return launch<false>(c, D, kv_valid, mask_kind);
}

// K3: K1's arguments, then bound_log2 = score_bound * log2(e)
extern "C" int k3_flash_attention_bounded_bf16(
    const void* q, const void* k, const void* v, void* o,
    const void* q_seg, const void* kv_seg,
    int B, int H, int Sq, int Skv, int D,
    int qsb, int qsh, int qss, int ksb, int ksh, int kss,
    int vsb, int vsh, int vss, int osb, int osh, int oss,
    int kv_valid, int causal, int mask_kind, float scale_log2,
    float bound_log2, void* stream) {
  const Call c = {q, k, v, o, static_cast<const int*>(q_seg),
                  static_cast<const int*>(kv_seg), B, H, Sq, Skv,
                  qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                  0, causal, scale_log2, bound_log2,
                  static_cast<cudaStream_t>(stream)};
  return launch<true>(c, D, kv_valid, mask_kind);
}

// K6: q and out [B, S, H*D], k and v [B, Skv, H*D], each with a unit last
// stride and its own batch and token strides (a slice of a fused q/k/v
// projection is read in place); head h starts D*h values into a token's row
extern "C" int k6_flash_attention_hp_bf16(
    const void* q, const void* k, const void* v, void* o,
    int B, int S, int Skv, int H, int D,
    int qsb, int qss, int ksb, int kss, int vsb, int vss, int osb, int oss,
    int kv_valid, int mask_kind, float scale_log2, void* stream) {
  if (D != 64 && D != 128) {  // JAX's hp gate: d in (64, 128)
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Call c = {q, k, v, o, nullptr, nullptr, B, H, S, Skv,
                  qsb, D, qss, ksb, D, kss, vsb, D, vss, osb, D, oss,
                  0, 0, scale_log2, 0.f, static_cast<cudaStream_t>(stream)};
  return launch<false>(c, D, kv_valid, mask_kind);
}
