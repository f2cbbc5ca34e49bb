// K3: flash attention forward with bounded scores, bf16, for sm_90a.
//
// Replaces the bounded-score branch (:294-313) of the Pallas TPU kernel
// ltx_video_gpupoor_tpu/ops/flash_attention.py::_flash_kernel (reached
// through flash_attention, :412 -> pl.pallas_call :631). The exact tier of
// that kernel (K1) and the head-packed kernel (K6) are
// flash_attention_wgmma.cu.
//
// Computes o = sum_j p_j v_j / sum_j p_j with p = exp2(min(s, sb) - sb), s =
// q k^T * scale * log2(e) and the fixed offset sb = bound * log2(e), over
// [B, H, S, D] views (any strides with a unit last stride), D in {64, 128},
// any Sq and Skv. Masks: a static kv_valid tail, segment ids (attend iff
// q_seg == kv_seg and kv_seg > 0) and causal. There is no running max, so no
// per-tile row max, no rescale factor and no rescale of the accumulator. A
// masked score stays at NEG_INF, whose exp2 is exactly 0 (as on the TPU); the
// min() keeps a score over the bound finite; a row that sees no key returns
// 0. The denominator is the plain sum of p in fp32 at D=128 and the sum of
// the bf16-rounded p at D=64, where the TPU kernel reads it off a ones column
// of V.
//
// What bounds it on an H100: the tensor cores and the softmax's exp2 work on
// the CUDA cores, not memory (each K/V tile is reused by all 64 q rows of
// the block and all q tiles hit L2).
// Design: one block of 4 warps per (q tile of 64 rows, head, batch); each
// warp owns 16 q rows. The TPU's sequential kv grid axis becomes a loop
// over 64-row kv tiles inside the block. Q fragments stay in registers
// for the whole loop; K and V tiles go through shared memory (rows padded
// by 16 bytes so the fragment reads are free of bank conflicts); QK^T and
// PV run on mma.sync m16n8k16 bf16 with fp32 accumulation, and the scores
// of QK^T are reused in registers as the A operand of PV. The ragged edge
// is masked in the kernel, so no sequence padding is needed. This is the
// simple first version: wgmma, TMA and warp specialisation come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;        // q rows per block: 4 warps x 16
constexpr int BKV = 64;       // kv rows per tile
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats -> bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_h(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// rows [row0, row0 + 64) of a [S, D] slice with row stride `ss` into a
// padded shared tile; rows past `nrows` are zero
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss, int row0, int nrows) {
  constexpr int LD = D + 8;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BKV * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows) {
      val = *reinterpret_cast<const uint4*>(src + gr * ss + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// Blocks an SM: at D=128 three (168 registers a thread is the most that
// lets three 128-thread blocks share the 65536 registers; left alone, the
// kernel takes 174 and runs two), at D=64 four (128 registers;
// told only "three", the compiler spends 140-146 and loses the fourth).
template <int D>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 4 : 3)
flash_bounded_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 int Sq, int Skv,
                 long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss,
                 int kv_valid, int causal, float scale_log2,
                 float bound_log2) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;   // k16 steps over the head dim
  constexpr int ND = D / 8;    // n8 tiles over the head dim
  constexpr int NS = BKV / 8;  // n8 tiles over the kv tile
  __shared__ __align__(16) bf16 Ks[BKV * LD];
  __shared__ __align__(16) bf16 Vs[BKV * LD];
  __shared__ int kseg_s[BKV];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;
  const bool has_seg = q_seg != nullptr;
  int qs0 = 0, qs1 = 0;
  if (has_seg) {
    qs0 = row0 < Sq ? q_seg[(long long)b * Sq + row0] : 0;
    qs1 = row1 < Sq ? q_seg[(long long)b * Sq + row1] : 0;
  }

  // Q fragments, staged through the K tile's shared memory
  load_tile<D>(Ks, qb, qss, q0, Sq);
  __syncthreads();
  uint32_t qf[KD][4];
  {
    const bf16* r0p = Ks + (warp * 16 + g) * LD + t * 2;
    const bf16* r1p = r0p + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][0] = ld32(r0p + kk * 16);
      qf[kk][1] = ld32(r1p + kk * 16);
      qf[kk][2] = ld32(r0p + kk * 16 + 8);
      qf[kk][3] = ld32(r1p + kk * 16 + 8);
    }
  }

  int kv_end = Skv;
  if (kv_valid >= 0 && kv_valid < kv_end) kv_end = kv_valid;
  if (causal && q0 + BQ < kv_end) kv_end = q0 + BQ;

  float l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(Ks, kb, kss, kv0, Skv);
    load_tile<D>(Vs, vb, vss, kv0, Skv);
    if (has_seg) {
      for (int i = threadIdx.x; i < BKV; i += NTHREADS) {
        const int c = kv0 + i;
        kseg_s[i] = c < Skv ? kv_seg[(long long)b * Skv + c] : 0;
      }
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const bf16* kp = Ks + (j * 8 + g) * LD + kk * 16 + t * 2;
        mma16816(s[j], qf[kk], ld32(kp), ld32(kp + 8));
      }
    }

    // scale into the exp2 domain, clamp at the bound, mask; the offset is
    // fixed: no running max, no rescale
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = j * 8 + t * 2 + (e & 1);
        const int col = kv0 + cl;
        const int row = e < 2 ? row0 : row1;
        bool ok = col < kv_end;
        if (causal) ok = ok && row >= col;
        if (has_seg) {
          const int ks = kseg_s[cl];
          ok = ok && ks > 0 && ks == (e < 2 ? qs0 : qs1);
        }
        s[j][e] = ok ? fminf(s[j][e] * scale_log2, bound_log2) - bound_log2
                     : NEG_INF;
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e]);
        // at D=64 the denominator sums the bf16 p that the product sees
        if (D == 64) p = __bfloat162float(__float2bfloat16_rn(p));
        s[j][e] = p;
      }
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // acc += P V, with P taken from the score registers
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vp = Vs + (kk * 16 + t * 2) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* vn = vp + n * 8;
        const uint32_t b0 = pack_h(vn[0], vn[LD]);
        const uint32_t b1 = pack_h(vn[8 * LD], vn[9 * LD]);
        mma16816(acc[n], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 > 0.f ? l0 : 1.f;
  const float d1 = l1 > 0.f ? l1 : 1.f;
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + t * 2;
    if (row0 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + row0 * oss + c) =
          pack_f(acc[n][0] / d0, acc[n][1] / d0);
    }
    if (row1 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + row1 * oss + c) =
          pack_f(acc[n][2] / d1, acc[n][3] / d1);
    }
  }
}

}  // namespace

// K3: bound_log2 = score_bound * log2(e)
extern "C" int k3_flash_attention_bounded_bf16(
    const void* q, const void* k, const void* v, void* o,
    const void* q_seg, const void* kv_seg,
    int B, int H, int Sq, int Skv, int D,
    int qsb, int qsh, int qss, int ksb, int ksh, int kss,
    int vsb, int vsh, int vss, int osb, int osh, int oss,
    int kv_valid, int causal, float scale_log2, float bound_log2,
    void* stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  const int* qsg = static_cast<const int*>(q_seg);
  const int* ksg = static_cast<const int*>(kv_seg);
  if (Sq <= 0 || B <= 0 || H <= 0) return cudaGetLastError();
  if (D == 64) {
    flash_bounded_kernel<64><<<grid, NTHREADS, 0, st>>>(
        qp, kp, vp, op, qsg, ksg, Sq, Skv, qsb, qsh, qss, ksb, ksh, kss,
        vsb, vsh, vss, osb, osh, oss, kv_valid, causal, scale_log2,
        bound_log2);
  } else if (D == 128) {
    flash_bounded_kernel<128><<<grid, NTHREADS, 0, st>>>(
        qp, kp, vp, op, qsg, ksg, Sq, Skv, qsb, qsh, qss, ksb, ksh, kss,
        vsb, vsh, vss, osb, osh, oss, kv_valid, causal, scale_log2,
        bound_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
