// K4: int8 flash attention forward for sm_90a, in the two int8 tiers of
// the JAX package: int8 Q.K^T with int8 P.V ("pallas_int8pv"), or int8
// Q.K^T with bf16 P.V ("pallas_int8").
//
// Replaces the qk_int8 / pv_int8 branches of the Pallas TPU kernel
// ltx_video_gpupoor_tpu/ops/flash_attention.py::_flash_kernel (reached
// through flash_attention, :412 -> pl.pallas_call :631): the int8 scores
// (:218-239), the int8 P.V (:270-292), the x127 exponent fold (:321-327)
// and the finalize (:393-401). The quantize prologue (:484-533) runs
// before the launch as plain torch ops (ops/flash_attention.py,
// int8_prologue), shared with the plain version.
//
// Inputs are the prologue's int8 q and k ([B, H, S, D], any strides with
// a unit last one), v int8 (QK+PV tier) or bf16 (QK tier), fp32 q scales
// [B, H, Sq] with scale*log2(e) folded in, fp32 k scales with one entry
// per `ks_block` kv rows ([B, H, nks]: per kv block of the JAX kernel in
// the QK+PV tier, per row in the QK tier), and in the QK+PV tier fp32 v
// scales [B, H, D] (JAX's v_scale * 127). Masks as in K1: a kv_valid
// tail, segment ids (attend iff q_seg == kv_seg and kv_seg > 0), causal;
// rows that see no key return 0. D in {64, 128}, any Sq and Skv.
//
// Math per kv tile, as in JAX: s = s32 * (qs * ks) (QK+PV) or
// (s32 * qs) * ks (QK); online softmax in the exp2 domain with the
// running max m; in the QK+PV tier p = exp2(s - (m - log2 127)) lies in
// [0, 127] and rounds half to even to an int8 code p8, and
// acc = acc * alpha + (p8 . v8) * v_scale. The denominator l sums the
// fp32 p, or, where JAX's head dim is not a 128 multiple (its ones column
// of V, "sum_col"), the rounded p: 127 * sum(p8) * SUM_COL_SCALE in the
// QK+PV tier, sum(bf16(p)) in the QK tier. o = acc / l.
// One difference by design: JAX updates its running max once per kv
// block (4096 rows at the Wan shape), this kernel once per 64-row tile,
// so p is quantized against a different max and the two agree to int8
// noise, not bit for bit.
//
// What bounds it on an H100: at the Wan 2.1 1.3B self-attention shape
// (B=2, H=12, S=32760, D=128) it is bound by the tensor cores and the
// softmax's exp2/max/round work on the CUDA cores, not by memory: each
// K/V tile is reused by the 64 q rows of a block and the tiles of a head
// stay in L2.
// Design: K3's layout (flash_attention.cu) with int8 operands. One block of 4 warps per (q
// tile of 64 rows, head, batch); each warp owns 16 q rows whose int8 Q
// fragments stay in registers. K tiles go to shared memory as rows; both
// products run on mma.sync m16n8k32 s8 with s32 accumulation. The s32
// score accumulator's layout is not the int8 A-fragment layout, so P is
// not staged: the kv order inside each 32-row chunk is permuted so that
// the scores a thread already holds (columns 8j + 2t + {0,1}) are exactly
// its A-fragment columns, and V is written transposed ([D][kv], ldmatrix
// has no 8-bit transpose) in that same permuted order, 4x4 bytes at a
// time with byte permutes. In the QK tier P.V is K3's bf16 m16n8k16 path.
// Simple first version: no wgmma, TMA or warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;        // q rows per block: 4 warps x 16
constexpr int BKV = 64;       // kv rows per tile
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;
constexpr float LOG2_127 = 6.9886846867721655f;
// the scale that JAX's ones column of V carries into the denominator in
// the QK+PV tier: float32(float32(1/127)^2 * 127), which is float32(1/127)
constexpr float SUM_COL_SCALE = 0.007874015718698502f;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_h(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// p in [0, 127] -> int8 code, round half to even (jnp.round)
__device__ __forceinline__ int code8(float p) {
  return min(max(__float2int_rn(p), 0), 127);
}

__device__ __forceinline__ uint32_t pack4(int c0, int c1, int c2, int c3) {
  return static_cast<uint32_t>(c0) | (static_cast<uint32_t>(c1) << 8) |
         (static_cast<uint32_t>(c2) << 16) | (static_cast<uint32_t>(c3) << 24);
}

// rows [row0, row0 + 64) of a slice with `ROWB` bytes per row and row
// stride `ss` bytes into a shared tile of `LDB` bytes per row; rows past
// `nrows` are zero
template <int ROWB, int LDB>
__device__ __forceinline__ void load_rows(uint8_t* dst, const uint8_t* src,
                                          long long ss, int row0, int nrows) {
  constexpr int CPR = ROWB / 16;
  for (int i = threadIdx.x; i < BKV * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nrows) {
      val = *reinterpret_cast<const uint4*>(src + gr * ss + c * 16);
    }
    *reinterpret_cast<uint4*>(dst + r * LDB + c * 16) = val;
  }
}

// an int8 V tile [64 kv, D] -> Vt [D][LDVT] in the permuted kv order: the
// logical column t*4 + i (+16) of a 32-row chunk holds physical kv row
// 2t + {0, 1, 8, 9}[i] (+16), the order in which a thread holds its score
// columns. Each step moves a 4 (kv) x 4 (d) byte block: four 32-bit loads
// of four kv rows, a byte transpose, four 32-bit stores of four d rows.
template <int D, int LDVT>
__device__ __forceinline__ void load_vt(uint8_t* dst, const uint8_t* src,
                                        long long ss, int row0, int nrows) {
  constexpr int NQ = BKV / 4;  // logical kv quads
  for (int i = threadIdx.x; i < NQ * (D / 4); i += NTHREADS) {
    const int lq = i % NQ, dq = i / NQ;
    const int rb = (lq >> 2) * 16 + 2 * (lq & 3);  // chunk*32 + hi*16 + 2t
    const int rows[4] = {rb, rb + 1, rb + 8, rb + 9};
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gr = row0 + rows[r];
      w[r] = gr < nrows ? ld32(src + gr * ss + dq * 4) : 0u;
    }
    const uint32_t x01l = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t x01h = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t x23l = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t x23h = __byte_perm(w[2], w[3], 0x7362);
    uint8_t* out = dst + (dq * 4) * LDVT + lq * 4;
    *reinterpret_cast<uint32_t*>(out) = __byte_perm(x01l, x23l, 0x5410);
    *reinterpret_cast<uint32_t*>(out + LDVT) = __byte_perm(x01l, x23l, 0x7632);
    *reinterpret_cast<uint32_t*>(out + 2 * LDVT) =
        __byte_perm(x01h, x23h, 0x5410);
    *reinterpret_cast<uint32_t*>(out + 3 * LDVT) =
        __byte_perm(x01h, x23h, 0x7632);
  }
}

template <int D, bool PV8>
__global__ void __launch_bounds__(NTHREADS)
flash_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                  const void* __restrict__ vptr, bf16* __restrict__ o,
                  const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                  const float* __restrict__ qscale,
                  const float* __restrict__ kscale,
                  const float* __restrict__ vscale,
                  int Sq, int Skv,
                  long long qsb, long long qsh, long long qss,
                  long long ksb, long long ksh, long long kss,
                  long long vsb, long long vsh, long long vss,
                  long long osb, long long osh, long long oss,
                  int ks_block, int nks, int kv_valid, int causal) {
  constexpr bool SUM_ROUNDED = D % 128 != 0;  // JAX's sum_col
  constexpr int LDK = D + 16;     // bytes per shared K row
  constexpr int LDVT = BKV + 16;  // bytes per shared V^T row (QK+PV)
  constexpr int LDV = D + 8;      // bf16 per shared V row (QK)
  constexpr int KD = D / 32;      // k32 steps over the head dim
  constexpr int ND = D / 8;       // n8 tiles over the head dim
  constexpr int NS = BKV / 8;     // n8 tiles over the kv tile
  __shared__ __align__(16) uint8_t Ks[BKV * LDK];
  __shared__ __align__(16) uint8_t Vt[PV8 ? D * LDVT : 16];
  __shared__ __align__(16) bf16 Vs[PV8 ? 8 : BKV * LDV];
  __shared__ int kseg_s[BKV];
  __shared__ float ksc_s[BKV];

  const int b = blockIdx.z, h = blockIdx.y;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;

  const uint8_t* qb = reinterpret_cast<const uint8_t*>(q) + b * qsb + h * qsh;
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(k) + b * ksb + h * ksh;
  const bool has_seg = q_seg != nullptr;
  int qs0 = 0, qs1 = 0;
  if (has_seg) {
    qs0 = row0 < Sq ? q_seg[(long long)b * Sq + row0] : 0;
    qs1 = row1 < Sq ? q_seg[(long long)b * Sq + row1] : 0;
  }
  const float qsc0 = row0 < Sq ? qscale[bh * Sq + row0] : 0.f;
  const float qsc1 = row1 < Sq ? qscale[bh * Sq + row1] : 0.f;

  // Q fragments (m16n8k32 A: rows g / g+8, bytes 4t..4t+3 and +16),
  // staged through the K tile's shared memory
  load_rows<D, LDK>(Ks, qb, qss, q0, Sq);
  __syncthreads();
  uint32_t qf[KD][4];
  {
    const uint8_t* r0p = Ks + (warp * 16 + g) * LDK + t * 4;
    const uint8_t* r1p = r0p + 8 * LDK;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][0] = ld32(r0p + kk * 32);
      qf[kk][1] = ld32(r1p + kk * 32);
      qf[kk][2] = ld32(r0p + kk * 32 + 16);
      qf[kk][3] = ld32(r1p + kk * 32 + 16);
    }
  }

  // per-channel v scales of this thread's output columns (QK+PV)
  float vsc[PV8 ? ND : 1][2];
  if constexpr (PV8) {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      vsc[n][0] = vscale[bh * D + n * 8 + t * 2];
      vsc[n][1] = vscale[bh * D + n * 8 + t * 2 + 1];
    }
  }

  int kv_end = Skv;
  if (kv_valid >= 0 && kv_valid < kv_end) kv_end = kv_valid;
  if (causal && q0 + BQ < kv_end) kv_end = q0 + BQ;

  float m0 = M_FLOOR, m1 = M_FLOOR, l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // every warp is done with the previous tile
    load_rows<D, LDK>(Ks, kb, kss, kv0, Skv);
    if constexpr (PV8) {
      const uint8_t* vb = reinterpret_cast<const uint8_t*>(vptr) +
                          b * vsb + h * vsh;
      load_vt<D, LDVT>(Vt, vb, vss, kv0, Skv);
    } else {
      const uint8_t* vb = reinterpret_cast<const uint8_t*>(vptr) +
                          2 * (b * vsb + h * vsh);
      load_rows<2 * D, 2 * LDV>(reinterpret_cast<uint8_t*>(Vs), vb, 2 * vss,
                                kv0, Skv);
    }
    for (int i = threadIdx.x; i < BKV; i += NTHREADS) {
      const int c = kv0 + i;
      kseg_s[i] = has_seg && c < Skv ? kv_seg[(long long)b * Skv + c] : 0;
      ksc_s[i] = c < Skv ? kscale[bh * nks + c / ks_block] : 0.f;
    }
    __syncthreads();

    int s32[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s32[j][0] = s32[j][1] = s32[j][2] = s32[j][3] = 0;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const uint8_t* kp = Ks + (j * 8 + g) * LDK + kk * 32 + t * 4;
        mma_s8(s32[j], qf[kk], ld32(kp), ld32(kp + 16));
      }
    }

    // dequantize into the exp2 domain and mask
    float s[NS][4];
    float mx0 = NEG_INF, mx1 = NEG_INF;
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
        const float qv = e < 2 ? qsc0 : qsc1;
        const float sf = static_cast<float>(s32[j][e]);
        const float val = PV8 ? sf * (qv * ksc_s[cl]) : (sf * qv) * ksc_s[cl];
        s[j][e] = ok ? val : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // x127 fold: in the QK+PV tier p lives in [0, 127], the int8 grid
    const float off0 = PV8 ? mn0 - LOG2_127 : mn0;
    const float off1 = PV8 ? mn1 - LOG2_127 : mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2f(s[j][0] - off0);
      s[j][1] = exp2f(s[j][1] - off0);
      s[j][2] = exp2f(s[j][2] - off1);
      s[j][3] = exp2f(s[j][3] - off1);
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }

    if constexpr (PV8) {
      // P as int8 A fragments straight from the score registers: chunk
      // c covers score tiles 4c..4c+3, logical column t*4 + i is tile
      // 4c + i/2 element i%2 (rows g: elements 0,1; rows g+8: 2,3)
      uint32_t pa[BKV / 32][4];
      int is0 = 0, is1 = 0;
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        int cd[4][4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) cd[jj][e] = code8(s[4 * c + jj][e]);
          is0 += cd[jj][0] + cd[jj][1];
          is1 += cd[jj][2] + cd[jj][3];
        }
        pa[c][0] = pack4(cd[0][0], cd[0][1], cd[1][0], cd[1][1]);
        pa[c][1] = pack4(cd[0][2], cd[0][3], cd[1][2], cd[1][3]);
        pa[c][2] = pack4(cd[2][0], cd[2][1], cd[3][0], cd[3][1]);
        pa[c][3] = pack4(cd[2][2], cd[2][3], cd[3][2], cd[3][3]);
      }
      if constexpr (SUM_ROUNDED) {
        ls0 = static_cast<float>(is0 * 127) * SUM_COL_SCALE;
        ls1 = static_cast<float>(is1 * 127) * SUM_COL_SCALE;
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          ls0 += s[j][0] + s[j][1];
          ls1 += s[j][2] + s[j][3];
        }
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        int pv[4] = {0, 0, 0, 0};
        const uint8_t* vp = Vt + (n * 8 + g) * LDVT + t * 4;
#pragma unroll
        for (int c = 0; c < BKV / 32; ++c) {
          mma_s8(pv, pa[c], ld32(vp + c * 32), ld32(vp + c * 32 + 16));
        }
        acc[n][0] += static_cast<float>(pv[0]) * vsc[n][0];
        acc[n][1] += static_cast<float>(pv[1]) * vsc[n][1];
        acc[n][2] += static_cast<float>(pv[2]) * vsc[n][0];
        acc[n][3] += static_cast<float>(pv[3]) * vsc[n][1];
      }
    } else {
      // QK tier: K3's bf16 P.V, P from the score registers
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_f(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_f(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_f(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_f(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        if constexpr (SUM_ROUNDED) {  // l sums the bf16 p that P.V multiplies
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const __nv_bfloat162 pr = *reinterpret_cast<__nv_bfloat162*>(&pa[r]);
            const float sum = __low2float(pr) + __high2float(pr);
            if (r & 1) ls1 += sum; else ls0 += sum;
          }
        }
        const bf16* vp = Vs + (kk * 16 + t * 2) * LDV + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const bf16* vn = vp + n * 8;
          const uint32_t b0 = pack_h(vn[0], vn[LDV]);
          const uint32_t b1 = pack_h(vn[8 * LDV], vn[9 * LDV]);
          mma_bf16(acc[n], pa, b0, b1);
        }
      }
      if constexpr (!SUM_ROUNDED) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          ls0 += s[j][0] + s[j][1];
          ls1 += s[j][2] + s[j][3];
        }
      }
    }
    l0 = l0 * a0 + ls0;  // per-thread partial sums; reduced at the end
    l1 = l1 * a1 + ls1;
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

template <int D, bool PV8>
void launch(dim3 grid, cudaStream_t st, const void* q, const void* k,
            const void* v, void* o, const void* q_seg, const void* kv_seg,
            const void* qsc, const void* ksc, const void* vsc, int Sq, int Skv,
            int qsb, int qsh, int qss, int ksb, int ksh, int kss,
            int vsb, int vsh, int vss, int osb, int osh, int oss,
            int ks_block, int nks, int kv_valid, int causal) {
  flash_int8_kernel<D, PV8><<<grid, NTHREADS, 0, st>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k), v,
      static_cast<bf16*>(o), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), static_cast<const float*>(qsc),
      static_cast<const float*>(ksc), static_cast<const float*>(vsc), Sq, Skv,
      qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, ks_block,
      nks, kv_valid, causal);
}

}  // namespace

extern "C" int k4_flash_attention_int8(
    const void* q, const void* k, const void* v, void* o,
    const void* q_seg, const void* kv_seg,
    const void* q_scale, const void* k_scale, const void* v_scale,
    int B, int H, int Sq, int Skv, int D,
    int qsb, int qsh, int qss, int ksb, int ksh, int kss,
    int vsb, int vsh, int vss, int osb, int osh, int oss,
    int ks_block, int nks, int kv_valid, int causal, int pv_int8,
    void* stream) {
  if (Sq <= 0 || B <= 0 || H <= 0) return cudaGetLastError();
  if (ks_block <= 0 || (pv_int8 && v_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K4_ARGS                                                              \
  grid, st, q, k, v, o, q_seg, kv_seg, q_scale, k_scale, v_scale, Sq, Skv,   \
      qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss, ks_block,  \
      nks, kv_valid, causal
  if (D == 64 && pv_int8) {
    launch<64, true>(K4_ARGS);
  } else if (D == 64) {
    launch<64, false>(K4_ARGS);
  } else if (D == 128 && pv_int8) {
    launch<128, true>(K4_ARGS);
  } else if (D == 128) {
    launch<128, false>(K4_ARGS);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K4_ARGS
  return static_cast<int>(cudaGetLastError());
}
