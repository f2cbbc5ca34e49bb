// K8: flash attention forward whose kv tile is cut into sub-blocks, with the
// Q.K^T of sub-block t+1 issued before the softmax of sub-block t, bf16,
// for sm_90a.
//
// Replaces the Pallas TPU kernel tools/mb_selfattn_pipeline.py::_kernel
// (reached through pipelined_attention, :81 -> pl.pallas_call :93), an
// experiment beside the production kernel (K1): does giving the scheduler
// independent matrix work to interleave with the exponentials move an
// attention kernel?
//
// Computes o = softmax(q k^T / sqrt(D)) v over [B, H, S, D] views (any
// strides with a unit last stride), D = 64, no mask, S a multiple of the kv
// tile. The contract is the TPU kernel's, rounding for rounding: q is
// multiplied by D**-0.5 * log2(e) in fp32 and rounded to bf16 once; the
// scores are fp32; the running max (from -1e20) and the rescale are taken
// per sub-block; p = exp2(s - m) meets V as bf16; the denominator is the sum
// of those bf16-rounded p (on the TPU a ones column of V collects it).
//
// What was chosen here. The TPU's 768 x 2688 blocks answer its VMEM; here a
// block of 4 warps owns 64 q rows (16 a warp, as K1) and walks kv tiles of
// BKV = 128 rows held in shared memory (K and V, rows padded by 16 bytes),
// cut into NSUB = 1, 2, 4 or 8 sub-blocks of 128, 64, 32 or 16 rows; 16 is
// one mma.sync depth of P.V. A 64-row tile (NSUB 1, 2, 4) serves lengths
// that 128 does not divide. NSUB and BKV are template values, so the loop
// over sub-blocks is unrolled and both score fragments (this sub-block's
// and the next one's) live in registers. The order of issue is the point:
// the mma.sync group of sub-block t+1 stands in the source before the max,
// exp2 and P.V of sub-block t. As on the TPU the overlap stops at the tile's
// edge: the first Q.K^T of a tile waits for the tile's loads.
//
// What bounds it on an H100: as K1 at D=64, the tensor cores and the
// softmax's exp2 and max work, not memory. Everything else (synchronous
// tile loads, mma.sync m16n8k16, V fragments read by scalar loads) is K1's,
// so that the two differ in the order of issue alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;
constexpr int BQ = 64;        // q rows per block: 4 warps x 16
constexpr int NTHREADS = 128;
constexpr int LD = D + 8;     // padded shared row
constexpr int KD = D / 16;    // k16 steps over the head dim
constexpr int ND = D / 8;     // n8 tiles over the head dim
constexpr float M_FLOOR = -1e20f;

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

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_h(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// `rows` rows from row0 of a [S, D] slice with row stride `ss` into a padded
// shared tile; with SCALE each value is multiplied by c in fp32 and rounded
// back to bf16 (the q prologue)
template <bool SCALE>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss, int row0, int rows,
                                          float c) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CPR; i += NTHREADS) {
    const int r = i / CPR, ch = i % CPR;
    uint4 val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + ch * 8);
    if (SCALE) {
      bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * c);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + ch * 8) = val;
  }
}

// scores of one sub-block: s[j] (n8 tile j of its BSUB rows) = q k^T
template <int NSB>
__device__ __forceinline__ void qk_sub(float (&s)[NSB][4],
                                       const uint32_t (&qf)[KD][4],
                                       const bf16* ks, int g, int t) {
#pragma unroll
  for (int j = 0; j < NSB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int j = 0; j < NSB; ++j) {
      const bf16* kp = ks + (j * 8 + g) * LD + kk * 16 + t * 2;
      mma16816(s[j], qf[kk], ld32(kp), ld32(kp + 8));
    }
  }
}

template <int BKV, int NSUB>
__global__ void __launch_bounds__(NTHREADS)
flash_pipelined_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int S,
                       long long qsb, long long qsh, long long qss,
                       long long ksb, long long ksh, long long kss,
                       long long vsb, long long vsh, long long vss,
                       long long osb, long long osh, long long oss,
                       float c) {
  constexpr int BSUB = BKV / NSUB;  // kv rows per sub-block
  constexpr int NSB = BSUB / 8;     // n8 tiles of scores per sub-block
  static_assert(BSUB % 16 == 0, "a sub-block is a multiple of one P.V depth");
  __shared__ __align__(16) bf16 Ks[BKV * LD];
  __shared__ __align__(16) bf16 Vs[BKV * LD];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;

  // q * (D**-0.5 * log2 e), rounded to bf16, staged through the K tile
  load_tile<true>(Ks, qb, qss, q0, BQ, c);
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

  float m0 = M_FLOOR, m1 = M_FLOOR, l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<false>(Ks, kb, kss, kv0, BKV, 0.f);
    load_tile<false>(Vs, vb, vss, kv0, BKV, 0.f);
    __syncthreads();

    // two score fragments: sub-block u in s[u & 1] (at NSUB = 1 the second
    // is never touched and takes no register)
    float s[2][NSB][4];
    qk_sub<NSB>(s[0], qf, Ks, g, t);
#pragma unroll
    for (int u = 0; u < NSUB; ++u) {
      float (&sc)[NSB][4] = s[u & 1];
      if (u + 1 < NSUB) {
        // the next sub-block's Q.K^T, issued before this one's softmax
        qk_sub<NSB>(s[(u + 1) & 1], qf, Ks + (u + 1) * BSUB * LD, g, t);
      }
      float mx0 = sc[0][0], mx1 = sc[0][2];
#pragma unroll
      for (int j = 0; j < NSB; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < NSB; ++j) {
        // p as the product sees it: the denominator sums the rounded p
        sc[j][0] = round_bf16(exp2f(sc[j][0] - mn0));
        sc[j][1] = round_bf16(exp2f(sc[j][1] - mn0));
        sc[j][2] = round_bf16(exp2f(sc[j][2] - mn1));
        sc[j][3] = round_bf16(exp2f(sc[j][3] - mn1));
        ls0 += sc[j][0] + sc[j][1];
        ls1 += sc[j][2] + sc[j][3];
      }
      l0 = l0 * a0 + ls0;  // per-thread partial sums; reduced at the end
      l1 = l1 * a1 + ls1;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= a0;
        acc[n][1] *= a0;
        acc[n][2] *= a1;
        acc[n][3] *= a1;
      }
      // acc += P V over this sub-block's rows, P from the score registers
#pragma unroll
      for (int kk = 0; kk < BSUB / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_f(sc[2 * kk][0], sc[2 * kk][1]);
        pa[1] = pack_f(sc[2 * kk][2], sc[2 * kk][3]);
        pa[2] = pack_f(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[3] = pack_f(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
        const bf16* vp = Vs + (u * BSUB + kk * 16 + t * 2) * LD + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const bf16* vn = vp + n * 8;
          const uint32_t b0 = pack_h(vn[0], vn[LD]);
          const uint32_t b1 = pack_h(vn[8 * LD], vn[9 * LD]);
          mma16816(acc[n], pa, b0, b1);
        }
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
    const int col = n * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(ob + row0 * oss + col) =
        pack_f(acc[n][0] / d0, acc[n][1] / d0);
    *reinterpret_cast<uint32_t*>(ob + row1 * oss + col) =
        pack_f(acc[n][2] / d1, acc[n][3] / d1);
  }
}

}  // namespace

#define K8_LAUNCH(BKV_, NSUB_)                                               \
  flash_pipelined_kernel<BKV_, NSUB_><<<grid, NTHREADS, 0, st>>>(            \
      qp, kp, vp, op, S, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb,   \
      osh, oss, c)

// q, k, v, out [B, H, S, 64] bf16 with a unit last stride; block_kv 128
// (nsub 1, 2, 4, 8) or 64 (nsub 1, 2, 4); S a multiple of block_kv;
// c = 64**-0.5 * log2(e)
extern "C" int k8_flash_attention_pipelined_bf16(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int S, int Dh,
    int qsb, int qsh, int qss, int ksb, int ksh, int kss,
    int vsb, int vsh, int vss, int osb, int osh, int oss,
    int block_kv, int nsub, float c, void* stream) {
  if (Dh != D || S <= 0 || B <= 0 || H <= 0 || S % BQ || S % block_kv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(S / BQ, H, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  const int key = block_kv * 16 + nsub;
  switch (key) {
    case 128 * 16 + 1: K8_LAUNCH(128, 1); break;
    case 128 * 16 + 2: K8_LAUNCH(128, 2); break;
    case 128 * 16 + 4: K8_LAUNCH(128, 4); break;
    case 128 * 16 + 8: K8_LAUNCH(128, 8); break;
    case 64 * 16 + 1: K8_LAUNCH(64, 1); break;
    case 64 * 16 + 2: K8_LAUNCH(64, 2); break;
    case 64 * 16 + 4: K8_LAUNCH(64, 4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
