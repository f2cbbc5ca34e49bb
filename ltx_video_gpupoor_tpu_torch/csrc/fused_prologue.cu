// K5: fused adaLN prologue + dynamic-int8 linear for sm_90a.
//
// Replaces the Pallas TPU kernel
// ltx_video_gpupoor_tpu/ops/fused_prologue.py::_kernel (:104, reached
// through norm_mod_int8_matmul, :129 -> pl.pallas_call :221):
//   rr  = rsqrt(mean(x^2) + eps)                       fp32, over the row
//   h   = bf16(x * rr)
//   h   = bf16(bf16(h * bf16(1 + scale_g)) + shift_g)  g = row / rows_per_group
// (for fp32 activations, FP32_POLICY, the row kernel's other instance: no
// bf16 rounding, each op one IEEE fp32 op; the product is the same)
//   s_x = max(max|h| / 127, 1e-8)
//   h_q = clip(round_half_even(h / s_x), -127, 127)    int8
//   y   = (h_q . w_q) * s_x * s_w (+ bias)             int32 -> fp32 -> bf16
// with w_q the weights of every linear that reads h (q, k, v) side by side,
// so they are one product.
//
// What bounds it on an H100: the product (M 3840 to 15360, K 4096, N 12288
// or 16384) does thousands of int8 operations per byte, so the tensor cores
// bound it; the prologue reads x once (2 bytes a value) and writes 1 byte a
// value, M * K * 3 bytes at 3.35 TB/s (56 us at M=15360, K=4096), bound by
// memory, with about 20 instructions a value close behind (the IEEE
// division of h / s_x is taken only where h * (1 / s_x) lies near a half).
// Design: two launches in one call. The TPU kernel holds whole rows of K in
// VMEM for a 480-row block and recomputes the prologue for every block of
// output columns; a block here has 227 KB, so the rows of a product tile do
// not fit beside it, and recomputing is not worth copying. Instead a row
// kernel writes int8 codes and one scale a row, and K2's GEMM
// (k2_int8_gemm, csrc/int8_linear.cu) runs over the concatenated weights
// with the rescale and bias in its epilogue. The bf16 h never reaches
// device memory; what does is M*K int8 codes.
// The row kernel keeps a row in registers: W warps a row (8 at K=4096),
// each lane holding slots of 16 consecutive values (slot lane + 32 (w + W
// i); one a lane up to K = 4096, up to 8 for K = 32768), read with 16-byte
// loads (two a slot in bf16, four in fp32) and written as 16 int8 codes
// with one 16-byte store. It takes any K, as JAX's tier does: a longer row
// is read three times (the later reads from L2), a K that is not a
// 16-multiple a value at a time, and the codes go to rows of round_up(K,
// 16) bytes with zero codes past K, so that the GEMM runs at that padded
// K over weights with zero columns past K. The sum of squares and the absmax reduce by
// shuffles within each warp, then across the row's warps through shared
// memory; the group's scale and shift rows are
// read once a slot with 16-byte loads and stay in L2. The bf16 instance
// modulates two values an instruction (mul.rn.bf16x2 / add.rn.bf16x2:
// a product or sum of two bf16 values rounded once to bf16 equals the fp32
// op rounded to bf16, and the .rn form is never contracted into an FMA).
// The sum of squares is accumulated in double and rounded to fp32 once,
// so that the mean does not depend on the order of summation; the codes
// are those of the IEEE quotient h / s_x rounded half to even, as the
// plain version's (rint_quotient).

#include <cuda_runtime.h>

#include "row_quant.cuh"

extern "C" int k2_int8_gemm(const void* xq, const void* w, int M, int N, int K,
                            const void* sx, const void* sw, const void* bias,
                            void* out, int out_mode, void* stream);

namespace {

constexpr int MAX_SLOT_K = 32768;   // the longest row held in registers

__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// h = bf16(x * rr), then h = bf16(bf16(h * bf16(1 + s)) + t), two values
// an instruction; returns max |h| of the slot
__device__ __forceinline__ float modulate(Slot<bf16>& x, const Slot<bf16>& s,
                                          const Slot<bf16>& t, float rr) {
  constexpr uint32_t ONE2 = 0x3F803F80u;  // bf16x2 (1, 1)
  uint32_t amax2 = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t h = bf2_pack(x.at(2 * i) * rr, x.at(2 * i + 1) * rr);
    h = bf2_add(bf2_mul(h, bf2_add(ONE2, s.w[i])), t.w[i]);
    x.w[i] = h;
    amax2 = bf2_max(amax2, h & 0x7fff7fffu);  // |h| of each half
  }
  return fmaxf(__uint_as_float(amax2 << 16),
               __uint_as_float(amax2 & 0xffff0000u));
}

// fp32 activations (FP32_POLICY): each op one IEEE fp32 op, never
// contracted into an FMA, as PyTorch's separate elementwise ops compute it
__device__ __forceinline__ float modulate(Slot<float>& x, const Slot<float>& s,
                                          const Slot<float>& t, float rr) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float h = __fadd_rn(__fmul_rn(x.f[i] * rr, __fadd_rn(1.0f, s.f[i])),
                              t.f[i]);
    x.f[i] = h;
    amax = fmaxf(amax, fabsf(h));
  }
  return amax;
}

template <typename T>
__device__ __forceinline__ double sum_squares(const Slot<T>& x) {
  double ss = 0.0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const double a = x.at(i);
    ss += a * a;
  }
  return ss;
}

// W warps a row (8 / W rows a 256-thread block), SLOTS 16-value slots a
// lane. One slot a lane keeps a thread under 40 registers (48 in fp32,
// whose slot is 16 of them), so that six (five) blocks share an SM and
// hide each other's latency: a row's load, reductions and stores follow
// one another, and with eight slots a lane (106 registers, two blocks an
// SM) the kernel stayed far from its memory bound however little
// arithmetic it did; loading a warp's next row under its current one, at
// fewer blocks an SM, did not close the gap either.
// VEC: 16-byte loads (K a 16-multiple); otherwise each value is read
// alone, zeros past K (which add nothing to the sum of squares, modulate
// to 0 and quantize to code 0). SLOTS == 0 is the form for rows longer
// than the registers hold: the row is read three times (the sum of
// squares, the absmax of h, the codes), the later reads from L2.
template <typename T, int SLOTS, int W, bool VEC>
__global__ void __launch_bounds__(256, SLOTS == 1 ? (sizeof(T) == 2 ? 6 : 5)
                                                  : 1)
norm_mod_quantize_rows_kernel(const T* __restrict__ x,
                              const T* __restrict__ scale,
                              const T* __restrict__ shift, int M, int K,
                              int rows_per_group, float eps,
                              int8_t* __restrict__ xq,
                              float* __restrict__ sx) {
  constexpr int RPB = 8 / W;  // rows a block
  constexpr int WARPS = 8;
  __shared__ double red_d[WARPS];
  __shared__ float red_f[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % W;  // the warp's place in its row
  const long long row = (long long)blockIdx.x * RPB + warp / W;
  const bool live = row < M;  // the last block's rows may run past M
  const int nslot = (K + 15) / 16;  // codes: rows of 16 nslot bytes
  const long long grp = live ? row / rows_per_group : 0;
  const T* xr = x + row * K;
  const T* sr = scale + grp * K;
  const T* tr = shift + grp * K;
  int8_t* qr = xq + row * (16LL * nslot);
  auto load = [&](Slot<T>& v, const T* p, int sl) {
    if (VEC) {
      v.load(p + sl * 16);
    } else {
      v.load_some(p + sl * 16, K - sl * 16);
    }
  };
  // the slots of a lane: lane + 32 (wr + W i)
  constexpr int STEP = 32 * W;
  const int first = lane + 32 * wr;

  constexpr int ROW_SLOTS = SLOTS > 0 ? SLOTS : 1;
  Slot<T> v[ROW_SLOTS];
  double ss = 0.0;
  if constexpr (SLOTS == 0) {
    for (int sl = first; live && sl < nslot; sl += STEP) {
      load(v[0], xr, sl);
      ss += sum_squares(v[0]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int sl = first + STEP * i;
      if (live && sl < nslot) {
        load(v[i], xr, sl);
        ss += sum_squares(v[i]);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (W > 1) {
    if (lane == 0) red_d[warp] = ss;
    __syncthreads();
    ss = 0.0;
#pragma unroll
    for (int w = 0; w < W; ++w) ss += red_d[warp - wr + w];
  }
  const float mean = (float)(ss / (double)K);
  const float rr = rsqrtf(mean + eps);

  // h = the modulated slot sl, in place of x's values
  auto modulated = [&](Slot<T>& h, int sl) {
    Slot<T> s, t;
    load(s, sr, sl);
    load(t, tr, sl);
    return modulate(h, s, t, rr);
  };
  float amax = 0.f;
  if constexpr (SLOTS == 0) {
    for (int sl = first; live && sl < nslot; sl += STEP) {
      load(v[0], xr, sl);
      amax = fmaxf(amax, modulated(v[0], sl));
    }
  } else {
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int sl = first + STEP * i;
      if (live && sl < nslot) amax = fmaxf(amax, modulated(v[i], sl));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  if (W > 1) {
    if (lane == 0) red_f[warp] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < W; ++w) amax = fmaxf(amax, red_f[warp - wr + w]);
  }
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
  const float r = __frcp_rn(s);

  if constexpr (SLOTS == 0) {
    for (int sl = first; live && sl < nslot; sl += STEP) {
      load(v[0], xr, sl);
      modulated(v[0], sl);
      *reinterpret_cast<uint4*>(qr + sl * 16) = codes(v[0], s, r);
    }
  } else {
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int sl = first + STEP * i;
      if (live && sl < nslot) {
        *reinterpret_cast<uint4*>(qr + sl * 16) = codes(v[i], s, r);
      }
    }
  }
  if (live && wr == 0 && lane == 0) sx[row] = s;
}

template <typename T, int SLOTS, int W, bool VEC>
int launch_rows_sw(const T* x, const T* scale, const T* shift, int M, int K,
                   int rows_per_group, float eps, void* xq, void* sx,
                   cudaStream_t stream) {
  constexpr int RPB = 8 / W;
  norm_mod_quantize_rows_kernel<T, SLOTS, W, VEC>
      <<<(M + RPB - 1) / RPB, 256, 0, stream>>>(
          x, scale, shift, M, K, rows_per_group, eps,
          static_cast<int8_t*>(xq), static_cast<float*>(sx));
  return static_cast<int>(cudaGetLastError());
}

// one slot a lane and the fewest warps a row that cover K (up to 4096
// values); longer rows take 8 warps and 2, 4 or 8 slots a lane, and rows
// past 32768 values the three-read form; a K that is not a 16-multiple
// takes the three-read form with single-value loads
template <typename T>
int launch_rows(const T* x, const T* scale, const T* shift, int M, int K,
                int rows_per_group, float eps, void* xq, void* sx,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K5_ROWS(SLOTS, W, VEC)                                          \
  return launch_rows_sw<T, SLOTS, W, VEC>(x, scale, shift, M, K,        \
                                          rows_per_group, eps, xq, sx, s)
  if (K % 16 != 0) K5_ROWS(0, 8, false);
  if (K <= 512) K5_ROWS(1, 1, true);
  if (K <= 1024) K5_ROWS(1, 2, true);
  if (K <= 2048) K5_ROWS(1, 4, true);
  if (K <= 4096) K5_ROWS(1, 8, true);
  if (K <= 8192) K5_ROWS(2, 8, true);
  if (K <= 16384) K5_ROWS(4, 8, true);
  if (K <= MAX_SLOT_K) K5_ROWS(8, 8, true);
  K5_ROWS(0, 8, true);
#undef K5_ROWS
}

}  // namespace

// x [M, K] bf16 (x_dtype 0) or fp32 (1), scale/shift [M / rows_per_group,
// K] in x's dtype, all 16-byte aligned, any K -> xq [M, round_up(K, 16)]
// int8 (zero codes past K), sx [M] fp32.
extern "C" int k5_norm_mod_quantize_rows(const void* x, const void* scale,
                                         const void* shift, int M, int K,
                                         int x_dtype, int rows_per_group,
                                         float eps, void* xq, void* sx,
                                         void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || rows_per_group <= 0 ||
      x_dtype < 0 || x_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return x_dtype == 0
             ? launch_rows(static_cast<const bf16*>(x),
                           static_cast<const bf16*>(scale),
                           static_cast<const bf16*>(shift), M, K,
                           rows_per_group, eps, xq, sx, stream)
             : launch_rows(static_cast<const float*>(x),
                           static_cast<const float*>(scale),
                           static_cast<const float*>(shift), M, K,
                           rows_per_group, eps, xq, sx, stream);
}

// The whole of K5: the row kernel into the scratch xq / sx, then the s8
// product with w [N, round_up(K, 16)] int8 (the concatenated weights, zero
// columns past K), sw [N], bias [N] or null, into out [M, N] (out_mode as
// k2_int8_gemm: 0 s32, 1 bf16, 2 f32).
extern "C" int k5_norm_mod_int8_matmul(const void* x, const void* scale,
                                       const void* shift, int M, int K,
                                       int x_dtype, int rows_per_group,
                                       float eps, void* xq, void* sx,
                                       const void* w, int N, const void* sw,
                                       const void* bias, void* out,
                                       int out_mode, void* stream) {
  const int code = k5_norm_mod_quantize_rows(x, scale, shift, M, K, x_dtype,
                                             rows_per_group, eps, xq, sx,
                                             stream);
  if (code != 0) return code;
  return k2_int8_gemm(xq, w, M, N, (K + 15) / 16 * 16, sx, sw, bias, out,
                      out_mode, stream);
}
