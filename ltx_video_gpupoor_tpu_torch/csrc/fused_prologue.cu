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
// with one 16-byte store. The sum of squares and the absmax reduce by
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int k2_int8_gemm(const void* xq, const void* w, int M, int N, int K,
                            const void* sx, const void* sw, const void* bias,
                            void* out, int out_mode, void* stream);

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_K = 32768;        // the longest row the kernel takes
constexpr float MAGIC = 12582912.0f;  // 1.5 * 2**23: + MAGIC rounds to int

// 16 values of a row: bf16 as 8 bf16x2 words, fp32 as 16 floats
template <typename T>
struct Slot;

template <>
struct Slot<bf16> {
  uint32_t w[8];
  __device__ __forceinline__ void load(const bf16* p) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
  __device__ __forceinline__ float at(int i) const {  // value i as fp32
    return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16);
  }
};

template <>
struct Slot<float> {
  float f[16];
  __device__ __forceinline__ void load(const float* p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
      f[4 * i] = v.x; f[4 * i + 1] = v.y; f[4 * i + 2] = v.z;
      f[4 * i + 3] = v.w;
    }
  }
  __device__ __forceinline__ float at(int i) const { return f[i]; }
};

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
__device__ __forceinline__ uint32_t bf2_max(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
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

// rint(h / s) with the IEEE quotient, from h * r (r = 1 / s rounded): the
// product lies within 3 * 2**-24 * |h / s| < 2.3e-5 of the quotient for
// |h / s| <= 128, so it rounds to the same integer unless it lies within
// 1e-4 of a half; there (about 2 in 10**4 values) the quotient is taken
__device__ __forceinline__ float rint_quotient(float h, float s, float r) {
  const float q = h * r;
  const float rq = rintf(q);
  if (fabsf(fabsf(q - rq) - 0.5f) < 1e-4f) return rintf(__fdiv_rn(h, s));
  return rq;
}

// 16 codes clip(round_half_even(h / s), -127, 127), little end first
template <typename T>
__device__ __forceinline__ uint4 codes(const Slot<T>& h, float s, float r) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float q = rint_quotient(h.at(4 * i + e), s, r);
      c[e] = fminf(fmaxf(q, -127.f), 127.f) + MAGIC;  // its low byte
    }
    const uint32_t lo = __byte_perm(__float_as_uint(c[0]),
                                    __float_as_uint(c[1]), 0x0040);
    const uint32_t hi = __byte_perm(__float_as_uint(c[2]),
                                    __float_as_uint(c[3]), 0x0040);
    w[i] = __byte_perm(lo, hi, 0x5410);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
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
template <typename T, int SLOTS, int W>
__global__ void __launch_bounds__(256, SLOTS > 1 ? 1 : sizeof(T) == 2 ? 6 : 5)
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
  const int nslot = K / 16;
  const long long grp = live ? row / rows_per_group : 0;

  constexpr int ROW_SLOTS = SLOTS;
  Slot<T> v[ROW_SLOTS];
  double ss = 0.0;
#pragma unroll
  for (int i = 0; i < ROW_SLOTS; ++i) {
    const int sl = lane + 32 * (wr + W * i);
    if (live && sl < nslot) {
      v[i].load(x + row * K + sl * 16);
      ss += sum_squares(v[i]);
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

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < ROW_SLOTS; ++i) {
    const int sl = lane + 32 * (wr + W * i);
    if (live && sl < nslot) {
      Slot<T> s, t;
      s.load(scale + grp * K + sl * 16);
      t.load(shift + grp * K + sl * 16);
      amax = fmaxf(amax, modulate(v[i], s, t, rr));
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

#pragma unroll
  for (int i = 0; i < ROW_SLOTS; ++i) {
    const int sl = lane + 32 * (wr + W * i);
    if (live && sl < nslot) {
      *reinterpret_cast<uint4*>(xq + row * K + sl * 16) = codes(v[i], s, r);
    }
  }
  if (live && wr == 0 && lane == 0) sx[row] = s;
}

template <typename T, int SLOTS, int W>
int launch_rows_sw(const T* x, const T* scale, const T* shift, int M, int K,
                   int rows_per_group, float eps, void* xq, void* sx,
                   cudaStream_t stream) {
  constexpr int RPB = 8 / W;
  norm_mod_quantize_rows_kernel<T, SLOTS, W>
      <<<(M + RPB - 1) / RPB, 256, 0, stream>>>(
          x, scale, shift, M, K, rows_per_group, eps,
          static_cast<int8_t*>(xq), static_cast<float*>(sx));
  return static_cast<int>(cudaGetLastError());
}

// one slot a lane and the fewest warps a row that cover K (up to 4096
// values); longer rows take 8 warps and 2, 4 or 8 slots a lane
template <typename T>
int launch_rows(const T* x, const T* scale, const T* shift, int M, int K,
                int rows_per_group, float eps, void* xq, void* sx,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K5_ROWS(SLOTS, W)                                                   \
  return launch_rows_sw<T, SLOTS, W>(x, scale, shift, M, K, rows_per_group, \
                                     eps, xq, sx, s)
  if (K <= 512) K5_ROWS(1, 1);
  if (K <= 1024) K5_ROWS(1, 2);
  if (K <= 2048) K5_ROWS(1, 4);
  if (K <= 4096) K5_ROWS(1, 8);
  if (K <= 8192) K5_ROWS(2, 8);
  if (K <= 16384) K5_ROWS(4, 8);
  K5_ROWS(8, 8);
#undef K5_ROWS
}

}  // namespace

// x [M, K] bf16 (x_dtype 0) or fp32 (1), scale/shift [M / rows_per_group,
// K] in x's dtype, all 16-byte aligned -> xq [M, K] int8, sx [M] fp32. K
// must be a multiple of 16 and at most MAX_K (32768: 8 warps of 8 slots a
// lane).
extern "C" int k5_norm_mod_quantize_rows(const void* x, const void* scale,
                                         const void* shift, int M, int K,
                                         int x_dtype, int rows_per_group,
                                         float eps, void* xq, void* sx,
                                         void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || K % 16 != 0 || K > MAX_K || rows_per_group <= 0 ||
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
// product with w [N, K] int8 (the concatenated weights), sw [N], bias [N]
// or null, into out [M, N] (out_mode as k2_int8_gemm: 0 s32, 1 bf16, 2
// f32).
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
  return k2_int8_gemm(xq, w, M, N, K, sx, sw, bias, out, out_mode, stream);
}
