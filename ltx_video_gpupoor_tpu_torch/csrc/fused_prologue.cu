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
// value, bound by memory and a few percent of the product's time.
// Design: two launches in one call. The TPU kernel holds whole rows of K in
// VMEM for a 480-row block and recomputes the prologue for every block of
// output columns; a block here has 227 KB, so the rows of a product tile do
// not fit beside it, and recomputing is not worth copying. Instead a row
// kernel gives one block to each row (the row lives in shared memory as
// fp32, so x is read from device memory once), reduces the mean of squares
// and the absmax inside the block, picks the row's scale and shift rows by
// row / rows_per_group (never broadcast to [M, K]) and writes int8 codes and
// one scale a row. Then K2's GEMM (k2_int8_gemm, csrc/int8_linear.cu) runs
// over the concatenated weights with the rescale and bias in its epilogue.
// The bf16 h never reaches device memory; what does is M*K int8 codes.
// The sum of squares is accumulated in double and rounded to fp32 once, so
// that the mean does not depend on the order of summation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int k2_int8_gemm(const void* xq, const void* w, int M, int N, int K,
                            const void* sx, const void* sw, const void* bias,
                            void* out, int out_mode, void* stream);

namespace {

typedef __nv_bfloat16 bf16;

constexpr int ROW_THREADS = 256;

__device__ __forceinline__ float rb(float x) {  // round to bf16 and back
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two values of a row as fp32
__device__ __forceinline__ float2 load2(const bf16* p) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// h = (h * (1 + s)) + t in the activation dtype: each op rounds to bf16,
// or (fp32 activations) is one IEEE fp32 op, never contracted into an FMA,
// as PyTorch's separate elementwise ops compute it
__device__ __forceinline__ float modulate(float h, float s, float t, bf16*) {
  return rb(rb(h * rb(1.0f + s)) + t);
}
__device__ __forceinline__ float modulate(float h, float s, float t, float*) {
  return __fadd_rn(__fmul_rn(h, __fadd_rn(1.0f, s)), t);
}
__device__ __forceinline__ float round_act(float x, bf16*) { return rb(x); }
__device__ __forceinline__ float round_act(float x, float*) { return x; }

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
norm_mod_quantize_rows_kernel(const T* __restrict__ x,
                              const T* __restrict__ scale,
                              const T* __restrict__ shift, int K,
                              int rows_per_group, float eps,
                              int8_t* __restrict__ xq,
                              float* __restrict__ sx) {
  extern __shared__ float row_s[];  // the row as fp32, then h as fp32
  __shared__ double red_d[ROW_THREADS / 32];
  __shared__ float red_f[ROW_THREADS / 32];
  const long long row = blockIdx.x;
  const long long grp = row / rows_per_group;
  const T* xr = x + row * K;
  const T* sc = scale + grp * K;
  const T* sh = shift + grp * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  double ss = 0.0;
  for (int i = threadIdx.x * 2; i < K; i += ROW_THREADS * 2) {
    const float2 v = load2(xr + i);
    const float a = v.x, b = v.y;
    row_s[i] = a;
    row_s[i + 1] = b;
    ss += (double)a * a + (double)b * b;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) red_d[warp] = ss;
  __syncthreads();
  double tot = 0.0;
#pragma unroll
  for (int w = 0; w < ROW_THREADS / 32; ++w) tot += red_d[w];
  const float mean = (float)(tot / (double)K);
  const float rr = rsqrtf(mean + eps);

  float amax = 0.f;
  for (int i = threadIdx.x * 2; i < K; i += ROW_THREADS * 2) {
    const float2 s2 = load2(sc + i);
    const float2 h2 = load2(sh + i);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float s = e ? s2.y : s2.x;
      const float t = e ? h2.y : h2.x;
      float h = round_act(row_s[i + e] * rr, static_cast<T*>(nullptr));
      h = modulate(h, s, t, static_cast<T*>(nullptr));
      row_s[i + e] = h;
      amax = fmaxf(amax, fabsf(h));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  if (lane == 0) red_f[warp] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < ROW_THREADS / 32; ++w) amax = fmaxf(amax, red_f[w]);
  const float s = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);

  int8_t* qr = xq + row * K;
  for (int i = threadIdx.x * 2; i < K; i += ROW_THREADS * 2) {
    // each thread reads back only what it wrote
    float q0 = rintf(__fdiv_rn(row_s[i], s));
    float q1 = rintf(__fdiv_rn(row_s[i + 1], s));
    q0 = fminf(fmaxf(q0, -127.f), 127.f);
    q1 = fminf(fmaxf(q1, -127.f), 127.f);
    char2 c;
    c.x = static_cast<signed char>(q0);
    c.y = static_cast<signed char>(q1);
    *reinterpret_cast<char2*>(qr + i) = c;
  }
  if (threadIdx.x == 0) sx[row] = s;
}

template <typename T>
int launch_rows(const T* x, const T* scale, const T* shift, int M, int K,
                int rows_per_group, float eps, void* xq, void* sx,
                size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        norm_mod_quantize_rows_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  norm_mod_quantize_rows_kernel<T><<<M, ROW_THREADS, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      x, scale, shift, K, rows_per_group, eps, static_cast<int8_t*>(xq),
      static_cast<float*>(sx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] bf16 (x_dtype 0) or fp32 (1), scale/shift [M / rows_per_group,
// K] in x's dtype -> xq [M, K] int8, sx [M] fp32. K must be even and K * 4
// bytes must fit a block's shared memory.
extern "C" int k5_norm_mod_quantize_rows(const void* x, const void* scale,
                                         const void* shift, int M, int K,
                                         int x_dtype, int rows_per_group,
                                         float eps, void* xq, void* sx,
                                         void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || K % 2 != 0 || rows_per_group <= 0 || x_dtype < 0 ||
      x_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  if (smem > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  return x_dtype == 0
             ? launch_rows(static_cast<const bf16*>(x),
                           static_cast<const bf16*>(scale),
                           static_cast<const bf16*>(shift), M, K,
                           rows_per_group, eps, xq, sx, smem, stream)
             : launch_rows(static_cast<const float*>(x),
                           static_cast<const float*>(scale),
                           static_cast<const float*>(shift), M, K,
                           rows_per_group, eps, xq, sx, smem, stream);
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
