// K5: fused adaLN prologue + dynamic-int8 linear for sm_90a.
//
// Replaces the Pallas TPU kernel
// ltx_video_gpupoor_tpu/ops/fused_prologue.py::_kernel (:104, reached
// through norm_mod_int8_matmul, :129 -> pl.pallas_call :221):
//   rr  = rsqrt(mean(x^2) + eps)                       fp32, over the row
//   h   = bf16(x * rr)
//   h   = bf16(bf16(h * bf16(1 + scale_g)) + shift_g)  g = row / rows_per_group
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

__global__ void __launch_bounds__(ROW_THREADS)
norm_mod_quantize_rows_kernel(const bf16* __restrict__ x,
                              const bf16* __restrict__ scale,
                              const bf16* __restrict__ shift, int K,
                              int rows_per_group, float eps,
                              int8_t* __restrict__ xq,
                              float* __restrict__ sx) {
  extern __shared__ float row_s[];  // the row as fp32, then h as fp32
  __shared__ double red_d[ROW_THREADS / 32];
  __shared__ float red_f[ROW_THREADS / 32];
  const long long row = blockIdx.x;
  const long long grp = row / rows_per_group;
  const bf16* xr = x + row * K;
  const bf16* sc = scale + grp * K;
  const bf16* sh = shift + grp * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  double ss = 0.0;
  for (int i = threadIdx.x * 2; i < K; i += ROW_THREADS * 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(xr + i);
    const float a = __bfloat162float(v.x), b = __bfloat162float(v.y);
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
    const __nv_bfloat162 s2 = *reinterpret_cast<const __nv_bfloat162*>(sc + i);
    const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(sh + i);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float s = __bfloat162float(e ? s2.y : s2.x);
      const float t = __bfloat162float(e ? h2.y : h2.x);
      float h = rb(row_s[i + e] * rr);
      h = rb(rb(h * rb(1.0f + s)) + t);
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

}  // namespace

// x [M, K] bf16, scale/shift [M / rows_per_group, K] bf16 -> xq [M, K] int8,
// sx [M] fp32. K must be even and K * 4 bytes must fit a block's shared
// memory.
extern "C" int k5_norm_mod_quantize_rows(const void* x, const void* scale,
                                         const void* shift, int M, int K,
                                         int rows_per_group, float eps,
                                         void* xq, void* sx, void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || K % 2 != 0 || rows_per_group <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  if (smem > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        norm_mod_quantize_rows_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  norm_mod_quantize_rows_kernel<<<M, ROW_THREADS, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(shift), K, rows_per_group, eps,
      static_cast<int8_t*>(xq), static_cast<float*>(sx));
  return static_cast<int>(cudaGetLastError());
}

// The whole of K5: the row kernel into the scratch xq / sx, then the s8
// product with w [N, K] int8 (the concatenated weights), sw [N], bias [N]
// or null, into out [M, N] (out_mode as k2_int8_gemm: 0 s32, 1 bf16).
extern "C" int k5_norm_mod_int8_matmul(const void* x, const void* scale,
                                       const void* shift, int M, int K,
                                       int rows_per_group, float eps,
                                       void* xq, void* sx, const void* w,
                                       int N, const void* sw,
                                       const void* bias, void* out,
                                       int out_mode, void* stream) {
  const int code = k5_norm_mod_quantize_rows(x, scale, shift, M, K,
                                             rows_per_group, eps, xq, sx,
                                             stream);
  if (code != 0) return code;
  return k2_int8_gemm(xq, w, M, N, K, sx, sw, bias, out, out_mode, stream);
}
