// K2: dynamic-int8 linear for sm_90a.
//
// Replaces the Pallas TPU kernel
// ltx_video_gpupoor_tpu/ops/int8_matmul.py::_kernel (reached through
// int8_dynamic_matmul_fused, :59 -> pl.pallas_call :116). It computes the
// function of the JAX default path, ops/quant.py::int8_dynamic_matmul
// (:190-206), not the TPU kernel's variant:
//   s_x = max(max|x_row| / 127, 1e-8)             per row, over the full K
//   x_q = clip(round_half_even(x / s_x), -127, 127)  int8
//   acc = x_q . w_q                                  int32
//   y   = acc * s_x * s_w (+ bias)                   fp32, cast to x's dtype
// (the TPU kernel floors amax at 1e-6 and does not clip).
//
// What bounds it on an H100: at the LTX-2B shapes (M = 3 x 5280, K and N
// of 2048 to 8192) the GEMM does 64 to 256 int8 operations per byte it
// reads, so it is bound by the tensor cores; the quantize pass reads the
// activation once and writes a quarter of it, so it is bound by memory.
// Design: two launches. k2_quantize_rows gives one block to each row, so
// the row's absmax needs no cross-block reduction (the TPU kernel got the
// same by holding the full K in VMEM). k2_int8_gemm computes a 128x128
// output tile per block of 8 warps over 64-byte K steps staged in padded
// shared memory (conflict-free fragment reads), on mma.sync m16n8k32
// s8.s8.s32, and applies the scale/bias epilogue in registers, so the
// int32 accumulator never reaches device memory (out_mode 0 writes it, for
// the exactness check only). Weights are stored [N, K] row-major (torch's
// [out, in]), which is the column-major B operand the instruction reads.
// M and N are masked in the kernel; K must be a multiple of 16 so that each
// 16-byte load is either wholly inside a row or wholly past its end.
// This is the simple first version: no cp.async pipeline, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__global__ void quantize_rows_kernel(const T* __restrict__ x, int K,
                                     int8_t* __restrict__ xq,
                                     float* __restrict__ sx) {
  const long long row = blockIdx.x;
  const T* xr = x + row * K;
  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    amax = fmaxf(amax, fabsf(to_float(xr[i])));
  }
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float s = fmaxf(__fdiv_rn(red[0], 127.0f), 1e-8f);
  int8_t* qr = xq + row * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    float qv = rintf(__fdiv_rn(to_float(xr[i]), s));
    qv = fminf(fmaxf(qv, -127.f), 127.f);
    qr[i] = static_cast<int8_t>(qv);
  }
  if (threadIdx.x == 0) sx[row] = s;
}

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // padded row: 80 bytes = 20 words
constexpr int GEMM_THREADS = 256;
constexpr int MT = 4, NT = 4;  // per warp: 4 m16 x 4 n8 tiles = 64 x 32

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [r0, r0 + 128) x bytes [k0, k0 + 64) of a [rows, K] int8 matrix
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* src,
                                          int rows, int K, int r0, int k0) {
  for (int i = threadIdx.x; i < BM * (BK / 16); i += GEMM_THREADS) {
    const int r = i >> 2, c = i & 3;
    const int gr = r0 + r, gk = k0 + c * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rows && gk < K) {
      val = *reinterpret_cast<const uint4*>(src + (long long)gr * K + gk);
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + c * 16) = val;
  }
}

template <int MODE>  // 0: int32 accumulator, 1: bf16, 2: fp32
__global__ void __launch_bounds__(GEMM_THREADS)
int8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                 int M, int N, int K, const float* __restrict__ sx,
                 const float* __restrict__ sw, const float* __restrict__ bias,
                 void* __restrict__ out) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    load_tile(As, xq, M, K, m0, k0);
    load_tile(Bs, w, N, K, n0, k0);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = As + (wm * 64 + i * 16 + g) * LDS + ks + t * 4;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * LDS);
        af[i][2] = lds32(p + 16);
        af[i][3] = lds32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = Bs + (wn * 32 + j * 8 + g) * LDS + ks + t * 4;
        bfr[j][0] = lds32(p);
        bfr[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 64 + i * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + j * 8 + t * 2 + (e & 1);
        if (row >= M || col >= N) continue;
        const long long idx = (long long)row * N + col;
        if (MODE == 0) {
          static_cast<int*>(out)[idx] = acc[i][j][e];
        } else {
          float y = static_cast<float>(acc[i][j][e]) * sx[row] * sw[col];
          if (bias != nullptr) y += bias[col];
          if (MODE == 1) {
            static_cast<bf16*>(out)[idx] = __float2bfloat16_rn(y);
          } else {
            static_cast<float*>(out)[idx] = y;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int k2_quantize_rows(const void* x, int M, int K, int x_dtype,
                                void* xq, void* sx, void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(sx);
  if (x_dtype == 0) {
    quantize_rows_kernel<bf16><<<M, 256, 0, st>>>(static_cast<const bf16*>(x), K, q, s);
  } else if (x_dtype == 1) {
    quantize_rows_kernel<float><<<M, 256, 0, st>>>(static_cast<const float*>(x), K, q, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int k2_int8_gemm(const void* xq, const void* w, int M, int N, int K,
                            const void* sx, const void* sw, const void* bias,
                            void* out, int out_mode, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(w);
  const float* fsx = static_cast<const float*>(sx);
  const float* fsw = static_cast<const float*>(sw);
  const float* fb = static_cast<const float*>(bias);
  if (out_mode == 0) {
    int8_gemm_kernel<0><<<grid, GEMM_THREADS, 0, st>>>(a, b, M, N, K, fsx, fsw, fb, out);
  } else if (out_mode == 1) {
    int8_gemm_kernel<1><<<grid, GEMM_THREADS, 0, st>>>(a, b, M, N, K, fsx, fsw, fb, out);
  } else if (out_mode == 2) {
    int8_gemm_kernel<2><<<grid, GEMM_THREADS, 0, st>>>(a, b, M, N, K, fsx, fsw, fb, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
