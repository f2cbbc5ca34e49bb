// What the row quantizers share: K2's row kernel and its attention-prologue
// instance (int8_linear.cu) and K5's row kernel (fused_prologue.cu). A row
// is held in registers as slots of 16 consecutive values, one slot (or a
// few) a lane, read with 16-byte loads and written back as 16 int8 codes
// with one 16-byte store. Every function is inline and lives in an
// anonymous namespace, so each source gets its own copy.
//
// The codes are those of the IEEE quotient x / s rounded half to even, as
// the plain versions compute them (a tensor divided by a tensor), but
// taken from x * (1 / s): the product can round to another integer only
// where it lies near a half, and only there is the quotient computed
// (rint_quotient).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float MAGIC = 12582912.0f;  // 1.5 * 2**23: + MAGIC rounds to int

__device__ __forceinline__ uint32_t bf2_max(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

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
  // the first n values (n may exceed 16) at any alignment, zeros after
  __device__ __forceinline__ void load_some(const bf16* p, int n) {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t lo = 2 * i < n ? __ldg(u + 2 * i) : 0u;
      const uint32_t hi = 2 * i + 1 < n ? __ldg(u + 2 * i + 1) : 0u;
      w[i] = lo | (hi << 16);
    }
  }
  __device__ __forceinline__ float at(int i) const {  // value i as fp32
    return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16);
  }
  // max |value| of the slot, two values an instruction
  __device__ __forceinline__ float amax() const {
    uint32_t a2 = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) a2 = bf2_max(a2, w[i] & 0x7fff7fffu);
    return fmaxf(__uint_as_float(a2 << 16), __uint_as_float(a2 & 0xffff0000u));
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
  __device__ __forceinline__ void load_some(const float* p, int n) {
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = i < n ? __ldg(p + i) : 0.f;
  }
  __device__ __forceinline__ float at(int i) const { return f[i]; }
  __device__ __forceinline__ float amax() const {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) a = fmaxf(a, fabsf(f[i]));
    return a;
  }
};

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

}  // namespace
