// What the Hopper kernels share: mbarriers, TMA loads, wgmma descriptors,
// fences and register pins, tensor-map encoding, and the attention blocks'
// P.V product and mask code (flash_attention_int8.cu: K4; int8_linear.cu:
// K2 takes the first four; K1's block, which K6, K7 and K8 run too, adds
// its own in attention_block.cuh). Every function is inline and lives in an
// anonymous namespace, so each source gets its own copy.
//
// Descriptors. A tile that wgmma reads from shared memory is K-major with
// rows of 128 bytes (64 bf16 or 128 int8 values) under the 128-byte
// swizzle, or rows of 64 bytes under the 64-byte swizzle: TMA writes that
// layout from a tensor map with the same swizzle, and a descriptor names
// it by its start address, the stride between 8-row groups (8 rows x the
// row) and the layout type. A k-step of 32 bytes (k16 bf16, k32 int8) is
// +32 bytes of the start address inside a row. 8-bit wgmma reads both
// operands K-major only: there is no transpose flag for them.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SWIZZLE_128B = 1, SWIZZLE_64B = 2;  // descriptor layout types

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// the barriers' init made visible to the async proxy (TMA); thread 0,
// before the block's first __syncthreads
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Wait until the phase of `parity` has completed. A wait that outlasts two
// seconds traps: a fault shows as a failed launch, not as a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t spins = 0;
  unsigned long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((++spins & 1023u) == 0) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (t0 == 0) t0 = now;
      if (now - t0 > 2000000000ull) __trap();
    }
  }
}

// ---- TMA --------------------------------------------------------------------

// one box of a 2-D map at (c0, c1) into shared memory at dst
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// one box of a 4-D map at (c0, c1, c2, c3)
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into shared memory, with no tensor map
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets in 16-byte units, the layout type in bits 62-63.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo,
                                               int layout = SWIZZLE_128B) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins registers that a wgmma reads or writes on one side of its fence or
// wait: the compiler may not move their ordinary uses across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// named barriers among `threads` threads (id 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- the attention blocks ----------------------------------------------------

// 128 q rows a block (two consumer warpgroups of 64), kv tiles of 128 rows,
// bf16 tiles in panels of [128 rows x 64 values] (a panel row is the
// 128-byte swizzle span)
constexpr int BQ = 128;
constexpr int BKV = 128;
constexpr int PANEL_BYTES = 128 * 128;

// d (64 x 128) += a (64 x 16 bf16, registers) * b (16 x 128 bf16, shared,
// N-contiguous: the transposed-B form)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1,
    uint32_t a2, uint32_t a3, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// the same with a 16 x 64 b
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
    uint32_t a2, uint32_t a3, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// acc += P V for KV kv rows (a tile, or K8's sub-block of one), P from
// registers (k-step kk takes kv rows 16 kk .. 16 kk + 15), issued and
// committed, not waited for
template <int D, int KV = BKV>
__device__ __forceinline__ void pv_issue_bf16(float (&acc)[D / 2],
                                         uint32_t (&p)[KV / 4],
                                         uint32_t v_tile) {
  pin(acc);
  pin(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KV / 16; ++kk) {
    const uint64_t dv = wgmma_desc(v_tile + kk * 2048, PANEL_BYTES, 1024);
    if constexpr (D == 128) {
      wgmma_rs_n128(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                    p[4 * kk + 3], dv, 1);
    } else {
      wgmma_rs_n64(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                   p[4 * kk + 3], dv, 1);
    }
  }
  wgmma_commit();
}

// p rounded to bf16 in the A-fragment order of the P V product
template <int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N],
                                       uint32_t (&p)[N / 2]) {
#pragma unroll
  for (int jn = 0; jn < N / 4; ++jn) {
    p[2 * jn] = pack_f(sc[4 * jn], sc[4 * jn + 1]);
    p[2 * jn + 1] = pack_f(sc[4 * jn + 2], sc[4 * jn + 3]);
  }
}

// ---- their masks ---------------------------------------------

constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;
constexpr int MASK_NONE = 0, MASK_TAIL = 1, MASK_GENERAL = 2;
// whether one step of the kv loop compares: see `step` in the kernels
constexpr int MASK_NEVER = 0, MASK_ALWAYS = 1, MASK_ASK = 2;
template <int HOW>
struct How {
  static constexpr int value = HOW;
};

// what a consumer thread knows of its two rows and of the call's masks
struct Rows {
  int row0, row1, qs0, qs1;
  const int* kv_seg;  // this batch row's kv segment ids, or null
  int Skv, kv_lim, causal;
};

// masked scores of one 128-column tile (the wgmma accumulator layout:
// columns 8 jn + 2 t + c, rows row0 and row1) go to NEG_INF
template <int MASK>
__device__ __forceinline__ void mask_tile(float (&sc)[64], const Rows& r,
                                          int kv0, int t) {
#pragma unroll
  for (int jn = 0; jn < 16; ++jn) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = kv0 + jn * 8 + t * 2 + c;
      bool ok0 = col < r.kv_lim, ok1 = ok0;
      if (MASK == MASK_GENERAL) {
        if (r.causal) {
          ok0 = ok0 && r.row0 >= col;
          ok1 = ok1 && r.row1 >= col;
        }
        if (r.kv_seg != nullptr) {
          const int ks = col < r.Skv ? r.kv_seg[col] : 0;
          ok0 = ok0 && ks > 0 && ks == r.qs0;
          ok1 = ok1 && ks > 0 && ks == r.qs1;
        }
      }
      if (!ok0) sc[4 * jn + c] = NEG_INF;
      if (!ok1) sc[4 * jn + 2 + c] = NEG_INF;
    }
  }
}

// ---- host side ------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is not a runtime call: its address is taken through
// the runtime, so that the library links without libcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tensor map of `rank` dims (innermost first) of `esize`-byte elements,
// with byte strides for dims 1.. (each a multiple of 16, as is the
// innermost row dims[0] * esize), boxes of `box`, elements past an edge
// read as 0. The stride of a one-long axis is never used, so it is set to
// one that always encodes.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int esize,
                       int rank, const void* ptr, const cuuint64_t* dims,
                       const long long* byte_strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[4];
  for (int i = 0; i + 1 < rank; ++i) {
    strides[i] = dims[i + 1] > 1 ? (cuuint64_t)byte_strides[i]
                                 : dims[0] * (cuuint64_t)esize;
  }
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
