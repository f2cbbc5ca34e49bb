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
// What bounds it on an H100: at the main path's shapes (M of 3840 to 65520,
// K and N of 1536 to 16384) the product does hundreds to thousands of int8
// operations per byte it moves, so the tensor cores bound it (1979 TOP/s);
// the quantize pass reads the activation once and writes a quarter of it,
// so it is bound by memory.
//
// Design: two launches. The row quantizer (k2_quantize_rows) holds each row
// in registers (row_quant.cuh): one 16-value slot a lane read with 16-byte
// loads, the fewest warps a row that cover K (several rows a 256-thread
// block for short rows, so that six blocks share an SM and hide a row's
// serial phases: load, absmax, codes), up to 4096 values; 2 or 4 slots a
// lane up to 16384; beyond that, two passes over the row (the second from
// L2). Codes leave as 16-byte stores into rows of round_up(K, 16) bytes
// with zero codes past K (which add 0 to the product), so the GEMM takes
// any K. The same kernel, on the attention prologue's contract, quantizes
// the int8 attention tiers' Q and K rows (k2_prologue_quantize), and, with
// no amax pass, against row scales the caller gives (k2_quantize_rows_scaled:
// the row-parallel linears of tensor parallelism, whose rows are quantized by
// the amax of the whole row, all-reduced over the ranks).
// k2_int8_gemm (also K5's product) is a Hopper GEMM:
// - One block computes a 128 x 256 output tile in two consumer warpgroups
//   of 64 rows, on wgmma.mma_async m64n256k32 s32.s8.s8. 8-bit wgmma reads
//   both operands K-major, and x_q [M, K] and the weights [N, K] (torch's
//   [out, in]) are K-major already: nothing is rearranged.
// - Operands arrive by TMA: one 2-D tensor map each for x_q and w, the
//   128-byte swizzle, a k-step of 128 bytes (one swizzle span), into a ring
//   of four 48 KB stages, each with a full and an empty mbarrier. A ninth
//   warp issues every load: with thread 0 of a consumer doing it between
//   a wgmma's issue and its wait, ptxas serialized the wgmma (C7518, the
//   wait on an empty barrier in a divergent path). 288 threads leave 168
//   registers a thread; the 64 x 256 s32 accumulator and the rest take
//   154. TMA's zero fill covers the ragged M, N and K edges; K % 16 == 0 is
//   TMA's stride rule (the wrapper pads a weight whose K is not).
// - The tiles are walked in groups of eight row tiles, so that a wave of
//   132 blocks reads a few MB of x_q and w and keeps them in L2.
// - Epilogue through shared memory: the accumulator goes to the drained
//   ring as int32 rows (padded to 1056 bytes, conflict-free), then each
//   thread reads 4 columns of a row, applies acc * s_x * s_w (+ bias) in
//   that order (no FMA: the plain version's roundings), and stores 16
//   bytes (s32, fp32) or 8 (bf16) a thread, rows masked at M, columns at N.
//   out_mode 0 writes the int32 accumulator, for the exactness check only.

#include "hopper.cuh"
#include "row_quant.cuh"

namespace {

// ---- the row quantizer: K2's activation rows and the attention prologue ----

// The two quantize contracts the kernel serves. K2 (quant.py:196-198):
// s = max(amax / 127, 1e-8) with the IEEE quotient. The int8 attention
// tiers' prologue (flash_attention.py:484-505): s = max(amax, 1e-6) *
// float32(1/127), as XLA computes it, and the stored scale max(amax, 1e-6)
// * c, c being the constant XLA folds: float32(1/127) for K, times the
// softmax scale and log2(e) for Q. Both take codes clip(round_half_even(x /
// s), -127, 127); JAX's prologue does not clip, but there s >= amax / 127
// to a relative 2**-23, so |x / s| stays under 127.5 and the clip never
// binds.
// GIVEN: K2's codes against a scale the caller gives a row (sgiven[r], the
// scale of a whole row whose slice this rank holds under tensor
// parallelism): no amax pass, nothing stored but the codes.
constexpr int K2_ROWS = 0, PROLOGUE = 1, GIVEN = 2;
constexpr float INV127 = 0.007874015718698502f;  // float32(1 / 127)

struct RowArgs {
  const void* x;
  long long rows;     // rows of K values
  int K;
  int nslot;          // 16-value slots a row: round_up(K, 16) / 16
  // K2: row r at x + r * K, codes at xq + r * 16 nslot (zeros past K),
  // its scale at sx[r]. PROLOGUE: row r = (b * H + h) * S + s at x + b sb
  // + h sh + s ss (elements), codes at xq + r K, its scale at sx[(b * H +
  // h) * scale_pitch + s]
  int S, H;
  long long sb, sh, ss;
  int scale_pitch;
  float c;
  int8_t* xq;
  float* sx;
  const float* sgiven;  // GIVEN: the scale of row r
};

template <typename T, int CONTRACT>
__device__ __forceinline__ const T* row_at(const RowArgs& a, long long r) {
  if (CONTRACT != PROLOGUE) return static_cast<const T*>(a.x) + r * a.K;
  const long long bh = r / a.S, s = r - bh * a.S;
  const long long b = bh / a.H, h = bh - b * a.H;
  return static_cast<const T*>(a.x) + b * a.sb + h * a.sh + s * a.ss;
}

// K2 stores s; the prologue max(amax, 1e-6) * c
template <int CONTRACT>
__device__ __forceinline__ void store_scale(const RowArgs& a, long long r,
                                            float s, float amax) {
  if (CONTRACT == K2_ROWS) {
    a.sx[r] = s;
  } else {
    const long long bh = r / a.S;
    a.sx[bh * a.scale_pitch + (r - bh * a.S)] = __fmul_rn(amax, a.c);
  }
}

// max over the LANES lanes of a row: shuffles within a warp, then shared
// memory across the row's warps (every thread of the block calls it)
template <int LANES>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = (LANES < 32 ? LANES : 32) / 2; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  if constexpr (LANES > 32) {
    constexpr int W = LANES / 32;
    __shared__ float red[8];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    const int first = warp - warp % W;
#pragma unroll
    for (int w = 0; w < W; ++w) v = fmaxf(v, red[first + w]);
  }
  return v;
}

template <int CONTRACT>
__device__ __forceinline__ float row_scale(float amax) {
  if (CONTRACT == K2_ROWS) return fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
  return __fmul_rn(fmaxf(amax, 1e-6f), INV127);
}

// A row (or 256 / LANES rows) a 256-thread block, LANES lanes a row, each
// holding SLOTS slots of 16 values in registers (slot lane + LANES i): the
// row is read once, its absmax reduced, and its codes written from the
// registers. VEC: 16-byte loads (rows 16-byte aligned, K a 16-multiple);
// otherwise each value is read alone. SLOTS == 0 is the two-pass form for
// rows longer than the registers hold: the absmax pass, then a second read
// of the row (from L2) for the codes.
// (the GIVEN contract's fp32 rows of 4 slots a lane spilled 40 bytes at the
// 85 registers of 3 blocks an SM: 2 blocks an SM give them room)
template <typename T, int CONTRACT, int LANES, int SLOTS, bool VEC>
__global__ void __launch_bounds__(256, SLOTS == 1 ? (sizeof(T) == 2 ? 6 : 5)
                                      : SLOTS == 2 ? 4
                                      : SLOTS == 4 ? (CONTRACT == GIVEN &&
                                                      sizeof(T) == 4 ? 2 : 3)
                                                   : 4)
quantize_rows_kernel(const RowArgs a) {
  constexpr int RPB = 256 / LANES;  // rows a block
  const int lane = threadIdx.x % LANES;
  const long long row = (long long)blockIdx.x * RPB + threadIdx.x / LANES;
  const bool live = row < a.rows;  // the last block's rows may run past
  const T* x = row_at<T, CONTRACT>(a, live ? row : 0);
  int8_t* q = a.xq + (live ? row : 0) * (16LL * a.nslot);
  auto load = [&](Slot<T>& v, int sl) {
    if (VEC) {
      v.load(x + sl * 16);
    } else {
      v.load_some(x + sl * 16, a.K - sl * 16);
    }
  };
  float amax = 0.f;
  if constexpr (SLOTS == 0) {
    float s;
    if constexpr (CONTRACT == GIVEN) {
      s = live ? a.sgiven[row] : 1.f;
    } else {
      for (int sl = lane; live && sl < a.nslot; sl += LANES) {
        Slot<T> v;
        load(v, sl);
        amax = fmaxf(amax, v.amax());
      }
      amax = row_max<LANES>(amax);
      s = row_scale<CONTRACT>(amax);
    }
    const float r = __frcp_rn(s);
    for (int sl = lane; live && sl < a.nslot; sl += LANES) {
      Slot<T> v;
      load(v, sl);
      *reinterpret_cast<uint4*>(q + sl * 16) = codes(v, s, r);
    }
    if (CONTRACT != GIVEN && live && lane == 0) {
      store_scale<CONTRACT>(a, row, s, fmaxf(amax, 1e-6f));
    }
  } else {
    Slot<T> v[SLOTS];
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int sl = lane + LANES * i;
      if (live && sl < a.nslot) {
        load(v[i], sl);
        if (CONTRACT != GIVEN) amax = fmaxf(amax, v[i].amax());
      }
    }
    float s;
    if constexpr (CONTRACT == GIVEN) {
      s = live ? a.sgiven[row] : 1.f;
    } else {
      amax = row_max<LANES>(amax);
      s = row_scale<CONTRACT>(amax);
    }
    const float r = __frcp_rn(s);
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int sl = lane + LANES * i;
      if (live && sl < a.nslot) {
        *reinterpret_cast<uint4*>(q + sl * 16) = codes(v[i], s, r);
      }
    }
    if (CONTRACT != GIVEN && live && lane == 0) {
      store_scale<CONTRACT>(a, row, s, fmaxf(amax, 1e-6f));
    }
  }
}

template <typename T, int CONTRACT, int LANES, int SLOTS, bool VEC>
int launch_rows(const RowArgs& a, cudaStream_t st) {
  constexpr int RPB = 256 / LANES;
  const long long blocks = (a.rows + RPB - 1) / RPB;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  quantize_rows_kernel<T, CONTRACT, LANES, SLOTS, VEC>
      <<<static_cast<unsigned>(blocks), 256, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K2's rows: one slot a lane and the fewest warps a row that cover K (up
// to 4096 values), then 8 warps of 2 or 4 slots (up to 16384), then the
// two-pass form; rows that are not 16-byte aligned or whose K is not a
// 16-multiple take the two-pass form with single-value loads
// (the GIVEN contract takes the same shapes)
template <typename T, int CONTRACT = K2_ROWS>
int launch_k2_rows(const RowArgs& a, bool vec, cudaStream_t st) {
  const int K = a.K;
  if (!vec) return launch_rows<T, CONTRACT, 256, 0, false>(a, st);
  if (K <= 512) return launch_rows<T, CONTRACT, 32, 1, true>(a, st);
  if (K <= 1024) return launch_rows<T, CONTRACT, 64, 1, true>(a, st);
  if (K <= 2048) return launch_rows<T, CONTRACT, 128, 1, true>(a, st);
  if (K <= 4096) return launch_rows<T, CONTRACT, 256, 1, true>(a, st);
  if (K <= 8192) return launch_rows<T, CONTRACT, 256, 2, true>(a, st);
  if (K <= 16384) return launch_rows<T, CONTRACT, 256, 4, true>(a, st);
  return launch_rows<T, CONTRACT, 256, 0, true>(a, st);
}

constexpr int GBM = 128, GBN = 256;   // output tile
constexpr int GBK = 128;              // bytes of K a stage: one swizzle span
constexpr int G_STAGES = 4;
constexpr int G_CONSUMERS = 256;      // two consumer warpgroups
constexpr int G_THREADS = G_CONSUMERS + 32;  // and one producer warp
constexpr int G_GROUP = 8;            // row tiles walked together
constexpr int A_BYTES = GBM * GBK;    // 16 KB
constexpr int B_BYTES = GBN * GBK;    // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int G_BAR_OFFSET = G_STAGES * STAGE_BYTES;
constexpr int G_SMEM = 1024 + G_BAR_OFFSET + 8 * 2 * G_STAGES;
constexpr int ACC_PITCH = GBN * 4 + 32;  // bytes of a staged int32 row
static_assert(2 * 64 * ACC_PITCH <= G_BAR_OFFSET, "staging fits the ring");

// d (64 x 256 s32) += a (64 x 32 int8, shared, K-major) * b (256 x 32
// int8, shared, K-major)^T; d is overwritten where scale_d == 0
__device__ __forceinline__ void wgmma_s8_ss_n256(uint32_t (&d)[128], uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// x_q tile kt of rows m0.. and w tile kt of rows n0.. into stage kt % STAGES
__device__ __forceinline__ void gemm_refill(uint32_t ring, uint32_t full,
                                            uint32_t empty,
                                            const CUtensorMap* amap,
                                            const CUtensorMap* bmap, int kt,
                                            int m0, int n0) {
  const int s = kt % G_STAGES;
  if (kt >= G_STAGES) mbar_wait(empty + 8 * s, ((kt / G_STAGES) & 1) ^ 1);
  const uint32_t dst = ring + s * STAGE_BYTES;
  mbar_expect_tx(full + 8 * s, STAGE_BYTES);
  tma_load_2d(dst, amap, full + 8 * s, kt * GBK, m0);
  tma_load_2d(dst + A_BYTES, bmap, full + 8 * s, kt * GBK, n0);
}

template <int MODE>  // 0: int32 accumulator, 1: bf16, 2: fp32
__global__ void __launch_bounds__(G_THREADS, 1)
int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bmap, int M, int N,
                       int K, const float* __restrict__ sx,
                       const float* __restrict__ sw,
                       const float* __restrict__ bias, void* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
  const uint32_t full = ring + G_BAR_OFFSET;
  const uint32_t empty = full + 8 * G_STAGES;

  // grouped walk: G_GROUP row tiles sweep every column tile together
  const int mt = (M + GBM - 1) / GBM, nt = (N + GBN - 1) / GBN;
  const int per_group = G_GROUP * nt;
  const int group = blockIdx.x / per_group, in_group = blockIdx.x % per_group;
  const int first = group * G_GROUP;
  const int rows_in_group = min(mt - first, G_GROUP);
  const int m0 = (first + in_group % rows_in_group) * GBM;
  const int n0 = (in_group / rows_in_group) * GBN;
  const int nk = (K + GBK - 1) / GBK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= G_CONSUMERS) {
    // ---- the producer warp: its first thread keeps the ring full ----
    if (threadIdx.x == G_CONSUMERS) {
      for (int kt = 0; kt < nk; ++kt) {
        gemm_refill(ring, full, empty, &amap, &bmap, kt, m0, n0);
      }
    }
    return;
  }

  // ---- consumers: 64 rows of the tile a warpgroup ----
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  uint32_t acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0u;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % G_STAGES;
    const uint32_t a_rows = ring + s * STAGE_BYTES + wg * (64 * GBK);
    const uint32_t b_rows = ring + s * STAGE_BYTES + A_BYTES;
    mbar_wait(full + 8 * s, (kt / G_STAGES) & 1);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GBK / 32; ++kk) {
      wgmma_s8_ss_n256(acc, wgmma_desc(a_rows + kk * 32, 16, 1024),
                       wgmma_desc(b_rows + kk * 32, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the products of step kt - 1 are done
    pin(acc);
    if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % G_STAGES));
  }
  wgmma_wait<0>();
  pin(acc);
  bar_sync(1, G_CONSUMERS);  // both warpgroups are done with the ring

  // stage this warpgroup's 64 rows as int32 (columns 8 j + 2 t + {0, 1} of
  // rows g and g + 8 of the warp's 16)
  const int g = lane >> 2, t = lane & 3;
  uint8_t* stage = ring_ptr + wg * 64 * ACC_PITCH;
#pragma unroll
  for (int j = 0; j < GBN / 8; ++j) {
    const int r = warp * 16 + g, c = j * 8 + t * 2;
    *reinterpret_cast<uint2*>(stage + r * ACC_PITCH + c * 4) =
        make_uint2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint2*>(stage + (r + 8) * ACC_PITCH + c * 4) =
        make_uint2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  bar_sync(2 + wg, 128);

  // 4 columns of one row a thread: rows of 64 chunks, 2 rows an iteration
  const int tid = threadIdx.x & 127;
  const bool vec = N % 4 == 0;
#pragma unroll 4
  for (int it = 0; it < 32; ++it) {
    const int r = it * 2 + (tid >> 6), c = (tid & 63) * 4;
    const int row = m0 + wg * 64 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    const int4 a = *reinterpret_cast<const int4*>(stage + r * ACC_PITCH + c * 4);
    const int av[4] = {a.x, a.y, a.z, a.w};
    const long long idx = (long long)row * N + col;
    const int n_here = min(4, N - col);
    if (MODE == 0) {
      if (vec) {
        *reinterpret_cast<int4*>(static_cast<int*>(out) + idx) = a;
      } else {
        for (int e = 0; e < n_here; ++e) static_cast<int*>(out)[idx + e] = av[e];
      }
      continue;
    }
    const float s_row = sx[row];
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ce = e < n_here ? col + e : col;
      y[e] = __fmul_rn(__fmul_rn(static_cast<float>(av[e]), s_row), sw[ce]);
      if (bias != nullptr) y[e] = __fadd_rn(y[e], bias[ce]);
    }
    if (MODE == 1) {
      bf16* o = static_cast<bf16*>(out) + idx;
      if (vec) {
        *reinterpret_cast<uint2*>(o) =
            make_uint2(pack_f(y[0], y[1]), pack_f(y[2], y[3]));
      } else {
        for (int e = 0; e < n_here; ++e) o[e] = __float2bfloat16_rn(y[e]);
      }
    } else {
      float* o = static_cast<float*>(out) + idx;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
        for (int e = 0; e < n_here; ++e) o[e] = y[e];
      }
    }
  }
}

// [rows, K] int8, row-major, as a 2-D map (K, rows) with boxes of
// [box_rows x 128 bytes] under the 128-byte swizzle
bool make_gemm_map(CUtensorMap* map, const void* ptr, int rows, int K,
                   int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const long long strides[1] = {K};
  const cuuint32_t box[2] = {GBK, (cuuint32_t)box_rows};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int MODE>
int launch_gemm(const void* xq, const void* w, int M, int N, int K,
                const float* sx, const float* sw, const float* bias, void* out,
                cudaStream_t st) {
  CUtensorMap amap = {}, bmap = {};
  if (!make_gemm_map(&amap, xq, M, K, GBM) ||
      !make_gemm_map(&bmap, w, N, K, GBN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = int8_gemm_wgmma_kernel<MODE>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((M + GBM - 1) / GBM) * ((N + GBN - 1) / GBN);
  kernel<<<tiles, G_THREADS, G_SMEM, st>>>(amap, bmap, M, N, K, sx, sw, bias,
                                           out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] bf16 (x_dtype 0) or fp32 (1), contiguous -> xq [M, round_up(K,
// 16)] int8 (zero codes past K; 16-byte aligned) and sx [M] fp32, K2's
// contract. Any K >= 1 and any alignment of x.
extern "C" int k2_quantize_rows(const void* x, int M, int K, int x_dtype,
                                void* xq, void* sx, void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || x_dtype < 0 || x_dtype > 1 ||
      reinterpret_cast<uintptr_t>(xq) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RowArgs a = {};
  a.x = x;
  a.rows = M;
  a.K = K;
  a.nslot = (K + 15) / 16;
  a.xq = static_cast<int8_t*>(xq);
  a.sx = static_cast<float*>(sx);
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_dtype == 0 ? launch_k2_rows<bf16>(a, vec, st)
                      : launch_k2_rows<float>(a, vec, st);
}

// K2's codes against given row scales: x [M, K] bf16 (x_dtype 0) or fp32 (1),
// contiguous, and sx [M] fp32 -> xq [M, round_up(K, 16)] int8 (zero codes
// past K; 16-byte aligned). The same shapes and loads as k2_quantize_rows,
// without the amax pass; sx is read, not written.
extern "C" int k2_quantize_rows_scaled(const void* x, int M, int K,
                                       int x_dtype, const void* sx, void* xq,
                                       void* stream) {
  if (M <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || x_dtype < 0 || x_dtype > 1 || sx == nullptr ||
      reinterpret_cast<uintptr_t>(xq) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RowArgs a = {};
  a.x = x;
  a.rows = M;
  a.K = K;
  a.nslot = (K + 15) / 16;
  a.xq = static_cast<int8_t*>(xq);
  a.sgiven = static_cast<const float*>(sx);
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_dtype == 0 ? launch_k2_rows<bf16, GIVEN>(a, vec, st)
                      : launch_k2_rows<float, GIVEN>(a, vec, st);
}

// The int8 attention tiers' quantize of Q or K: x [B, H, S, D] bf16 (x_dtype
// 0) or fp32 (1) with element strides (sb, sh, ss) and a unit last one, 16-
// byte aligned, D 64, 80 or 128 -> codes xq [B, H, S, D] int8 (contiguous) and
// scales sx[(b H + h) scale_pitch + s] = max(amax, 1e-6) * c, fp32 (the
// entries past S are left alone).
extern "C" int k2_prologue_quantize(const void* x, int B, int H, int S, int D,
                                    long long sb, long long sh, long long ss,
                                    int x_dtype, float c, void* xq, void* sx,
                                    int scale_pitch, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  const int esize = x_dtype == 0 ? 2 : 4;
  if ((D != 64 && D != 80 && D != 128) || x_dtype < 0 || x_dtype > 1 ||
      scale_pitch < S || reinterpret_cast<uintptr_t>(x) % 16 ||
      (sb * esize) % 16 || (sh * esize) % 16 || (ss * esize) % 16 ||
      reinterpret_cast<uintptr_t>(xq) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RowArgs a = {};
  a.x = x;
  a.rows = (long long)B * H * S;
  a.K = D;
  a.nslot = D / 16;
  a.S = S;
  a.H = H;
  a.sb = sb;
  a.sh = sh;
  a.ss = ss;
  a.scale_pitch = scale_pitch;
  a.c = c;
  a.xq = static_cast<int8_t*>(xq);
  a.sx = static_cast<float*>(sx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one slot a lane: a row is D / 16 lanes of a warp (8 lanes at D = 80,
  // the last 3 idle)
  if (x_dtype == 0) {
    return D == 64 ? launch_rows<bf16, PROLOGUE, 4, 1, true>(a, st)
                   : launch_rows<bf16, PROLOGUE, 8, 1, true>(a, st);
  }
  return D == 64 ? launch_rows<float, PROLOGUE, 4, 1, true>(a, st)
                 : launch_rows<float, PROLOGUE, 8, 1, true>(a, st);
}

// xq [M, K] and w [N, K] int8 (16-byte aligned), sx [M], sw [N] and bias
// [N] (or null) fp32 -> out [M, N]: out_mode 0 int32 accumulator, 1 bf16,
// 2 fp32. K must be a positive multiple of 16.
extern "C" int k2_int8_gemm(const void* xq, const void* w, int M, int N, int K,
                            const void* sx, const void* sw, const void* bias,
                            void* out, int out_mode, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || K % 16 != 0 || reinterpret_cast<uintptr_t>(xq) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fsx = static_cast<const float*>(sx);
  const float* fsw = static_cast<const float*>(sw);
  const float* fb = static_cast<const float*>(bias);
  if (out_mode == 0) return launch_gemm<0>(xq, w, M, N, K, fsx, fsw, fb, out, st);
  if (out_mode == 1) return launch_gemm<1>(xq, w, M, N, K, fsx, fsw, fb, out, st);
  if (out_mode == 2) return launch_gemm<2>(xq, w, M, N, K, fsx, fsw, fb, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
