// K1 and K6: exact flash attention forward, bf16, for sm_90a, on wgmma.
//
// K1 replaces the exact tier of the Pallas TPU kernel
// ltx_video_gpupoor_tpu/ops/flash_attention.py::_flash_kernel (reached
// through flash_attention, :412 -> pl.pallas_call :631) and K6 the
// head-packed kernel _hp_kernel (:663, reached through flash_attention_hp,
// :804 -> pl.pallas_call :866). Both entries run one block; K6 hands it the
// strides of the projections' [B, S, H*D] layout (head h starts D*h values
// into a token's row), which on the TPU needed a kernel of its own.
//
// Computes o = softmax(q k^T * scale) v, bf16 in and out, fp32 scores and
// sums, D in {64, 128}, any Sq and Skv, any strides with a unit last stride
// (head-split views and slices of a fused q/k/v projection are read in
// place). Masks: a static kv_valid tail, segment ids (attend iff q_seg ==
// kv_seg and kv_seg > 0) and causal. A row that sees no key returns exactly
// 0: the running max starts at M_FLOOR, a masked score sits at NEG_INF, so
// its exp2 underflows to 0 and the sum l stays 0.
//
// What bounds it on an H100: the tensor cores (4*B*H*Sq*Skv*D operations at
// 989 TFLOP/s) and, at D=64, just as much the exponentials: one ex2 a score
// on the special-function units (16 a clock on each of 132 SMs) takes as
// long as the two products of a 64-wide head, so the two cannot both be
// hidden and the tensor bound alone is out of reach there. Memory does not
// bound it: every K/V tile is used by 128 q rows and stays in L2 across
// the q tiles of a head.
//
// Design. One block = 128 q rows of one (batch, head), in two consumer
// warpgroups of 64 rows each.
// - Both products run on wgmma.mma_async. Q.K^T is m64n128k16 with Q (loaded
//   once) and the K tile read from shared memory through descriptors; P.V is
//   m64nDk16 with P taken from registers (the fp32 score accumulator, after
//   exp2, packed to bf16, already has the A-fragment layout) and the V tile
//   [kv, D] read through a transposed-B descriptor. No thread issues a
//   shared-memory load for K or V.
// - K and V tiles of 128 kv rows arrive under the math: one thread issues TMA
//   loads (cp.async.bulk.tensor) into a ring of stages (four at D=64, two at
//   D=128), K and V each with a full and an empty mbarrier a stage. One 4-D
//   tensor map an operand over (D, S, H, B) with the caller's strides covers
//   [B, H, S, D], head-split views and K6's packed rows alike, writes the
//   128-byte swizzle that wgmma reads, and zero-fills rows past S. A tile is
//   D/64 panels of [128 rows x 64 values] (a panel row is the swizzle span).
// - The products of one tile run under the softmax of the next: Q.K^T of
//   tile j and P.V of tile j - 1 are issued together, the exponentials of
//   tile j run while P.V is in flight, and the accumulator takes the new
//   max's factor once P.V has landed.
// - Mask code runs only where it must. The block is instantiated for three
//   mask kinds, chosen on the host from the call's static properties: none;
//   tail (only the last kv tile, the one that straddles min(Skv, kv_valid),
//   compares columns); general (segment ids compare in every tile; causal
//   skips the tiles above the diagonal and compares on the diagonal tile).
// - The exponent is one FMA and one ex2.approx a score: p = exp2(s*c - m),
//   c = scale * log2(e), m the running max of s*c.
// - Who issues the loads, and whether the warpgroups take turns, differs by
//   head dim: see Cfg. Registers a thread (ptxas, nvcc 12.9): 158-168 at
//   D=64 with a producer (384 threads), 154 without, 186 at D=128 (256
//   threads); no spills; one block an SM (145 and 161 KB of shared memory).

#include "hopper.cuh"

namespace {

// One schedule runs in two layouts of the block, because of registers. The
// schedule keeps 64 (scores, written by the Q K^T in flight) + 32 (P, read by
// the P V in flight) + D/2 (output) registers pinned a thread: 154-168 in all
// at D=64, 186 at D=128 (ptxas, nvcc 12.9).
// - With a producer (PRODUCER, the long loops of D=64): a third warpgroup
//   whose first thread issues every load, off the consumers' path. 384
//   threads leave 168 registers a thread, which D=64 fits. (ptxas did not
//   raise its budget for the code after a setmaxnreg.inc: with 168 it spilled
//   P and serialized the wgmma at D=128, whatever count was asked for, so
//   there is no setmaxnreg here.) The consumers take turns on the tensor
//   cores through two named barriers, so one's exponentials run under the
//   other's products.
// - Without (D=128, and loops of at most STAGES tiles at D=64, where the
//   ring is filled once and the producer would only add to the block's start
//   and end): 256 threads, which may hold up to 255 registers each; thread 0
//   issues the loads from inside its warpgroup's loop, a few hundred cycles
//   of a 2-us iteration at D=128 (10-15 % of D=64's shorter one, hence the
//   producer there). Taking turns cost 5-8 % at D=128 and is left out.
template <int D>
struct Cfg {
  static constexpr int PANELS = D / 64;
  static constexpr int TILE_BYTES = PANELS * PANEL_BYTES;
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int BAR_OFFSET = TILE_BYTES * (1 + 2 * STAGES);
  // the tiles (1024-byte aligned by hand), then 1 + 4 * STAGES barriers:
  // 145 KB at D=64, 161 KB at D=128, one block an SM
  static constexpr int SMEM_BYTES = 1024 + BAR_OFFSET + 8 * (1 + 4 * STAGES);
};

// ---- TMA --------------------------------------------------------------------

template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row, int head,
                                              int batch) {
  mbar_expect_tx(bar, Cfg<D>::TILE_BYTES);
#pragma unroll
  for (int p = 0; p < Cfg<D>::PANELS; ++p) {
    tma_load_4d(dst + p * PANEL_BYTES, map, bar, p * 64, row, head, batch);
  }
}

// ---- wgmma ------------------------------------------------------------------

// d (64 x 128 fp32) = a (64 x 16 bf16, shared, K-major) * b (128 x 16 bf16,
// shared, K-major)^T, added to d where scale_d != 0
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---- the block ----------------------------------------------------------------

// sc = Q K^T for one kv tile, issued and committed, not waited for
template <int D>
__device__ __forceinline__ void qk_issue(float (&sc)[64], uint32_t q_rows,
                                         uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * PANEL_BYTES + (kk & 3) * 32;
    wgmma_ss_n128(sc, wgmma_desc(q_rows + off, 16, 1024),
                  wgmma_desc(k_tile + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// One online-softmax step in the exp2 domain, in place: sc becomes p =
// exp2(s * c - m) with m the running max of s * c; l takes the fp32 sum of
// the unrounded p (per-thread partial sums, reduced at the end); a0 and a1
// are the factors that the accumulator's two rows owe the new max.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float c,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& a0, float& a1) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int jn = 0; jn < 16; ++jn) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * jn], sc[4 * jn + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
  a0 = ex2(m0 - mn0);
  a1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int jn = 0; jn < 16; ++jn) {
    sc[4 * jn] = ex2(fmaf(sc[4 * jn], c, -mn0));
    sc[4 * jn + 1] = ex2(fmaf(sc[4 * jn + 1], c, -mn0));
    sc[4 * jn + 2] = ex2(fmaf(sc[4 * jn + 2], c, -mn1));
    sc[4 * jn + 3] = ex2(fmaf(sc[4 * jn + 3], c, -mn1));
    ls0 += sc[4 * jn] + sc[4 * jn + 1];
    ls1 += sc[4 * jn + 2] + sc[4 * jn + 3];
  }
  l0 = l0 * a0 + ls0;
  l1 = l1 * a1 + ls1;
}

// Tile j of an operand goes to stage j % STAGES; its full barrier completes
// phase (j / STAGES) & 1, and so does its empty barrier when every consumer
// warp has released it.
template <int D>
__device__ __forceinline__ void refill(uint32_t ring, uint32_t full,
                                       uint32_t empty, const CUtensorMap* map,
                                       int j, int h, int b) {
  constexpr int STAGES = Cfg<D>::STAGES;
  const int s = j % STAGES;
  if (j >= STAGES) mbar_wait(empty + 8 * s, ((j / STAGES) & 1) ^ 1);
  tma_load_tile<D>(ring + s * Cfg<D>::TILE_BYTES, map, full + 8 * s, j * BKV,
                   h, b);
}

template <int D, int MASK, bool PRODUCER>
__global__ void __launch_bounds__(PRODUCER ? 384 : 256, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   bf16* __restrict__ o, const int* __restrict__ q_seg,
                   const int* __restrict__ kv_seg, int Sq, int Skv,
                   long long osb, long long osh, long long oss,
                   int kv_end, int causal, float scale_log2) {
  using C = Cfg<D>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + C::TILE_BYTES;
  const uint32_t sV = sK + STAGES * C::TILE_BYTES;
  const uint32_t q_full = base + C::BAR_OFFSET;
  const uint32_t k_full = q_full + 8;
  const uint32_t k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES;
  const uint32_t v_empty = v_full + 8 * STAGES;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int wg = threadIdx.x >> 7;

  int kv_lim = kv_end;  // columns at or past it are masked for every row
  if (MASK == MASK_GENERAL && causal && q0 + BQ < kv_lim) kv_lim = q0 + BQ;
  const int n_tiles = (kv_lim + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);  // one arrival a consumer warp
      mbar_init(v_empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (PRODUCER && wg == 2) {
    // ---- producer warpgroup: one thread keeps the K and V rings full ----
    if (threadIdx.x == 256 && n_tiles > 0) {
      tma_load_tile<D>(sQ, &qmap, q_full, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        refill<D>(sK, k_full, k_empty, &kmap, j, h, b);
        refill<D>(sV, v_full, v_empty, &vmap, j, h, b);
      }
    }
    return;
  }

  // ---- consumers: 64 q rows a warpgroup ----
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg_row0 = q0 + wg * 64;
  Rows r;
  r.row0 = wg_row0 + warp * 16 + g;
  r.row1 = r.row0 + 8;
  r.qs0 = r.qs1 = 0;
  r.kv_seg = nullptr;
  r.Skv = Skv;
  r.kv_lim = kv_lim;
  r.causal = causal;
  if (MASK == MASK_GENERAL && q_seg != nullptr) {
    r.qs0 = r.row0 < Sq ? q_seg[(long long)b * Sq + r.row0] : 0;
    r.qs1 = r.row1 < Sq ? q_seg[(long long)b * Sq + r.row1] : 0;
    r.kv_seg = kv_seg + (long long)b * Skv;
  }
  // does kv tile j need the compare at all?
  auto needs_mask = [&](int j) {
    if (MASK == MASK_TAIL) return j == n_tiles - 1;
    if (MASK == MASK_GENERAL) {
      return r.kv_seg != nullptr || (j + 1) * BKV > kv_lim ||
             (causal && (j + 1) * BKV - 1 > wg_row0);
    }
    return false;
  };
  // without a producer warpgroup, thread 0 issues the loads (thread 128
  // taking V's made both warpgroups pay: 6 % slower)
  const bool loads = !PRODUCER && threadIdx.x == 0;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = M_FLOOR, m1 = M_FLOOR, l0 = 0.f, l1 = 0.f;

  if (n_tiles > 0) {
    const uint32_t sQw = sQ + wg * (64 * 128);  // this warpgroup's rows
    uint32_t p[32];
    float a0, a1;
    constexpr bool pingpong = PRODUCER;
    if (pingpong && wg == 1) bar_arrive(1, 256);  // warpgroup 0 goes first
    if (loads) tma_load_tile<D>(sQ, &qmap, q_full, q0, h, b);
    for (int j = 0; j < STAGES && j < n_tiles; ++j) {  // the stages are empty
      if (loads) refill<D>(sK, k_full, k_empty, &kmap, j, h, b);
      if (loads) refill<D>(sV, v_full, v_empty, &vmap, j, h, b);
    }

    // tile 0: scores and softmax; its P V is issued with tile 1's Q K^T
    {
      float sc[64];
      mbar_wait(q_full, 0);
      mbar_wait(k_full, 0);
      qk_issue<D>(sc, sQw, sK);
      wgmma_wait<0>();
      pin(sc);
      if (lane == 0) mbar_arrive(k_empty);
      if (needs_mask(0)) mask_tile<MASK>(sc, r, 0, t);
      softmax_tile(sc, scale_log2, m0, m1, l0, l1, a0, a1);
      pack_p(sc, p);
    }

    // One step of the loop, for tile j >= 1. `masked` says at compile time
    // whether the tile compares (MASK_ALWAYS), does not (MASK_NEVER) or
    // finds out (MASK_ASK): with the compare behind a run-time branch in
    // every step, the tail instance ran 16-22 % slower at D=128.
    auto step = [&](int j, auto masked) {
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      // K of tile j - 1 was released in the last iteration, V of tile j - 2
      // in the one before: their stages take the tiles STAGES further on
      if (loads && j - 1 + STAGES < n_tiles) {
        refill<D>(sK, k_full, k_empty, &kmap, j - 1 + STAGES, h, b);
      }
      if (loads && j >= 2 && j - 2 + STAGES < n_tiles) {
        refill<D>(sV, v_full, v_empty, &vmap, j - 2 + STAGES, h, b);
      }
      float sc[64];
      mbar_wait(k_full + 8 * s, (j / STAGES) & 1);
      if (pingpong) bar_sync(1 + wg, 256);
      qk_issue<D>(sc, sQw, sK + s * C::TILE_BYTES);
      mbar_wait(v_full + 8 * sp, ((j - 1) / STAGES) & 1);
      pv_issue_bf16<D>(acc, p, sV + sp * C::TILE_BYTES);
      if (pingpong) bar_arrive(2 - wg, 256);
      wgmma_wait<1>();  // the scores of tile j are in
      pin(sc);
      if (lane == 0) mbar_arrive(k_empty + 8 * s);
      // tile j's softmax runs under tile j - 1's P V
      constexpr int how = decltype(masked)::value;
      if (how == MASK_ALWAYS || (how == MASK_ASK && needs_mask(j))) {
        mask_tile<MASK>(sc, r, j * BKV, t);
      }
      softmax_tile(sc, scale_log2, m0, m1, l0, l1, a0, a1);
      wgmma_wait<0>();
      pin(acc);
      if (lane == 0) mbar_arrive(v_empty + 8 * sp);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= a0;
        acc[4 * n + 1] *= a0;
        acc[4 * n + 2] *= a1;
        acc[4 * n + 3] *= a1;
      }
      pack_p(sc, p);
    };
    if (MASK == MASK_GENERAL) {
      for (int j = 1; j < n_tiles; ++j) step(j, How<MASK_ASK>{});
    } else {
      // the interior tiles carry no mask code; the tail kind's last tile,
      // the one that straddles kv_end, is peeled off the loop
      const int n_free = MASK == MASK_TAIL ? n_tiles - 1 : n_tiles;
      for (int j = 1; j < n_free; ++j) step(j, How<MASK_NEVER>{});
      if (MASK == MASK_TAIL && n_tiles > 1) {
        step(n_tiles - 1, How<MASK_ALWAYS>{});
      }
    }

    const int sl = (n_tiles - 1) % STAGES;
    mbar_wait(v_full + 8 * sl, ((n_tiles - 1) / STAGES) & 1);
    pv_issue_bf16<D>(acc, p, sV + sl * C::TILE_BYTES);
    wgmma_wait<0>();
    pin(acc);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 > 0.f ? l0 : 1.f;
  const float d1 = l1 > 0.f ? l1 : 1.f;
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + t * 2;
    if (r.row0 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + r.row0 * oss + c) =
          pack_f(acc[4 * n] / d0, acc[4 * n + 1] / d0);
    }
    if (r.row1 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + r.row1 * oss + c) =
          pack_f(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
    }
  }
}

// ---- host side ------------------------------------------------------------------

// (D, S, H, B) bf16 with element strides (1, ss, sh, sb); boxes of one
// panel; rows past S read as 0. The stride of a one-long axis is never used,
// so it is set to one that always encodes.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
              long long ss, long long sh, long long sb) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const long long strides[3] = {ss * 2, sh * 2, sb * 2};
  const cuuint32_t box[4] = {64, 128, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

struct Call {
  const void *q, *k, *v;
  void* o;
  const int *q_seg, *kv_seg;
  int B, H, Sq, Skv;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int kv_end, causal;
  float scale_log2;
  cudaStream_t stream;
};

template <int D, int MASK, bool PRODUCER>
int launch_layout(const Call& c) {
  CUtensorMap qmap = {}, kmap = {}, vmap = {};
  if (c.kv_end > 0) {  // with no key in sight the block loads nothing
    if (!make_map(&qmap, c.q, D, c.Sq, c.H, c.B, c.qss, c.qsh, c.qsb) ||
        !make_map(&kmap, c.k, D, c.Skv, c.H, c.B, c.kss, c.ksh, c.ksb) ||
        !make_map(&vmap, c.v, D, c.Skv, c.H, c.B, c.vss, c.vsh, c.vsb)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  auto kernel = flash_wgmma_kernel<D, MASK, PRODUCER>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<D>::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c.Sq + BQ - 1) / BQ, c.H, c.B);
  kernel<<<grid, PRODUCER ? 384 : 256, Cfg<D>::SMEM_BYTES, c.stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(c.o), c.q_seg, c.kv_seg, c.Sq,
      c.Skv, c.osb, c.osh, c.oss, c.kv_end, c.causal, c.scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MASK>
int launch_instance(const Call& c) {
  if constexpr (D == 64) {
    if (c.kv_end > Cfg<D>::STAGES * BKV) {
      return launch_layout<D, MASK, true>(c);
    }
  }
  return launch_layout<D, MASK, false>(c);
}

// mask_kind is the caller's choice (ops/flash_attention.py::mask_kind); a
// kind that masks less than the call needs is refused
int launch(const Call& c, int D, int kv_valid, int mask_kind) {
  if (c.Sq <= 0 || c.B <= 0 || c.H <= 0) return cudaGetLastError();
  Call call = c;
  call.kv_end = c.Skv;
  if (kv_valid >= 0 && kv_valid < call.kv_end) call.kv_end = kv_valid;
  int need = MASK_NONE;
  if (call.kv_end % BKV != 0) need = MASK_TAIL;
  if (c.q_seg != nullptr || c.causal) need = MASK_GENERAL;
  if (mask_kind < need || mask_kind > MASK_GENERAL ||
      !(c.scale_log2 > 0.f) || (c.q_seg == nullptr) != (c.kv_seg == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (D == 64) {
    if (mask_kind == MASK_NONE) return launch_instance<64, MASK_NONE>(call);
    if (mask_kind == MASK_TAIL) return launch_instance<64, MASK_TAIL>(call);
    return launch_instance<64, MASK_GENERAL>(call);
  }
  if (D == 128) {
    if (mask_kind == MASK_NONE) return launch_instance<128, MASK_NONE>(call);
    if (mask_kind == MASK_TAIL) return launch_instance<128, MASK_TAIL>(call);
    return launch_instance<128, MASK_GENERAL>(call);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K1: q, k, v and out [B, H, S, D] views with element strides (b, h, s) and a
// unit last stride; kv_valid -1 = none; mask_kind 0 none, 1 tail, 2 general
extern "C" int k1_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o,
    const void* q_seg, const void* kv_seg,
    int B, int H, int Sq, int Skv, int D,
    int qsb, int qsh, int qss, int ksb, int ksh, int kss,
    int vsb, int vsh, int vss, int osb, int osh, int oss,
    int kv_valid, int causal, int mask_kind, float scale_log2, void* stream) {
  const Call c = {q, k, v, o, static_cast<const int*>(q_seg),
                  static_cast<const int*>(kv_seg), B, H, Sq, Skv,
                  qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
                  0, causal, scale_log2, static_cast<cudaStream_t>(stream)};
  return launch(c, D, kv_valid, mask_kind);
}

// K6: q and out [B, S, H*D], k and v [B, Skv, H*D], each with a unit last
// stride and its own batch and token strides (a slice of a fused q/k/v
// projection is read in place); head h starts D*h values into a token's row
extern "C" int k6_flash_attention_hp_bf16(
    const void* q, const void* k, const void* v, void* o,
    int B, int S, int Skv, int H, int D,
    int qsb, int qss, int ksb, int kss, int vsb, int vss, int osb, int oss,
    int kv_valid, int mask_kind, float scale_log2, void* stream) {
  const Call c = {q, k, v, o, nullptr, nullptr, B, H, S, Skv,
                  qsb, D, qss, ksb, D, kss, vsb, D, vss, osb, D, oss,
                  0, 0, scale_log2, static_cast<cudaStream_t>(stream)};
  return launch(c, D, kv_valid, mask_kind);
}
