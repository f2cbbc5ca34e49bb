// K1's attention block, shared by the kernels built on it: K1, K3 and K6
// (flash_attention_wgmma.cu), K7's tensor-core body (ring_attention.cu) and
// K8 (flash_attention_pipelined.cu). What lives here: the shared-memory
// layout of the block (Q, a ring of K and V stages, their mbarriers), the
// TMA tile loads and the producer's loop, the wgmma wrappers of Q.K^T at the
// widths the kernels use, the softmax step (online, or K3's at a fixed
// offset), and the consumer's loop over the kv tiles of one 128-row q tile
// (`attend_tiles`), with its epilogue.
//
// The ring keeps a running position. Tile `it` of a block's life goes to
// stage it % STAGES, and its full barrier completes phase (it / STAGES) & 1,
// as does its empty barrier once every consumer warp has released it. K1
// runs one q tile a block, from position 0; K7's persistent blocks walk many
// q tiles and carry the position from one to the next.

#pragma once

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

// shared-memory addresses of the block's tiles and barriers
struct Ring {
  uint32_t sQ, sK, sV, q_full, k_full, k_empty, v_full, v_empty;
};

template <int D>
__device__ __forceinline__ Ring ring_layout(const void* smem_raw) {
  using C = Cfg<D>;
  Ring rg;
  rg.sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  rg.sK = rg.sQ + C::TILE_BYTES;
  rg.sV = rg.sK + C::STAGES * C::TILE_BYTES;
  rg.q_full = rg.sQ + C::BAR_OFFSET;
  rg.k_full = rg.q_full + 8;
  rg.k_empty = rg.k_full + 8 * C::STAGES;
  rg.v_full = rg.k_empty + 8 * C::STAGES;
  rg.v_empty = rg.v_full + 8 * C::STAGES;
  return rg;
}

// thread 0, before the block's first __syncthreads
template <int D>
__device__ __forceinline__ void ring_init(const Ring& rg) {
  mbar_init(rg.q_full, 1);
#pragma unroll
  for (int s = 0; s < Cfg<D>::STAGES; ++s) {
    mbar_init(rg.k_full + 8 * s, 1);
    mbar_init(rg.v_full + 8 * s, 1);
    mbar_init(rg.k_empty + 8 * s, 8);  // one arrival a consumer warp
    mbar_init(rg.v_empty + 8 * s, 8);
  }
  mbar_init_fence();
}

// ---- TMA --------------------------------------------------------------------

// `rows` rows (128 or 64) of a 4-D map from `row`, D/64 panels of 128-byte
// rows
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row, int head,
                                              int batch, int rows = BKV) {
  mbar_expect_tx(bar, Cfg<D>::PANELS * rows * 128);
#pragma unroll
  for (int p = 0; p < Cfg<D>::PANELS; ++p) {
    tma_load_4d(dst + p * PANEL_BYTES, map, bar, p * 64, row, head, batch);
  }
}

// Ring position `it` takes kv rows from `row` into its stage, after the
// stage's previous tile was released.
template <int D>
__device__ __forceinline__ void refill(uint32_t ring, uint32_t full,
                                       uint32_t empty, const CUtensorMap* map,
                                       int it, int row, int h, int b,
                                       int rows = BKV) {
  constexpr int STAGES = Cfg<D>::STAGES;
  const int s = it % STAGES;
  if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
  tma_load_tile<D>(ring + s * Cfg<D>::TILE_BYTES, map, full + 8 * s, row, h,
                   b, rows);
}

// The producer warpgroup's first thread: Q, then every K and V tile of one
// q tile, `rows` kv rows a tile, from ring position 0.
template <int D>
__device__ __forceinline__ void produce(const Ring& rg, const CUtensorMap* qmap,
                                        const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, int q0, int h,
                                        int b, int n_tiles, int rows = BKV) {
  tma_load_tile<D>(rg.sQ, qmap, rg.q_full, q0, h, b);
  for (int j = 0; j < n_tiles; ++j) {
    refill<D>(rg.sK, rg.k_full, rg.k_empty, kmap, j, j * rows, h, b, rows);
    refill<D>(rg.sV, rg.v_full, rg.v_empty, vmap, j, j * rows, h, b, rows);
  }
}

// ---- wgmma ------------------------------------------------------------------

// d (64 x N fp32) = a (64 x 16 bf16, shared, K-major) * b (N x 16 bf16,
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

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// sc (64 q rows x N kv rows) = Q K^T, K's N rows from k_rows (a multiple of
// 8 rows into a tile, so the swizzle's phase holds), issued and committed,
// not waited for
template <int D, int N>
__device__ __forceinline__ void qk_issue(float (&sc)[N / 2], uint32_t q_rows,
                                         uint32_t k_rows) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * PANEL_BYTES + (kk & 3) * 32;
    const uint64_t da = wgmma_desc(q_rows + off, 16, 1024);
    const uint64_t db = wgmma_desc(k_rows + off, 16, 1024);
    if constexpr (N == 128) wgmma_ss_n128(sc, da, db, kk > 0);
    if constexpr (N == 64) wgmma_ss_n64(sc, da, db, kk > 0);
    if constexpr (N == 32) wgmma_ss_n32(sc, da, db, kk > 0);
    if constexpr (N == 16) wgmma_ss_n16(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// ---- the softmax step ---------------------------------------------------------

// One softmax step in the exp2 domain, in place, over N = kv columns / 2
// scores a thread. Online (K1, K6, K7, K8): sc becomes p = exp2(s * c - m)
// with m the running max of s * c; a0 and a1 are the factors that the
// accumulator's two rows owe the new max. BOUNDED (K3): p = exp2(min(s * c,
// sb) - sb) at the fixed offset sb = score_bound * log2(e), with no max, no
// shuffle and no factor (m and a are left alone; a masked score at NEG_INF
// gives 0). l takes the sum of p (per-thread partial sums, reduced at the
// end): the fp32 p, or with ROUNDED the bf16-rounded p that the P.V product
// sees (one conversion a pair, the halves read back with integer ops;
// pack_rounded then packs them without converting again).
template <int N, bool ROUNDED = false, bool BOUNDED = false>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float c,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& a0, float& a1,
                                             float sb = 0.f) {
  float mn0 = 0.f, mn1 = 0.f;
  if constexpr (!BOUNDED) {
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int jn = 0; jn < N / 4; ++jn) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * jn], sc[4 * jn + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    mn0 = fmaxf(m0, mx0 * c);
    mn1 = fmaxf(m1, mx1 * c);
    a0 = ex2(m0 - mn0);
    a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
  }
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int jn = 0; jn < N / 4; ++jn) {
    if constexpr (BOUNDED) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * jn + e] = ex2(fminf(sc[4 * jn + e] * c, sb) - sb);
      }
    } else {
      sc[4 * jn] = ex2(fmaf(sc[4 * jn], c, -mn0));
      sc[4 * jn + 1] = ex2(fmaf(sc[4 * jn + 1], c, -mn0));
      sc[4 * jn + 2] = ex2(fmaf(sc[4 * jn + 2], c, -mn1));
      sc[4 * jn + 3] = ex2(fmaf(sc[4 * jn + 3], c, -mn1));
    }
    if constexpr (ROUNDED) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const uint32_t pk = pack_f(sc[4 * jn + e], sc[4 * jn + e + 1]);
        sc[4 * jn + e] = __uint_as_float(pk << 16);
        sc[4 * jn + e + 1] = __uint_as_float(pk & 0xffff0000u);
      }
    }
    ls0 += sc[4 * jn] + sc[4 * jn + 1];
    ls1 += sc[4 * jn + 2] + sc[4 * jn + 3];
  }
  if constexpr (BOUNDED) {
    l0 += ls0;
    l1 += ls1;
  } else {
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
  }
}

// pack_p for p that are bf16 values already (softmax_tile<N, true>): the
// high halves side by side, no conversion
template <int N>
__device__ __forceinline__ void pack_rounded(const float (&sc)[N],
                                             uint32_t (&p)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    p[i] = __byte_perm(__float_as_uint(sc[2 * i]),
                       __float_as_uint(sc[2 * i + 1]), 0x7632);
  }
}

// p in the A-fragment order of the P.V product
template <bool ROUNDED, int N>
__device__ __forceinline__ void pack(const float (&sc)[N],
                                     uint32_t (&p)[N / 2]) {
  if constexpr (ROUNDED) {
    pack_rounded(sc, p);
  } else {
    pack_p(sc, p);
  }
}

// acc (64 q rows x D) *= the new max's factors of its two rows
template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], float a0,
                                        float a1) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[4 * n] *= a0;
    acc[4 * n + 1] *= a0;
    acc[4 * n + 2] *= a1;
    acc[4 * n + 3] *= a1;
  }
}

// ---- the consumers' loop ------------------------------------------------------

// what a consumer thread's loop needs beyond its registers
struct Tiles {
  const CUtensorMap *qmap, *kmap, *vmap;
  int q0, h, b;      // the q tile's first row, its head and batch row
  int n_tiles;       // kv tiles of BKV rows; > 0
  int it;            // ring position of the first kv tile
  int q_phase;       // the phase of q_full that brings this q tile
  float c;           // scale * log2(e)
  float sb = 0.f;    // BOUNDED: score_bound * log2(e)
};

// One consumer warpgroup's 64 q rows of one 128-row q tile against n_tiles
// kv tiles, folded into (acc, m, l). Q.K^T of tile j and P.V of tile j - 1
// are issued together, the exponentials of tile j run while P.V is in
// flight, and the accumulator takes the new max's factor once P.V has
// landed. Without a producer, thread 0 issues Q and the kv tiles from here.
// CARRY: (acc, m, l) come in from an earlier kv range (K7's ring steps) and
// the block goes on to another q tile afterwards, so tile 0's factor reaches
// acc and the last V stage is released. ROUNDED: l sums the bf16-rounded p
// (K8; K3 at D=64). BOUNDED: K3's step at the fixed offset tl.sb, so acc
// owes no factor and is never rescaled. needs_mask(j) says whether tile j
// compares columns (see MASK below).
template <int D, int MASK, bool PRODUCER, bool CARRY, bool ROUNDED = false,
          bool BOUNDED = false, typename NeedsMask>
__device__ __forceinline__ void attend_tiles(const Ring& rg, const Tiles& tl,
                                             const Rows& r,
                                             NeedsMask needs_mask,
                                             float (&acc)[D / 2], float& m0,
                                             float& m1, float& l0, float& l1) {
  static_assert(!(BOUNDED && CARRY), "K7 carries the online softmax state");
  using C = Cfg<D>;
  constexpr int STAGES = C::STAGES;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31, t = lane & 3;
  const int n_tiles = tl.n_tiles;
  const int it = tl.it;
  // without a producer warpgroup, thread 0 issues the loads (thread 128
  // taking V's made both warpgroups pay: 6 % slower)
  const bool loads = !PRODUCER && threadIdx.x == 0;
  const uint32_t sQw = rg.sQ + wg * (64 * 128);  // this warpgroup's rows
  auto stage = [&](int j) { return (it + j) % STAGES; };
  auto phase = [&](int j) { return ((it + j) / STAGES) & 1; };
  auto load_k = [&](int j) {
    refill<D>(rg.sK, rg.k_full, rg.k_empty, tl.kmap, it + j, j * BKV, tl.h,
              tl.b);
  };
  auto load_v = [&](int j) {
    refill<D>(rg.sV, rg.v_full, rg.v_empty, tl.vmap, it + j, j * BKV, tl.h,
              tl.b);
  };
  uint32_t p[32];
  float a0, a1;
  constexpr bool pingpong = PRODUCER;
  if (pingpong && wg == 1) bar_arrive(1, 256);  // warpgroup 0 goes first
  if (loads) tma_load_tile<D>(rg.sQ, tl.qmap, rg.q_full, tl.q0, tl.h, tl.b);
  for (int j = 0; j < STAGES && j < n_tiles; ++j) {  // fill the stages
    if (loads) load_k(j);
    if (loads) load_v(j);
  }

  // tile 0: scores and softmax; its P V is issued with tile 1's Q K^T
  {
    float sc[64];
    mbar_wait(rg.q_full, tl.q_phase);
    mbar_wait(rg.k_full + 8 * stage(0), phase(0));
    qk_issue<D, BKV>(sc, sQw, rg.sK + stage(0) * C::TILE_BYTES);
    wgmma_wait<0>();
    pin(sc);
    if (lane == 0) mbar_arrive(rg.k_empty + 8 * stage(0));
    if (needs_mask(0)) mask_tile<MASK>(sc, r, 0, t);
    softmax_tile<64, ROUNDED, BOUNDED>(sc, tl.c, m0, m1, l0, l1, a0, a1,
                                       tl.sb);
    if (CARRY) rescale<D>(acc, a0, a1);
    pack<ROUNDED>(sc, p);
  }

  // One step of the loop, for tile j >= 1. `masked` says at compile time
  // whether the tile compares (MASK_ALWAYS), does not (MASK_NEVER) or
  // finds out (MASK_ASK): with the compare behind a run-time branch in
  // every step, the tail instance ran 16-22 % slower at D=128.
  auto step = [&](int j, auto masked) {
    const int s = stage(j), sp = stage(j - 1);
    // K of tile j - 1 was released in the last iteration, V of tile j - 2
    // in the one before: their stages take the tiles STAGES further on
    if (loads && j - 1 + STAGES < n_tiles) load_k(j - 1 + STAGES);
    if (loads && j >= 2 && j - 2 + STAGES < n_tiles) load_v(j - 2 + STAGES);
    float sc[64];
    mbar_wait(rg.k_full + 8 * s, phase(j));
    if (pingpong) bar_sync(1 + wg, 256);
    qk_issue<D, BKV>(sc, sQw, rg.sK + s * C::TILE_BYTES);
    mbar_wait(rg.v_full + 8 * sp, phase(j - 1));
    pv_issue_bf16<D>(acc, p, rg.sV + sp * C::TILE_BYTES);
    if (pingpong) bar_arrive(2 - wg, 256);
    wgmma_wait<1>();  // the scores of tile j are in
    pin(sc);
    if (lane == 0) mbar_arrive(rg.k_empty + 8 * s);
    // tile j's softmax runs under tile j - 1's P V
    constexpr int how = decltype(masked)::value;
    if (how == MASK_ALWAYS || (how == MASK_ASK && needs_mask(j))) {
      mask_tile<MASK>(sc, r, j * BKV, t);
    }
    softmax_tile<64, ROUNDED, BOUNDED>(sc, tl.c, m0, m1, l0, l1, a0, a1,
                                       tl.sb);
    wgmma_wait<0>();
    pin(acc);
    if (lane == 0) mbar_arrive(rg.v_empty + 8 * sp);
    if (!BOUNDED) rescale<D>(acc, a0, a1);
    pack<ROUNDED>(sc, p);
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

  const int sl = stage(n_tiles - 1);
  mbar_wait(rg.v_full + 8 * sl, phase(n_tiles - 1));
  pv_issue_bf16<D>(acc, p, rg.sV + sl * C::TILE_BYTES);
  wgmma_wait<0>();
  pin(acc);
  if (CARRY && lane == 0) mbar_arrive(rg.v_empty + 8 * sl);
}

// this thread's two rows of acc / (d0, d1) as bf16 into o (row stride oss),
// rows at or past `rows` left alone; the first DV columns (a head of DV < D
// values run in the D layout: its columns past DV are zeros)
template <int D, int DV = D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], float d0,
                                           float d1, bf16* o, long long oss,
                                           int row0, int row1, int rows,
                                           int t) {
  static_assert(DV <= D && DV % 8 == 0, "whole 8-column groups of acc");
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    const int c = n * 8 + t * 2;
    if (row0 < rows) {
      *reinterpret_cast<uint32_t*>(o + row0 * oss + c) =
          pack_f(acc[4 * n] / d0, acc[4 * n + 1] / d0);
    }
    if (row1 < rows) {
      *reinterpret_cast<uint32_t*>(o + row1 * oss + c) =
          pack_f(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
    }
  }
}

// the four partial sums of a row's l (one a thread of the quad) added up
__device__ __forceinline__ float quad_sum(float l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  return l;
}

// ---- host side ------------------------------------------------------------------

// (D, S, H, B) bf16 with element strides (1, ss, sh, sb); boxes of one
// panel by `rows` rows; rows past S read as 0, and so do the columns past D
// of a panel (a head of D = 80 values loads as two panels of 64)
inline bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int H,
                     int B, long long ss, long long sh, long long sb,
                     int rows = BKV) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const long long strides[3] = {ss * 2, sh * 2, sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
