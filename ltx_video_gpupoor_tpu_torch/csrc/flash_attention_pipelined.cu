// K8: flash attention forward whose kv tile is cut into sub-blocks, with the
// Q.K^T of sub-block t+1 issued before the softmax of sub-block t, bf16,
// for sm_90a.
//
// Replaces the Pallas TPU kernel tools/mb_selfattn_pipeline.py::_kernel
// (reached through pipelined_attention, :81 -> pl.pallas_call :93), an
// experiment beside the production kernel (K1): does giving the tensor
// cores independent matrix work to run under the exponentials move an
// attention kernel?
//
// Computes o = softmax(q k^T / sqrt(D)) v over [B, H, S, D] views (any
// strides with a unit last stride), D = 64, no mask, S a multiple of the kv
// tile. The contract is the TPU kernel's, rounding for rounding: q is
// multiplied by D**-0.5 * log2(e) in fp32 and rounded to bf16 once; the
// scores are fp32; the running max (from -1e20) and the rescale are taken
// per sub-block; p = exp2(s - m) meets V as bf16; the denominator is the sum
// of those bf16-rounded p (on the TPU a ones column of V collects it).
//
// Design: K1's D=64 block (attention_block.cuh) in its producer layout. 128
// q rows a block in two consumer warpgroups, a producer warpgroup whose
// first thread keeps a four-stage TMA ring of K and V tiles full, both
// products on wgmma with P from registers. The TPU's 768 x 2688 blocks
// answer its VMEM; here the kv tile is TR = 128 rows (64 for lengths that
// 128 does not divide, the tool's check at S = 1344), the sub-block BSUB =
// block_kv / nsub rows: 128, 64, 32 or 16, each a legal wgmma width.
// - Q is scaled and rounded in place in shared memory after its TMA load
//   (the 128-byte swizzle moves 16-byte chunks within a row, and every
//   value takes the same factor), then fence.proxy.async makes the stores
//   visible to wgmma, which reads Q through the async proxy.
// - nsub 1 (BSUB = 128) is K1's own schedule with these roundings: Q.K^T of
//   tile j and P.V of tile j - 1 in flight together, the consumers taking
//   turns on the tensor cores. Two 128-wide score fragments, the look-ahead
//   below would need, do not fit the 168 registers a thread of 384.
// - BSUB <= 64: the sub-blocks run as one sequence across the tiles. The
//   Q.K^T of sub-block u + 1 (m64nBSUBk16, D/16 of them) is committed
//   before the max, exp2 and P.V of sub-block u, together with the P.V of
//   u - 1 (BSUB/16 k-steps of m64n64k16), and both run under u's softmax.
//   At BSUB = 16 each Q.K^T is m64n16k16 and each P.V a single k16 step:
//   issue overhead, which is what the tool measures. (64, 1) computes what
//   (128, 2) computes, on 64-row tiles, so it runs this loop too.
// q rows past S (the check's 1344 rows leave half a q tile) read as 0 and
// are not stored.
//
// What bounds it on an H100: as K1 at D=64, the tensor cores and just as
// much the exponentials (one ex2 a score takes as long on the special
// function units as both products of a 64-wide head), not memory.

#include "attention_block.cuh"

namespace {

constexpr int HD = 64;  // the head dim K8 takes
using C = Cfg<HD>;

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// this warpgroup's 64 rows of Q (8 KB) times c, rounded to bf16, in place;
// then visible to the warpgroup's wgmma
__device__ __forceinline__ void scale_q(uint32_t rows, float c, int wg) {
  for (int i = threadIdx.x & 127; i < 64 * 128 / 16; i += 128) {
    uint4 val = lds128(rows + i * 16);
    bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * c);
    }
    sts128(rows + i * 16, val);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_sync(3 + wg, 128);  // 1 and 2 are the consumers' turns
}

// One consumer warpgroup's 64 q rows against n_tiles kv tiles of TR rows,
// sub-block by sub-block (BSUB rows each). Step u issues the Q.K^T of
// u + 1 and the P.V of u - 1 together, takes the max, exp2 and sum of u
// under both, then waits for both: no wgmma group is in flight from one
// step to the next (ptxas serializes every wgmma of a loop whose groups
// stay in flight across its back edge while other code reads their
// accumulators).
template <int TR, int BSUB>
__device__ __forceinline__ void attend_ahead(const Ring& rg, int n_tiles,
                                             float (&acc)[HD / 2], float& m0,
                                             float& m1, float& l0,
                                             float& l1) {
  constexpr int SPT = TR / BSUB;  // sub-blocks a tile
  constexpr int NS = BSUB / 2;    // scores a thread of one sub-block
  constexpr int STAGES = C::STAGES;
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const uint32_t sQw = rg.sQ + wg * (64 * 128);
  // sub-block u's rows of the K or V ring: tile u / SPT, rows from
  // (u % SPT) * BSUB, 128 bytes a row
  auto rows = [&](uint32_t ring, int u) {
    return ring + (u / SPT) % STAGES * C::TILE_BYTES + u % SPT * BSUB * 128;
  };
  auto stage = [&](int u) { return (u / SPT) % STAGES; };
  auto phase = [&](int u) { return (u / SPT / STAGES) & 1; };
  const int n_sub = n_tiles * SPT;
  float sc[NS];   // scores of sub-block u, then its p
  float sn[NS];   // scores of u + 1, written by the Q.K^T in flight
  uint32_t p[NS / 2];
  float a0, a1;

  mbar_wait(rg.k_full, 0);
  qk_issue<HD, BSUB>(sc, sQw, rows(rg.sK, 0));
  wgmma_wait<0>();
  pin(sc);
  // Step u: sc holds its scores, p the P of u - 1 (unless `first`), acc
  // the rows up to u - 1 but for u - 1's P.V; `ahead`: u + 1 exists. Every
  // sub-block waits for its tile's barriers: after the tile's first they
  // have completed and return at once.
  auto step = [&](int u, auto first, auto ahead) {
    constexpr bool is_first = decltype(first)::value;
    constexpr bool next = decltype(ahead)::value;
    // Q.K^T of u is done with its K rows
    if (u % SPT == SPT - 1 && lane == 0) {
      mbar_arrive(rg.k_empty + 8 * stage(u));
    }
    if (next) {  // u + 1's Q.K^T goes before u's softmax
      mbar_wait(rg.k_full + 8 * stage(u + 1), phase(u + 1));
      qk_issue<HD, BSUB>(sn, sQw, rows(rg.sK, u + 1));
    }
    if (!is_first) {
      mbar_wait(rg.v_full + 8 * stage(u - 1), phase(u - 1));
      pv_issue_bf16<HD, BSUB>(acc, p, rows(rg.sV, u - 1));
    }
    softmax_tile<NS, true>(sc, 1.f, m0, m1, l0, l1, a0, a1);
    wgmma_wait<0>();
    pin(acc);
    pin(sn);
    if (!is_first && (u - 1) % SPT == SPT - 1 && lane == 0) {
      mbar_arrive(rg.v_empty + 8 * stage(u - 1));
    }
    rescale<HD>(acc, a0, a1);
    pack_rounded(sc, p);
    if (next) {
#pragma unroll
      for (int i = 0; i < NS; ++i) sc[i] = sn[i];
    }
  };
  using Yes = How<1>;
  using No = How<0>;
  if (n_sub == 1) {
    step(0, Yes{}, No{});
  } else {
    step(0, Yes{}, Yes{});
    for (int u = 1; u + 1 < n_sub; ++u) step(u, No{}, Yes{});
    step(n_sub - 1, No{}, No{});
  }
  // the last sub-block's P.V
  mbar_wait(rg.v_full + 8 * stage(n_sub - 1), phase(n_sub - 1));
  pv_issue_bf16<HD, BSUB>(acc, p, rows(rg.sV, n_sub - 1));
  wgmma_wait<0>();
  pin(acc);
}

template <int TR, int BSUB>
__global__ void __launch_bounds__(384, 1)
flash_pipelined_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       bf16* __restrict__ o, int S, long long osb,
                       long long osh, long long oss, float c) {
  extern __shared__ uint8_t smem_raw[];
  const Ring rg = ring_layout<HD>(smem_raw);
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int wg = threadIdx.x >> 7;
  const int n_tiles = S / TR;

  if (threadIdx.x == 0) ring_init<HD>(rg);
  __syncthreads();

  if (wg == 2) {
    // ---- producer warpgroup: one thread keeps the K and V rings full ----
    if (threadIdx.x == 256) {
      produce<HD>(rg, &qmap, &kmap, &vmap, q0, h, b, n_tiles, TR);
    }
    return;
  }

  // ---- consumers: 64 q rows a warpgroup ----
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  Rows r;
  r.row0 = q0 + wg * 64 + warp * 16 + g;
  r.row1 = r.row0 + 8;
  r.qs0 = r.qs1 = 0;
  r.kv_seg = nullptr;
  r.Skv = r.kv_lim = S;
  r.causal = 0;

  // q * (D**-0.5 * log2 e), rounded to bf16 once
  mbar_wait(rg.q_full, 0);
  scale_q(rg.sQ + wg * (64 * 128), c, wg);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m0 = M_FLOOR, m1 = M_FLOOR, l0 = 0.f, l1 = 0.f;
  if constexpr (BSUB == BKV) {
    // the scores are in the exp2 domain already: c = 1
    const Tiles tl = {&qmap, &kmap, &vmap, q0, h, b, n_tiles, 0, 0, 1.f};
    attend_tiles<HD, MASK_NONE, true, false, true>(
        rg, tl, r, [](int) { return false; }, acc, m0, m1, l0, l1);
  } else {
    attend_ahead<TR, BSUB>(rg, n_tiles, acc, m0, m1, l0, l1);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_rows<HD>(acc, l0 > 0.f ? l0 : 1.f, l1 > 0.f ? l1 : 1.f,
                 o + b * osb + h * osh, oss, r.row0, r.row1, S, t);
}

struct Call {
  const void *q, *k, *v;
  void* o;
  int B, H, S;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  float c;
  cudaStream_t stream;
};

template <int TR, int BSUB>
int launch(const Call& a) {
  CUtensorMap qmap = {}, kmap = {}, vmap = {};
  if (!make_map(&qmap, a.q, HD, a.S, a.H, a.B, a.qss, a.qsh, a.qsb) ||
      !make_map(&kmap, a.k, HD, a.S, a.H, a.B, a.kss, a.ksh, a.ksb, TR) ||
      !make_map(&vmap, a.v, HD, a.S, a.H, a.B, a.vss, a.vsh, a.vsb, TR)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_pipelined_kernel<TR, BSUB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, 384, C::SMEM_BYTES, a.stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(a.o), a.S, a.osb, a.osh, a.oss,
      a.c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out [B, H, S, 64] bf16 with a unit last stride; block_kv 128
// (nsub 1, 2, 4, 8) or 64 (nsub 1, 2, 4); S a multiple of block_kv;
// c = 64**-0.5 * log2(e)
extern "C" int k8_flash_attention_pipelined_bf16(
    const void* q, const void* k, const void* v, void* o,
    int B, int H, int S, int Dh,
    int qsb, int qsh, int qss, int ksb, int ksh, int kss,
    int vsb, int vsh, int vss, int osb, int osh, int oss,
    int block_kv, int nsub, float c, void* stream) {
  if (Dh != HD || S <= 0 || B <= 0 || H <= 0 ||
      (block_kv != 64 && block_kv != 128) || S % block_kv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Call a = {q, k, v, o, B, H, S, qsb, qsh, qss, ksb, ksh, kss,
                  vsb, vsh, vss, osb, osh, oss, c,
                  static_cast<cudaStream_t>(stream)};
  switch (block_kv * 16 + nsub) {
    case 128 * 16 + 1: return launch<128, 128>(a);
    case 128 * 16 + 2: return launch<128, 64>(a);
    case 128 * 16 + 4: return launch<128, 32>(a);
    case 128 * 16 + 8: return launch<128, 16>(a);
    case 64 * 16 + 1: return launch<64, 64>(a);
    case 64 * 16 + 2: return launch<64, 32>(a);
    case 64 * 16 + 4: return launch<64, 16>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
