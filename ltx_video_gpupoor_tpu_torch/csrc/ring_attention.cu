// K7: ring attention, the whole ring of p ranks in one cooperative launch,
// for sm_90a.
//
// Replaces the Pallas TPU kernel
// ltx_video_gpupoor_tpu/parallel/ring_rdma.py::_ring_kernel (:43, reached
// through ring_attention_rdma, :122 -> pl.pallas_call :147): non-causal
// attention over a sequence cut into p shards. Rank r holds [B, H, S/p, D]
// of q, k and v; the kv shards travel round the ring, one hop a step, and
// after p steps every rank's q rows have met every kv row. fp32 online
// softmax across the steps, the output divided by max(l, 1e-20).
//
// What the TPU kernel has and what stands in its place here:
//
// - A TPU chip is one core with its whole shard in VMEM. Here a rank is a
//   set of persistent thread blocks (grid = blocks per rank x p; the rank is
//   blockIdx.y). The two kv slots of a rank and its softmax state (m, l,
//   acc) live in DEVICE memory: a peer can write into a rank's device
//   memory, never into its shared memory, and a rank's blocks walk over
//   more (head, q tile) items than they could keep in registers from one
//   ring step to the next. An item belongs to one block for the whole call
//   (item i to block i % nblk), so its state is private to that block and
//   is stored thread by thread, in no layout a reader would expect.
// - make_async_remote_copy + DMA semaphores become 16-byte stores through
//   the right neighbour's slot pointer, then __threadfence_system() and a
//   counter raised with release semantics at system scope; the receiver
//   reads it with acquire. Every block of the sender copies a share of the
//   shard, and does so BEFORE its math of the step (:78-91), so the stores
//   drain while the tensor cores work. Step 0 reads the rank's own k and v
//   in place (the TPU kernel first copies them into slot 0).
// - The neighbour barrier of :71-77 guards a slot that is about to be
//   overwritten. Here the sender waits until EVERY block of the right
//   neighbour has finished the step that read that slot (`done`, counted
//   over blocks, not ranks), and a reader waits until every block of the
//   left neighbour has delivered its share (`arrived`). Only the direction
//   that carries a hazard is waited for.
// - The counters are never reset: a call adds nblk to each, and the call
//   with epoch e waits for e * nblk, compared in wrap-around arithmetic, so
//   a second launch on the same workspace cannot take the first one's
//   signals for its own.
// - Ranks wait on each other, so all blocks must be resident at once: one
//   cudaLaunchCooperativeKernel, its grid sized from the occupancy query.
//   Every spin is bounded: a protocol fault traps instead of hanging.
// - The kernel takes each rank's buffers as base pointers. On a host with
//   several cards the same kernel would be launched once a device with
//   peer-mapped pointers; that launch is not written here.
//
// Two bodies do the tile math under the one protocol. The tensor-core body
// (bf16, D 64 or 128, shards that the 64-row tile divides) is K1's: a block
// of 4 warps owns 64 q rows, kv tiles of 64 rows go through shared memory,
// mma.sync m16n8k16 with fp32 accumulation, the softmax in the exp2 domain.
// The CUDA-core body (fp32 or bf16 in, every product in fp32, one thread a
// q row, the step's max taken before its exponentials, as on the TPU)
// takes every other shape; it only ever sees test-sized ones.
//
// What bounds it on an H100: the math, as K1 (6.6e12 FLOP at the Wan-1.3B
// width against 3 * 2 * 25 MB of copies a rank at p = 4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAXP = 16;
constexpr int NTHREADS = 128;
constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int MAXD_SIMPLE = 128;
constexpr float NEG_INF = -1e30f;
constexpr float L_FLOOR = 1e-20f;
// about ten seconds at the card's clock: far beyond any honest wait
constexpr long long SPIN_LIMIT = 20000000000LL;

struct RingArgs {
  const void* q[MAXP];
  const void* k[MAXP];
  const void* v[MAXP];
  void* o[MAXP];
  void* kslot[MAXP];    // [2][B*H, Sl, D], the input's type
  void* vslot[MAXP];
  float* state[MAXP];   // m, l, acc of the rank's items
  unsigned* arrived;    // [p][p]: shares of the kv block of step s delivered
  unsigned* done;       // [p][p]: blocks that finished step s
  int p, H, BH, Sl, D;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  unsigned target;      // this call's epoch times the blocks per rank
  float scale;          // D**-0.5 (tensor-core body: times log2 e)
  int fault_rank, fault_step;  // a planted fault: that rank skips that step
};

// ---------------------------------------------------------------- protocol

__device__ __forceinline__ void signal(unsigned* flag) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.sys.global.add.u32 [%0], 1;" ::"l"(flag)
                 : "memory");
  }
}

__device__ __forceinline__ void wait_for(const unsigned* flag,
                                         unsigned target) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    for (;;) {
      unsigned val;
      asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
                   : "=r"(val)
                   : "l"(flag)
                   : "memory");
      if (static_cast<int>(val - target) >= 0) break;
      if (clock64() - t0 > SPIN_LIMIT) __trap();
      __nanosleep(100);
    }
  }
  __syncthreads();
}

// where a kv block lies: a rank's own input (strided) or a slot (packed)
struct Block {
  const char* base;
  long long sb, sh, ss;  // strides in elements
};

__device__ __forceinline__ long long row_offset(const Block& blk, int H,
                                                int bh, int s) {
  return (bh / H) * blk.sb + (bh % H) * blk.sh + s * blk.ss;
}

// this block's share of a [BH, Sl, D] block into a packed slot, 16 bytes a
// thread; read past L1 (the source may be a slot a peer has just written)
__device__ void copy_share(const Block& src, char* dst, int H, int BH, int Sl,
                           int row_bytes, int esize) {
  const int cpr = row_bytes / 16;
  const long long total = static_cast<long long>(BH) * Sl * cpr;
  for (long long i = blockIdx.x * static_cast<long long>(NTHREADS) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * NTHREADS) {
    const long long row = i / cpr;
    const int ch = static_cast<int>(i % cpr);
    const int bh = static_cast<int>(row / Sl), s = static_cast<int>(row % Sl);
    const uint4 val = __ldcg(reinterpret_cast<const uint4*>(
        src.base + row_offset(src, H, bh, s) * esize + ch * 16));
    *reinterpret_cast<uint4*>(dst + row * row_bytes + ch * 16) = val;
  }
}

// ------------------------------------------------- the tensor-core body

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_h(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// 64 rows from row0 of head-slice `bh` of a block into a padded shared tile
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const Block& blk, int H,
                                          int bh, int row0) {
  constexpr int LD = D + 8;
  constexpr int CPR = D / 8;
  const bf16* src = reinterpret_cast<const bf16*>(blk.base) +
                    row_offset(blk, H, bh, 0);
  for (int i = threadIdx.x; i < BKV * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR;
    const uint4 val = __ldcg(reinterpret_cast<const uint4*>(
        src + (row0 + r) * blk.ss + c * 8));
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// One (head, q tile) item against one kv block: K1's loop over 64-row kv
// tiles, with the running state loaded from and stored to the item's
// private rows of `state` (m0, m1, l0, l1, acc[...] per thread).
template <int D>
__device__ void tc_item(const RingArgs& a, int rank, int item,
                        const Block& kblk, const Block& vblk, bool first,
                        bool last, bf16* Ks, bf16* Vs) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int NS = BKV / 8;
  constexpr int NSTATE = 4 + ND * 4;
  const int tiles = a.Sl / BQ;
  const int bh = item / tiles, q0 = (item % tiles) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  const Block qblk{static_cast<const char*>(a.q[rank]), a.qsb, a.qsh, a.qss};
  __syncthreads();  // the previous item is done with the tiles
  load_tile<D>(Ks, qblk, a.H, bh, q0);
  __syncthreads();
  uint32_t qf[KD][4];
  {
    const bf16* r0p = Ks + (warp * 16 + g) * LD + t * 2;
    const bf16* r1p = r0p + 8 * LD;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][0] = ld32(r0p + kk * 16);
      qf[kk][1] = ld32(r1p + kk * 16);
      qf[kk][2] = ld32(r0p + kk * 16 + 8);
      qf[kk][3] = ld32(r1p + kk * 16 + 8);
    }
  }

  float* st = a.state[rank] +
              static_cast<long long>(item) * NSTATE * NTHREADS + threadIdx.x;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[ND][4];
  if (first) {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }
  } else {
    m0 = st[0 * NTHREADS];
    m1 = st[1 * NTHREADS];
    l0 = st[2 * NTHREADS];
    l1 = st[3 * NTHREADS];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = st[(4 + n * 4 + e) * NTHREADS];
    }
  }

  for (int kv0 = 0; kv0 < a.Sl; kv0 += BKV) {
    __syncthreads();
    load_tile<D>(Ks, kblk, a.H, bh, kv0);
    load_tile<D>(Vs, vblk, a.H, bh, kv0);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const bf16* kp = Ks + (j * 8 + g) * LD + kk * 16 + t * 2;
        mma16816(s[j], qf[kk], ld32(kp), ld32(kp + 8));
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= a.scale;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      ls0 += s[j][0] + s[j][1];
      ls1 += s[j][2] + s[j][3];
    }
    l0 = l0 * a0 + ls0;  // per-thread partial sums; reduced at the end
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vp = Vs + (kk * 16 + t * 2) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* vn = vp + n * 8;
        const uint32_t b0 = pack_h(vn[0], vn[LD]);
        const uint32_t b1 = pack_h(vn[8 * LD], vn[9 * LD]);
        mma16816(acc[n], pa, b0, b1);
      }
    }
  }

  if (!last) {
    st[0 * NTHREADS] = m0;
    st[1 * NTHREADS] = m1;
    st[2 * NTHREADS] = l0;
    st[3 * NTHREADS] = l1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[(4 + n * 4 + e) * NTHREADS] = acc[n][e];
    }
    return;
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, L_FLOOR), d1 = fmaxf(l1, L_FLOOR);
  bf16* ob = static_cast<bf16*>(a.o[rank]) + (bh / a.H) * a.osb +
             (bh % a.H) * a.osh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(ob + row0 * a.oss + c) =
        pack_f(acc[n][0] / d0, acc[n][1] / d0);
    *reinterpret_cast<uint32_t*>(ob + row1 * a.oss + c) =
        pack_f(acc[n][2] / d1, acc[n][3] / d1);
  }
}

// --------------------------------------------------- the CUDA-core body

template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f<float>(const float* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ float load_f<bf16>(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One item = up to 128 q rows of the rank (row = bh * Sl + s), a thread a
// row, against one kv block, every product in fp32: the step's max first,
// then its exponentials, as in the TPU kernel (:97-111). State: m, l, acc
// of the row at state[row * (2 + D)].
template <typename T>
__device__ void simple_item(const RingArgs& a, int rank, int item,
                            const Block& kblk, const Block& vblk, bool first,
                            bool last) {
  const int row = item * NTHREADS + threadIdx.x;
  if (row >= a.BH * a.Sl) return;
  const int bh = row / a.Sl, s = row % a.Sl;
  const int D = a.D;
  const Block qblk{static_cast<const char*>(a.q[rank]), a.qsb, a.qsh, a.qss};
  const T* qp = reinterpret_cast<const T*>(qblk.base) +
                row_offset(qblk, a.H, bh, s);
  const T* kp = reinterpret_cast<const T*>(kblk.base) +
                row_offset(kblk, a.H, bh, 0);
  const T* vp = reinterpret_cast<const T*>(vblk.base) +
                row_offset(vblk, a.H, bh, 0);
  float qv[MAXD_SIMPLE], acc[MAXD_SIMPLE];
  float* st = a.state[rank] + static_cast<long long>(row) * (2 + D);
  float m_prev = NEG_INF, l = 0.f;
  for (int d = 0; d < D; ++d) {
    qv[d] = load_f(qp + d);
    acc[d] = first ? 0.f : st[2 + d];
  }
  if (!first) {
    m_prev = st[0];
    l = st[1];
  }
  float m_cur = NEG_INF;
  for (int j = 0; j < a.Sl; ++j) {
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot += qv[d] * load_f(kp + j * kblk.ss + d);
    m_cur = fmaxf(m_cur, dot * a.scale);
  }
  const float m_new = fmaxf(m_prev, m_cur);
  const float alpha = expf(m_prev - m_new);
  for (int d = 0; d < D; ++d) acc[d] *= alpha;
  float lsum = 0.f;
  for (int j = 0; j < a.Sl; ++j) {
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot += qv[d] * load_f(kp + j * kblk.ss + d);
    const float pj = expf(dot * a.scale - m_new);
    lsum += pj;
    for (int d = 0; d < D; ++d) acc[d] += pj * load_f(vp + j * vblk.ss + d);
  }
  l = l * alpha + lsum;
  if (!last) {
    st[0] = m_new;
    st[1] = l;
    for (int d = 0; d < D; ++d) st[2 + d] = acc[d];
    return;
  }
  const float den = fmaxf(l, L_FLOOR);
  T* op = static_cast<T*>(a.o[rank]) + (bh / a.H) * a.osb +
          (bh % a.H) * a.osh + s * a.oss;
  for (int d = 0; d < D; ++d) store_f(op + d, acc[d] / den);
}

// ---------------------------------------------------------------- the ring

// BODY 0: tensor cores, bf16, D = DT; BODY 1: CUDA cores, T in
template <int BODY, int DT, typename T>
__global__ void __launch_bounds__(NTHREADS)
ring_kernel(const RingArgs a, int items) {
  constexpr int LDS = BODY == 0 ? BKV * (DT + 8) : 8;
  __shared__ __align__(16) bf16 Ks[LDS];
  __shared__ __align__(16) bf16 Vs[LDS];
  const int rank = blockIdx.y;
  const int p = a.p;
  const int right = (rank + 1) % p;
  const int esize = sizeof(T);
  const int row_bytes = a.D * esize;
  const long long slot_bytes =
      static_cast<long long>(a.BH) * a.Sl * row_bytes;

  for (int step = 0; step < p; ++step) {
    Block kblk, vblk;
    if (step == 0) {
      kblk = Block{static_cast<const char*>(a.k[rank]), a.ksb, a.ksh, a.kss};
      vblk = Block{static_cast<const char*>(a.v[rank]), a.vsb, a.vsh, a.vss};
    } else {
      const long long off = (step % 2) * slot_bytes;
      const long long sh = static_cast<long long>(a.Sl) * a.D;
      // a slot is [B*H, Sl, D] packed: batch stride H * Sl * D
      kblk = Block{static_cast<const char*>(a.kslot[rank]) + off, a.H * sh,
                   sh, a.D};
      vblk = Block{static_cast<const char*>(a.vslot[rank]) + off, a.H * sh,
                   sh, a.D};
    }
    if (step + 1 < p) {
      const int nxt = (step + 1) % 2;
      if (step >= 2) {
        // the right neighbour read slot `nxt` at step - 1: every one of its
        // blocks must be past that step before the slot is overwritten
        wait_for(a.done + right * p + (step - 1), a.target);
      }
      copy_share(kblk, static_cast<char*>(a.kslot[right]) + nxt * slot_bytes,
                 a.H, a.BH, a.Sl, row_bytes, esize);
      copy_share(vblk, static_cast<char*>(a.vslot[right]) + nxt * slot_bytes,
                 a.H, a.BH, a.Sl, row_bytes, esize);
      signal(a.arrived + right * p + (step + 1));
    }

    // the math of this step, while the block for the next one is in flight
    if (!(rank == a.fault_rank && step == a.fault_step)) {
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        if constexpr (BODY == 0) {
          tc_item<DT>(a, rank, item, kblk, vblk, step == 0, step == p - 1, Ks,
                      Vs);
        } else {
          simple_item<T>(a, rank, item, kblk, vblk, step == 0, step == p - 1);
        }
      }
    }

    if (step + 1 < p) {
      signal(a.done + rank * p + step);
      wait_for(a.arrived + rank * p + (step + 1), a.target);
    }
  }
}

template <int BODY, int DT, typename T>
int blocks_for(int p, int items) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ring_kernel<BODY, DT, T>, NTHREADS, 0) != cudaSuccess) {
    return -1;
  }
  const int cap = per_sm * sms / p;
  return items < cap ? items : cap;
}

template <int BODY, int DT, typename T>
int launch_ring(const RingArgs& a, int items, int nblk, cudaStream_t st) {
  RingArgs args = a;
  void* params[] = {&args, &items};
  const dim3 grid(nblk, a.p);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ring_kernel<BODY, DT, T>), grid,
      dim3(NTHREADS), params, 0, st);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// body: 0 tensor cores (bf16, D 64 / 128), 1 CUDA cores fp32 in, 2 CUDA
// cores bf16 in
#define K7_DISPATCH(FN, ...)                                        \
  (body == 0 && D == 64    ? FN<0, 64, bf16>(__VA_ARGS__)           \
   : body == 0 && D == 128 ? FN<0, 128, bf16>(__VA_ARGS__)          \
   : body == 1             ? FN<1, 0, float>(__VA_ARGS__)           \
   : body == 2             ? FN<1, 0, bf16>(__VA_ARGS__)            \
                           : -1)

int item_count(int body, int BH, int Sl) {
  if (body == 0) return BH * (Sl / BQ);
  return (BH * Sl + NTHREADS - 1) / NTHREADS;
}

}  // namespace

// blocks per rank that one cooperative launch of the whole ring can hold
// (at most one per item); -1 if the device cannot launch it
extern "C" int k7_ring_blocks(int body, int p, int BH, int Sl, int D) {
  if (p < 1 || p > MAXP || body < 0 || body > 2) return -1;
  if (body == 0 && (Sl % BQ || (D != 64 && D != 128))) return -1;
  if (body != 0 && D > MAXD_SIMPLE) return -1;
  const int items = item_count(body, BH, Sl);
  const int n = K7_DISPATCH(blocks_for, p, items);
  return n < 1 ? -1 : n;
}

// floats of state a rank needs
extern "C" long long k7_ring_state_floats(int body, int BH, int Sl, int D) {
  if (body == 0) {
    return static_cast<long long>(item_count(body, BH, Sl)) *
           (4 + D / 8 * 4) * NTHREADS;
  }
  return static_cast<long long>(BH) * Sl * (2 + D);
}

// q, k, v, o, kslot, vslot, state: host arrays of p device pointers (rank
// r's [B, H, Sl, D] shards with the common strides below, its two packed
// kv slots, its state); arrived, done: [p, p] counters, never reset;
// target = epoch * nblk; fault_rank / fault_step: -1, or a rank that skips
// the math of a step (a planted fault for the check of the checks)
extern "C" int k7_ring_attention(
    const void* const* q, const void* const* k, const void* const* v,
    void* const* o, void* const* kslot, void* const* vslot,
    void* const* state, void* arrived, void* done,
    int body, int p, int B, int H, int Sl, int D,
    int qsb, int qsh, int qss, int ksb, int ksh, int kss,
    int vsb, int vsh, int vss, int osb, int osh, int oss,
    int nblk, unsigned target, float scale, int fault_rank, int fault_step,
    void* stream) {
  if (k7_ring_blocks(body, p, B * H, Sl, D) < nblk || nblk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingArgs a;
  for (int r = 0; r < p; ++r) {
    a.q[r] = q[r];
    a.k[r] = k[r];
    a.v[r] = v[r];
    a.o[r] = o[r];
    a.kslot[r] = kslot ? kslot[r] : nullptr;
    a.vslot[r] = vslot ? vslot[r] : nullptr;
    a.state[r] = state ? static_cast<float*>(state[r]) : nullptr;
  }
  a.arrived = static_cast<unsigned*>(arrived);
  a.done = static_cast<unsigned*>(done);
  a.p = p;
  a.H = H;
  a.BH = B * H;
  a.Sl = Sl;
  a.D = D;
  a.qsb = qsb; a.qsh = qsh; a.qss = qss;
  a.ksb = ksb; a.ksh = ksh; a.kss = kss;
  a.vsb = vsb; a.vsh = vsh; a.vss = vss;
  a.osb = osb; a.osh = osh; a.oss = oss;
  a.target = target;
  a.scale = scale;
  a.fault_rank = fault_rank;
  a.fault_step = fault_step;
  const int items = item_count(body, B * H, Sl);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return K7_DISPATCH(launch_ring, a, items, nblk, st);
}
