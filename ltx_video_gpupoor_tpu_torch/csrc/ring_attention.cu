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
//   is stored thread by thread, in no layout a reader would expect. The
//   first step does not load it and the last does not store it: at p = 1 it
//   never leaves registers.
// - make_async_remote_copy + DMA semaphores become 16-byte stores through
//   the right neighbour's slot pointer, then __threadfence_system() and a
//   counter raised with release semantics at system scope; the receiver
//   reads it with acquire. Every block of the sender copies a share of the
//   shard, and does so BEFORE its math of the step (:78-91), so the stores
//   drain while the tensor cores work. Step 0 reads the rank's own k and v
//   in place (the TPU kernel first copies them into slot 0).
// - The tensor-core body reads a slot with TMA, the async proxy, while the
//   peer wrote it with generic stores: a proxy fence (fence.proxy.async)
//   follows the acquire before thread 0 issues a TMA load of it, and
//   precedes the release of `done`, which lets the peer overwrite a slot
//   this rank's TMA loads have read.
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
//   Every spin is bounded in time (%globaltimer): in the one-launch ring a
//   protocol fault traps instead of hanging. The ring waits only between
//   items, where no wgmma group or TMA load is in flight.
//
// Two launches of the one protocol (the same device code, ring_body):
// - The whole ring in one launch on one card (ring_kernel, entry
//   k7_ring_attention): grid = blocks per rank x p, the rank is blockIdx.y,
//   every rank's buffers are base pointers on that card.
// - Once per card (ring_card_kernel, entry k7_ring_attention_card), as the
//   TPU kernel runs once per chip: grid = blocks per rank (the whole card),
//   the rank is an argument, and the right neighbour's two k and two v slots
//   and its counters arrive as peer pointers (cudaIpcOpenMemHandle of its
//   workspace, one cudaMalloc'd allocation: a header of counters, then the
//   slots). Every counter lies in the memory of the rank that spins on it:
//   `arrived` (raised by the left neighbour's blocks after their stores) in
//   the receiver's, `done` (raised by the right neighbour's blocks after
//   the step that read a slot) in the sender's, so every spin reads local
//   memory and every cross-card access is a store or a remote atomic. The
//   tensor maps cover this rank's own inputs and slots, all local. Three
//   things the one launch never meets: (1) a rank's next call may start
//   while its right neighbour still reads a slot of this one, so the first
//   step waits until every block of the right neighbour has finished the
//   last call (`done` of the last step, raised only here); (2) the ranks
//   launch from separate processes, tens of milliseconds apart, and one may
//   never launch: a spin gives up after the caller's bound, writes a status
//   code into its own header and its neighbours' (which makes their spins
//   give up at once), and the blocks return; the wrapper reads the status
//   after the launch and raises; (3) a rank that skipped a call would take
//   its neighbour's later signals for its own: the sender leaves its call
//   epoch in the receiver's header with its first share, and the receiver
//   compares it with its own.
//
// Two bodies do the tile math under the one protocol.
// - The tensor-core body (bf16, D 64 or 128, shards of a multiple of 64
//   rows) is K1's block (attention_block.cuh): an item is 128 q rows of one
//   (batch, head) in two consumer warpgroups, Q and the kv tiles of 128 rows
//   come by TMA into the mbarrier ring, both products run on wgmma with P
//   from registers, the softmax is in the exp2 domain (the scale arrives
//   times log2 e). The block keeps its ring's position across items and
//   steps. Shards that 128 does not divide take K1's tail instance: TMA
//   zero-fills the rows past S/p, the last kv tile masks them, and q rows
//   past S/p are not stored. Tensor maps (q, k, v of each rank, and its two
//   k and two v slots) live in a device buffer: the slots' maps are written
//   once a workspace, the inputs' at every call.
// - The CUDA-core body (fp32 or bf16 in, every product in fp32, one thread a
//   q row, the step's max taken before its exponentials, as on the TPU)
//   takes every other shape; it only ever sees test-sized ones.
//
// What bounds it on an H100: the math, as K1 (6.6e12 FLOP at the Wan-1.3B
// width against 3 * 2 * 25 MB of copies a rank at p = 4, and about 1.2 GB of
// softmax state written and read back in all at p = 4). Once per card at
// p = 4 a card does a quarter of the math, and sends 3 kv blocks of 50 MB
// over NVLink (450 GB/s each way: about 0.11 ms a step against a step's
// 0.42 ms of math at the bound), issued before the step's math.

#include <cstring>

#include "attention_block.cuh"

namespace {

constexpr int MAXP = 16;
constexpr int NTHREADS = 128;     // the CUDA-core body's block
constexpr int TC_THREADS = 256;   // the tensor-core body's: K1's two consumers
constexpr int TC_ROWS = 64;       // S/p the tensor-core body takes: multiples
constexpr int MAXD_SIMPLE = 128;
constexpr float L_FLOOR = 1e-20f;
// the one-launch ring's bound on a spin, in ns: far beyond any honest wait
constexpr unsigned long long SPIN_NS = 10000000000ULL;

// The per-card workspace: a header of counters (unsigned words), then the
// two k slots and the two v slots, each rounded up to 256 bytes.
constexpr int HDR_ARRIVED = 0;          // [MAXP]: shares of step s delivered
constexpr int HDR_DONE = MAXP;          // [MAXP]: right's blocks past step s
constexpr int HDR_EPOCH = 2 * MAXP;     // the left neighbour's call epoch
constexpr int HDR_STATUS = 2 * MAXP + 1;  // 0, or why a launch gave up
constexpr int HDR_BYTES = 256;
// status codes (ring_rdma.py's K7_STATUS names them)
constexpr int ST_TIMEOUT = 1;   // a spin outlasted the caller's bound
constexpr int ST_PEER = 2;      // a neighbour gave up
constexpr int ST_EPOCH = 3;     // the left neighbour is at another call

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
  unsigned long long spin_ns;  // a spin's bound
  // once per card: this rank's place on the ring (its buffers at index 0),
  // its header, the neighbours' (peer-mapped), the right one's slots
  int rank;
  unsigned epoch;
  unsigned* hdr;
  unsigned* hdr_right;
  unsigned* hdr_left;
  void* kslot_right;
  void* vslot_right;
};

// ---------------------------------------------------------------- protocol

// generic-proxy accesses to global memory ordered with async-proxy (TMA)
// ones
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void signal(unsigned* flag) {
  proxy_fence();
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.sys.global.add.u32 [%0], 1;" ::"l"(flag)
                 : "memory");
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned val;
  asm volatile("ld.relaxed.sys.global.u32 %0, [%1];"
               : "=r"(val)
               : "l"(p)
               : "memory");
  return val;
}

// once per card: record why this rank gives up, in its own header and its
// neighbours' (whose spins then give up at once)
__device__ __forceinline__ void give_up(const RingArgs& a, int code) {
  atomicCAS_system(reinterpret_cast<int*>(a.hdr + HDR_STATUS), 0, code);
  atomicCAS_system(reinterpret_cast<int*>(a.hdr_right + HDR_STATUS), 0,
                   ST_PEER);
  atomicCAS_system(reinterpret_cast<int*>(a.hdr_left + HDR_STATUS), 0,
                   ST_PEER);
}

// Thread 0 spins until *flag reaches target (wrap-around compare), then
// the block goes on. Bounded by a.spin_ns: the one-launch ring traps; once
// per card (CARD) the rank gives up, or stops at once where its status
// says that a neighbour did, and every thread returns false.
template <bool CARD>
__device__ __forceinline__ bool wait_for(const RingArgs& a,
                                         const unsigned* flag,
                                         unsigned target) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    const unsigned long long t0 = global_ns();
    int good = 1;
    for (;;) {
      unsigned val;
      asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
                   : "=r"(val)
                   : "l"(flag)
                   : "memory");
      if (static_cast<int>(val - target) >= 0) break;
      if (CARD && load_relaxed(a.hdr + HDR_STATUS) != 0) {
        good = 0;
        break;
      }
      if (global_ns() - t0 > a.spin_ns) {
        if constexpr (CARD) {
          give_up(a, ST_TIMEOUT);
          good = 0;
          break;
        } else {
          __trap();
        }
      }
      __nanosleep(100);
    }
    if (good) proxy_fence();  // thread 0 issues the TMA loads of what arrived
    ok = good;
  }
  __syncthreads();
  const bool went = ok;
  __syncthreads();  // read by all before the next wait writes it
  return went;
}

// once per card, after the first share arrived: the left neighbour left its
// call epoch with it, which must be this call's
__device__ __forceinline__ bool epoch_agrees(const RingArgs& a) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    ok = load_relaxed(a.hdr + HDR_EPOCH) == a.epoch;
    if (!ok) give_up(a, ST_EPOCH);
  }
  __syncthreads();
  const bool same = ok;
  __syncthreads();
  return same;
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

// This block's share of a [BH, Sl, D] block into a packed slot, 16 bytes a
// thread, COPY_LOADS loads in flight before their stores: every block copies
// before its math, so the card does nothing else meanwhile, and with one
// load in flight a thread the seven copies of p = 8 cost 1.0 ms more at the
// Wan width. Read past L1 (the source may be a slot a peer has just
// written). Chunks are counted in 32 bits: the host keeps a shard under
// 2**31 of them.
constexpr int COPY_LOADS = 8;

__device__ void copy_share(const Block& src, char* dst, int H, int BH, int Sl,
                           int row_bytes, int esize) {
  const unsigned cpr = row_bytes / 16;
  const unsigned total = static_cast<unsigned>(BH) * Sl * cpr;
  const unsigned stride = gridDim.x * blockDim.x;
  auto from = [&](unsigned i) {
    const unsigned row = i / cpr, ch = i % cpr;
    const int bh = row / Sl, s = row % Sl;
    return reinterpret_cast<const uint4*>(
        src.base + row_offset(src, H, bh, s) * esize + ch * 16);
  };
  auto to = [&](unsigned i) {
    return reinterpret_cast<uint4*>(dst + static_cast<size_t>(i) * 16);
  };
  unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + (COPY_LOADS - 1) * stride < total; i += COPY_LOADS * stride) {
    uint4 val[COPY_LOADS];
#pragma unroll
    for (int u = 0; u < COPY_LOADS; ++u) val[u] = __ldcg(from(i + u * stride));
#pragma unroll
    for (int u = 0; u < COPY_LOADS; ++u) *to(i + u * stride) = val[u];
  }
  for (; i < total; i += stride) *to(i) = __ldcg(from(i));
}

// ------------------------------------------------- the tensor-core body

// Tensor maps a rank reads, in the buffer `maps`: q, k, v of rank r at
// 3 r .. 3 r + 2; its k slots 0, 1 and v slots 0, 1 at 3 p + 4 r .. + 3
// (once per card the buffer holds one rank's: r = 0, p = 1).
__device__ __forceinline__ const CUtensorMap* kv_map(const CUtensorMap* maps,
                                                     int p, int rank,
                                                     int step, int v) {
  if (step == 0) return maps + 3 * rank + 1 + v;
  return maps + 3 * p + 4 * rank + 2 * v + step % 2;
}

// the buffer's maps were written by a copy before the launch: the tensor
// map proxy must not use what it may hold of an earlier call's
__device__ __forceinline__ void map_acquire(const CUtensorMap* map) {
  asm volatile("fence.proxy.tensormap::generic.acquire.gpu [%0], 128;\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The rank's items of one step on K1's block: per item, the state in (or
// the first step's empty one), the kv block of this step folded in, the
// state out (or, at the last step, the output). `it` and `q_phase` are the
// ring's position and Q's barrier phase, carried across items and steps.
// `me` indexes this rank's buffers in `a` and its maps among `mp` ranks'.
template <int D, int MASK>
__device__ void tc_step(const RingArgs& a, const CUtensorMap* maps, int me,
                        int mp, int step, int items, const Ring& rg, int& it,
                        int& q_phase) {
  constexpr int NST = 4 + D / 2;  // state floats a thread: m, l, acc
  const bool first = step == 0, last = step == a.p - 1;
  const int q_tiles = (a.Sl + BQ - 1) / BQ;
  const int n_tiles = (a.Sl + BKV - 1) / BKV;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Rows r;
  r.qs0 = r.qs1 = 0;
  r.kv_seg = nullptr;
  r.Skv = r.kv_lim = a.Sl;
  r.causal = 0;
  // the tail instance's last kv tile holds rows past S/p
  auto needs_mask = [&](int j) {
    return MASK == MASK_TAIL && j == n_tiles - 1;
  };
  Tiles tl;
  tl.qmap = maps + 3 * me;
  tl.kmap = kv_map(maps, mp, me, step, 0);
  tl.vmap = kv_map(maps, mp, me, step, 1);
  tl.n_tiles = n_tiles;
  tl.c = a.scale;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int bh = item / q_tiles;
    tl.q0 = (item % q_tiles) * BQ;
    tl.h = bh % a.H;
    tl.b = bh / a.H;
    tl.it = it;
    tl.q_phase = q_phase;
    r.row0 = tl.q0 + wg * 64 + warp * 16 + g;
    r.row1 = r.row0 + 8;
    float* st = a.state[me] +
                static_cast<long long>(item) * NST * TC_THREADS + threadIdx.x;
    float acc[D / 2];
    float m0 = M_FLOOR, m1 = M_FLOOR, l0 = 0.f, l1 = 0.f;
    if (first) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    } else {
      m0 = st[0];
      m1 = st[TC_THREADS];
      l0 = st[2 * TC_THREADS];
      l1 = st[3 * TC_THREADS];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = st[(4 + i) * TC_THREADS];
    }
    // every warp is done with the last item's Q before thread 0 loads this
    // item's into its place
    __syncthreads();
    attend_tiles<D, MASK, false, true>(rg, tl, r, needs_mask, acc, m0, m1,
                                       l0, l1);
    it += n_tiles;
    q_phase ^= 1;
    if (!last) {
      st[0] = m0;
      st[TC_THREADS] = m1;
      st[2 * TC_THREADS] = l0;
      st[3 * TC_THREADS] = l1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) st[(4 + i) * TC_THREADS] = acc[i];
      continue;
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    bf16* ob = static_cast<bf16*>(a.o[me]) + tl.b * a.osb + tl.h * a.osh;
    store_rows<D>(acc, fmaxf(l0, L_FLOOR), fmaxf(l1, L_FLOOR), ob, a.oss,
                  r.row0, r.row1, a.Sl, t);
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

// The protocol and the math of one rank. BODY 0: tensor cores, bf16,
// D = DT, MASK none or tail; BODY 1: CUDA cores, T in. CARD: launched once
// per card (the rank is a.rank, its buffers at index 0, the neighbours'
// through peer pointers); else the whole ring in one launch.
template <bool CARD, int BODY, int DT, int MASK, typename T>
__device__ __forceinline__ void ring_body(const RingArgs& a,
                                          const CUtensorMap* maps, int items,
                                          uint8_t* smem_raw) {
  const int rank = CARD ? a.rank : static_cast<int>(blockIdx.y);
  const int me = CARD ? 0 : rank;   // this rank's buffers in a, its maps
  const int p = a.p;
  const int mp = CARD ? 1 : p;      // ranks whose maps the buffer holds
  const int right = (rank + 1) % p;
  const int esize = sizeof(T);
  const int row_bytes = a.D * esize;
  const long long slot_bytes =
      static_cast<long long>(a.BH) * a.Sl * row_bytes;
  // the slots this rank sends into, and the counters of step s: raised
  // there, and waited for here (once per card all in the header of the
  // rank that waits; in one launch [p][p] arrays, a row a rank); formed
  // where they are used
  auto kdst = [&] {
    return static_cast<char*>(CARD ? a.kslot_right : a.kslot[right]);
  };
  auto vdst = [&] {
    return static_cast<char*>(CARD ? a.vslot_right : a.vslot[right]);
  };
  auto arrive_at = [&](int s) {
    return (CARD ? a.hdr_right + HDR_ARRIVED : a.arrived + right * p) + s;
  };
  auto arrived_here = [&](int s) {
    return (CARD ? a.hdr + HDR_ARRIVED : a.arrived + rank * p) + s;
  };
  auto done_at = [&](int s) {
    return (CARD ? a.hdr_left + HDR_DONE : a.done + rank * p) + s;
  };
  auto done_here = [&](int s) {
    return (CARD ? a.hdr + HDR_DONE : a.done + right * p) + s;
  };
  Ring rg;
  int it = 0, q_phase = 0;
  if constexpr (BODY == 0) {
    rg = ring_layout<DT>(smem_raw);
    if (threadIdx.x == 0) {
      ring_init<DT>(rg);
      for (int step = 0; step < p && step < 3; ++step) {
        if (step == 0) map_acquire(maps + 3 * me);
        map_acquire(kv_map(maps, mp, me, step, 0));
        map_acquire(kv_map(maps, mp, me, step, 1));
      }
    }
    __syncthreads();
  }
  if (CARD && p > 1) {
    // every block of the right neighbour is past its last call, whose last
    // steps read the slots that this call's first two steps overwrite
    if (!wait_for<CARD>(a, done_here(p - 1), a.target - gridDim.x)) {
      return;
    }
  }

  for (int step = 0; step < p; ++step) {
    Block kblk, vblk;
    if (step == 0) {
      kblk = Block{static_cast<const char*>(a.k[me]), a.ksb, a.ksh, a.kss};
      vblk = Block{static_cast<const char*>(a.v[me]), a.vsb, a.vsh, a.vss};
    } else {
      const long long off = (step % 2) * slot_bytes;
      const long long sh = static_cast<long long>(a.Sl) * a.D;
      // a slot is [B*H, Sl, D] packed: batch stride H * Sl * D
      kblk = Block{static_cast<const char*>(a.kslot[me]) + off, a.H * sh,
                   sh, a.D};
      vblk = Block{static_cast<const char*>(a.vslot[me]) + off, a.H * sh,
                   sh, a.D};
    }
    if (step + 1 < p) {
      const int nxt = (step + 1) % 2;
      if (step >= 2) {
        // the right neighbour read slot `nxt` at step - 1: every one of its
        // blocks must be past that step before the slot is overwritten
        if (!wait_for<CARD>(a, done_here(step - 1), a.target)) return;
      }
      copy_share(kblk, kdst() + nxt * slot_bytes, a.H, a.BH, a.Sl,
                 row_bytes, esize);
      copy_share(vblk, vdst() + nxt * slot_bytes, a.H, a.BH, a.Sl,
                 row_bytes, esize);
      if (CARD && step == 0 && blockIdx.x == 0 && threadIdx.x == 0) {
        // released with this block's first share below
        asm volatile("st.relaxed.sys.global.u32 [%0], %1;" ::"l"(
                         a.hdr_right + HDR_EPOCH),
                     "r"(a.epoch)
                     : "memory");
      }
      signal(arrive_at(step + 1));
    }

    // the math of this step, while the block for the next one is in flight
    if (!(rank == a.fault_rank && step == a.fault_step)) {
      if constexpr (BODY == 0) {
        tc_step<DT, MASK>(a, maps, me, mp, step, items, rg, it, q_phase);
      } else {
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
          simple_item<T>(a, me, item, kblk, vblk, step == 0, step == p - 1);
        }
      }
    }

    // once per card the last step is signalled too (see the first wait)
    if (step + 1 < p || (CARD && p > 1)) signal(done_at(step));
    if (step + 1 < p) {
      if (!wait_for<CARD>(a, arrived_here(step + 1), a.target)) return;
      if (CARD && step == 0 && !epoch_agrees(a)) return;
    }
  }
}

template <int BODY, int DT, int MASK, typename T>
__global__ void __launch_bounds__(BODY == 0 ? TC_THREADS : NTHREADS, 1)
ring_kernel(const RingArgs a, const CUtensorMap* __restrict__ maps,
            int items) {
  extern __shared__ uint8_t smem_raw[];  // the tensor-core body's block
  ring_body<false, BODY, DT, MASK, T>(a, maps, items, smem_raw);
}

template <int BODY, int DT, int MASK, typename T>
__global__ void __launch_bounds__(BODY == 0 ? TC_THREADS : NTHREADS, 1)
ring_card_kernel(const RingArgs a, const CUtensorMap* __restrict__ maps,
                 int items) {
  extern __shared__ uint8_t smem_raw[];
  ring_body<true, BODY, DT, MASK, T>(a, maps, items, smem_raw);
}

template <bool CARD, int BODY, int DT, int MASK, typename T>
constexpr auto kernel_of() {
  if constexpr (CARD) {
    return ring_card_kernel<BODY, DT, MASK, T>;
  } else {
    return ring_kernel<BODY, DT, MASK, T>;
  }
}

// dynamic shared memory of an instance, set as its attribute (above 48 KB a
// kernel must ask for it); -1 on failure
template <bool CARD, int BODY, int DT, int MASK, typename T>
int prepare() {
  if constexpr (BODY == 0) {
    if (cudaFuncSetAttribute(kernel_of<CARD, BODY, DT, MASK, T>(),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<DT>::SMEM_BYTES) != cudaSuccess) {
      return -1;
    }
    return Cfg<DT>::SMEM_BYTES;
  }
  return 0;
}

// blocks a rank: the card's share of one rank (all of it once per card)
template <bool CARD, int BODY, int DT, int MASK, typename T>
int blocks_for(int p, int items) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  const int smem = prepare<CARD, BODY, DT, MASK, T>();
  if (smem < 0 || cudaGetDevice(&dev) != cudaSuccess) return -1;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel_of<CARD, BODY, DT, MASK, T>(),
          BODY == 0 ? TC_THREADS : NTHREADS, smem) != cudaSuccess) {
    return -1;
  }
  const int cap = per_sm * sms / (CARD ? 1 : p);
  return items < cap ? items : cap;
}

template <bool CARD, int BODY, int DT, int MASK, typename T>
int launch_ring(const RingArgs& a, const void* maps, int items, int nblk,
                cudaStream_t st) {
  const int smem = prepare<CARD, BODY, DT, MASK, T>();
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  RingArgs args = a;
  const CUtensorMap* map_arg = static_cast<const CUtensorMap*>(maps);
  void* params[] = {&args, &map_arg, &items};
  const dim3 grid(nblk, CARD ? 1 : a.p);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel_of<CARD, BODY, DT, MASK, T>()), grid,
      dim3(BODY == 0 ? TC_THREADS : NTHREADS), params, smem, st);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// body: 0 tensor cores (bf16, D 64 / 128; `tail`: S/p not a multiple of
// the 128-row tile), 1 CUDA cores fp32 in, 2 CUDA cores bf16 in
// (CARD: the launch once per card, else the whole ring in one)
#define K7_DISPATCH(FN, CARD, ...)                                      \
  (body == 0 && D == 64 && !tail                                        \
       ? FN<CARD, 0, 64, MASK_NONE, bf16>(__VA_ARGS__)                  \
   : body == 0 && D == 64 ? FN<CARD, 0, 64, MASK_TAIL, bf16>(__VA_ARGS__) \
   : body == 0 && D == 128 && !tail                                     \
       ? FN<CARD, 0, 128, MASK_NONE, bf16>(__VA_ARGS__)                 \
   : body == 0 && D == 128                                              \
       ? FN<CARD, 0, 128, MASK_TAIL, bf16>(__VA_ARGS__)                 \
   : body == 1 ? FN<CARD, 1, 0, MASK_NONE, float>(__VA_ARGS__)          \
   : body == 2 ? FN<CARD, 1, 0, MASK_NONE, bf16>(__VA_ARGS__)           \
               : -1)

int item_count(int body, int BH, int Sl) {
  if (body == 0) return BH * ((Sl + BQ - 1) / BQ);
  return (BH * Sl + NTHREADS - 1) / NTHREADS;
}

bool takes(int body, int p, int BH, int Sl, int D) {
  if (p < 1 || p > MAXP || body < 0 || body > 2 || Sl < 1) return false;
  // copy_share counts a shard's 16-byte chunks in 32 bits
  const int esize = body == 1 ? 4 : 2;
  if (static_cast<long long>(BH) * Sl * D * esize / 16 >= (1LL << 31)) {
    return false;
  }
  if (body == 0) return Sl % TC_ROWS == 0 && (D == 64 || D == 128);
  return D <= MAXD_SIMPLE;
}

}  // namespace

// blocks per rank that one cooperative launch of the whole ring can hold
// (at most one per item); -1 if the device cannot launch it
extern "C" int k7_ring_blocks(int body, int p, int BH, int Sl, int D) {
  if (!takes(body, p, BH, Sl, D)) return -1;
  const bool tail = Sl % BKV != 0;
  const int items = item_count(body, BH, Sl);
  const int n = K7_DISPATCH(blocks_for, false, p, items);
  return n < 1 ? -1 : n;
}

// blocks of one rank's launch once per card (the whole card; at most one
// per item); -1 if the device cannot launch it
extern "C" int k7_card_blocks(int body, int BH, int Sl, int D) {
  if (!takes(body, 1, BH, Sl, D)) return -1;
  const bool tail = Sl % BKV != 0;
  const int items = item_count(body, BH, Sl);
  const int n = K7_DISPATCH(blocks_for, true, 1, items);
  return n < 1 ? -1 : n;
}

// floats of state a rank needs
extern "C" long long k7_ring_state_floats(int body, int BH, int Sl, int D) {
  if (body == 0) {
    return static_cast<long long>(item_count(body, BH, Sl)) *
           (4 + D / 2) * TC_THREADS;
  }
  return static_cast<long long>(BH) * Sl * (2 + D);
}

// q, k, v, o, kslot, vslot, state: host arrays of p device pointers (rank
// r's [B, H, Sl, D] shards with the common strides below, its two packed
// kv slots, its state); maps: the tensor-core body's device buffer of
// 7 p (3 p at p = 1) tensor maps, 64-byte aligned, of which the slots' are
// written only when maps_ready is 0; arrived, done: [p, p] counters, never
// reset; target = epoch * nblk; fault_rank / fault_step: -1, or a rank that
// skips the math of a step (a planted fault for the check of the checks)
extern "C" int k7_ring_attention(
    const void* const* q, const void* const* k, const void* const* v,
    void* const* o, void* const* kslot, void* const* vslot,
    void* const* state, void* maps, int maps_ready, void* arrived,
    void* done, int body, int p, int B, int H, int Sl, int D,
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
  a.spin_ns = SPIN_NS;
  a.rank = -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 0) {
    if (maps == nullptr || reinterpret_cast<uintptr_t>(maps) % 64 ||
        (p > 1 && (kslot == nullptr || vslot == nullptr))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    CUtensorMap host[7 * MAXP];
    bool ok = true;
    for (int r = 0; r < p; ++r) {
      ok = ok && make_map(&host[3 * r], q[r], D, Sl, H, B, qss, qsh, qsb) &&
           make_map(&host[3 * r + 1], k[r], D, Sl, H, B, kss, ksh, ksb) &&
           make_map(&host[3 * r + 2], v[r], D, Sl, H, B, vss, vsh, vsb);
    }
    const bool slots = p > 1 && !maps_ready;
    const long long sh = static_cast<long long>(Sl) * D;
    const long long slot_bytes = static_cast<long long>(B) * H * sh * 2;
    for (int r = 0; slots && r < p; ++r) {
      for (int s = 0; s < 2; ++s) {
        const char* ks = static_cast<const char*>(kslot[r]) + s * slot_bytes;
        const char* vs = static_cast<const char*>(vslot[r]) + s * slot_bytes;
        ok = ok &&
             make_map(&host[3 * p + 4 * r + s], ks, D, Sl, H, B, D, sh,
                      H * sh) &&
             make_map(&host[3 * p + 4 * r + 2 + s], vs, D, Sl, H, B, D, sh,
                      H * sh);
      }
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaMemcpyAsync(
        maps, host, (slots ? 7 : 3) * p * sizeof(CUtensorMap),
        cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int items = item_count(body, B * H, Sl);
  const bool tail = Sl % BKV != 0;
  return K7_DISPATCH(launch_ring, false, a, maps, items, nblk, st);
}

namespace {

long long round256(long long n) { return (n + 255) / 256 * 256; }

long long slot_bytes_of(int body, int BH, int Sl, int D) {
  return static_cast<long long>(BH) * Sl * D * (body == 1 ? 4 : 2);
}

}  // namespace

// bytes of one rank's workspace once per card: the header of counters,
// then two k slots and two v slots of [B*H, Sl, D]
extern "C" long long k7_card_workspace_bytes(int body, int BH, int Sl,
                                             int D) {
  return HDR_BYTES + 4 * round256(slot_bytes_of(body, BH, Sl, D));
}

// One rank's launch of the ring once per card. q, k, v, o: this rank's
// [B, H, Sl, D] (the common strides below); ws: its workspace (from
// k7_ipc_alloc: counters zeroed once, never reset), ws_right / ws_left:
// its neighbours' (peer-mapped by k7_ipc_open; unused at p = 1, where ws
// may be null); state: its softmax state; maps: the tensor-core body's
// device buffer of 7 maps (3 at p = 1), 64-byte aligned, whose slot maps
// are written only when maps_ready is 0; rank: its place on the ring of p;
// nblk: k7_card_blocks on every rank alike; epoch: this call's, counted
// from 1 alike on every rank; timeout_s: a spin's bound. A launch that
// gives up leaves a status code in ws (k7_card_status).
extern "C" int k7_ring_attention_card(
    const void* q, const void* k, const void* v, void* o, void* ws,
    void* ws_right, void* ws_left, void* state, void* maps, int maps_ready,
    int body, int rank, int p, int B, int H, int Sl, int D,
    int qsb, int qsh, int qss, int ksb, int ksh, int kss,
    int vsb, int vsh, int vss, int osb, int osh, int oss,
    int nblk, unsigned epoch, float scale, int fault_rank, int fault_step,
    float timeout_s, void* stream) {
  if (k7_card_blocks(body, B * H, Sl, D) < nblk || nblk < 1 || rank < 0 ||
      rank >= p || timeout_s <= 0.f ||
      (p > 1 && (ws == nullptr || ws_right == nullptr ||
                 ws_left == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long slot = round256(slot_bytes_of(body, B * H, Sl, D));
  char* const mine = static_cast<char*>(ws);
  char* const theirs = static_cast<char*>(ws_right);
  RingArgs a;
  a.q[0] = q;
  a.k[0] = k;
  a.v[0] = v;
  a.o[0] = o;
  a.kslot[0] = p > 1 ? mine + HDR_BYTES : nullptr;
  a.vslot[0] = p > 1 ? mine + HDR_BYTES + 2 * slot : nullptr;
  a.kslot_right = p > 1 ? theirs + HDR_BYTES : nullptr;
  a.vslot_right = p > 1 ? theirs + HDR_BYTES + 2 * slot : nullptr;
  a.state[0] = static_cast<float*>(state);
  a.hdr = static_cast<unsigned*>(ws);
  a.hdr_right = static_cast<unsigned*>(ws_right);
  a.hdr_left = static_cast<unsigned*>(ws_left);
  a.arrived = a.done = nullptr;
  a.p = p;
  a.H = H;
  a.BH = B * H;
  a.Sl = Sl;
  a.D = D;
  a.qsb = qsb; a.qsh = qsh; a.qss = qss;
  a.ksb = ksb; a.ksh = ksh; a.kss = kss;
  a.vsb = vsb; a.vsh = vsh; a.vss = vss;
  a.osb = osb; a.osh = osh; a.oss = oss;
  a.epoch = epoch;
  a.target = epoch * static_cast<unsigned>(nblk);
  a.scale = scale;
  a.fault_rank = fault_rank;
  a.fault_step = fault_step;
  a.spin_ns = static_cast<unsigned long long>(timeout_s * 1e9);
  a.rank = rank;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == 0) {
    if (maps == nullptr || reinterpret_cast<uintptr_t>(maps) % 64) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    CUtensorMap host[7];
    bool ok = make_map(&host[0], q, D, Sl, H, B, qss, qsh, qsb) &&
              make_map(&host[1], k, D, Sl, H, B, kss, ksh, ksb) &&
              make_map(&host[2], v, D, Sl, H, B, vss, vsh, vsb);
    const bool slots = p > 1 && !maps_ready;
    // the kernel finds slot s of a kind s slot_bytes after the first
    const long long sh = static_cast<long long>(Sl) * D;
    const long long packed = slot_bytes_of(body, B * H, Sl, D);
    for (int s = 0; slots && s < 2; ++s) {
      ok = ok &&
           make_map(&host[3 + s], mine + HDR_BYTES + s * packed, D, Sl, H, B,
                    D, sh, H * sh) &&
           make_map(&host[5 + s], mine + HDR_BYTES + 2 * slot + s * packed,
                    D, Sl, H, B, D, sh, H * sh);
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        cudaMemcpyAsync(maps, host, (slots ? 7 : 3) * sizeof(CUtensorMap),
                        cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int items = item_count(body, B * H, Sl);
  const bool tail = Sl % BKV != 0;
  return K7_DISPATCH(launch_ring, true, a, maps, items, nblk, st);
}

// Waits for the stream, then reads the status a launch once per card left
// in ws (0: none; ST_TIMEOUT, ST_PEER, ST_EPOCH) into *status.
extern "C" int k7_card_status(void* ws, void* stream, int* status) {
  cudaError_t err = cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpy(status, static_cast<unsigned*>(ws) + HDR_STATUS,
                   sizeof(int), cudaMemcpyDeviceToHost);
  return static_cast<int>(err);
}

// What the runtime must do for the launch once per card: a workspace
// outside PyTorch's caching allocator (an IPC handle maps a whole
// allocation, and a cached tensor may lie inside a larger one), its handle,
// a peer's mapped into this process, and the peer-access query.
extern "C" int k7_ipc_alloc(int dev, long long bytes, void** ptr,
                            void* handle) {
  cudaError_t err = cudaSetDevice(dev);
  if (err == cudaSuccess) err = cudaMalloc(ptr, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*ptr, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  }
  if (err != cudaSuccess) cudaFree(*ptr);
  return static_cast<int>(err);
}

extern "C" int k7_ipc_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

extern "C" int k7_ipc_open(int dev, const void* handle, void** ptr) {
  cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int k7_ipc_close(int dev, void* ptr) {
  cudaError_t err = cudaSetDevice(dev);
  if (err == cudaSuccess) err = cudaIpcCloseMemHandle(ptr);
  return static_cast<int>(err);
}

extern "C" int k7_device_free(int dev, void* ptr) {
  cudaError_t err = cudaSetDevice(dev);
  if (err == cudaSuccess) err = cudaFree(ptr);
  return static_cast<int>(err);
}

extern "C" int k7_can_access_peer(int dev, int peer, int* out) {
  return static_cast<int>(cudaDeviceCanAccessPeer(out, dev, peer));
}
