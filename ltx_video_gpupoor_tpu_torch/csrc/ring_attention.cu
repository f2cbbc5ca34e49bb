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
//   Every spin is bounded: a protocol fault traps instead of hanging. The
//   ring waits only between items, where no wgmma group is in flight.
// - The kernel takes each rank's buffers as base pointers. On a host with
//   several cards the same kernel would be launched once a device with
//   peer-mapped pointers; that launch is not written here.
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
// softmax state written and read back in all at p = 4).

#include "attention_block.cuh"

namespace {

constexpr int MAXP = 16;
constexpr int NTHREADS = 128;     // the CUDA-core body's block
constexpr int TC_THREADS = 256;   // the tensor-core body's: K1's two consumers
constexpr int TC_ROWS = 64;       // S/p the tensor-core body takes: multiples
constexpr int MAXD_SIMPLE = 128;
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
    proxy_fence();  // thread 0 issues the TMA loads of what arrived
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
// 3 r .. 3 r + 2; its k slots 0, 1 and v slots 0, 1 at 3 p + 4 r .. + 3.
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
template <int D, int MASK>
__device__ void tc_step(const RingArgs& a, const CUtensorMap* maps, int rank,
                        int step, int items, const Ring& rg, int& it,
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
  tl.qmap = maps + 3 * rank;
  tl.kmap = kv_map(maps, a.p, rank, step, 0);
  tl.vmap = kv_map(maps, a.p, rank, step, 1);
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
    float* st = a.state[rank] +
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
    bf16* ob = static_cast<bf16*>(a.o[rank]) + tl.b * a.osb + tl.h * a.osh;
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

// BODY 0: tensor cores, bf16, D = DT, MASK none or tail; BODY 1: CUDA
// cores, T in
template <int BODY, int DT, int MASK, typename T>
__global__ void __launch_bounds__(BODY == 0 ? TC_THREADS : NTHREADS, 1)
ring_kernel(const RingArgs a, const CUtensorMap* __restrict__ maps,
            int items) {
  extern __shared__ uint8_t smem_raw[];  // the tensor-core body's block
  const int rank = blockIdx.y;
  const int p = a.p;
  const int right = (rank + 1) % p;
  const int esize = sizeof(T);
  const int row_bytes = a.D * esize;
  const long long slot_bytes =
      static_cast<long long>(a.BH) * a.Sl * row_bytes;
  Ring rg;
  int it = 0, q_phase = 0;
  if constexpr (BODY == 0) {
    rg = ring_layout<DT>(smem_raw);
    if (threadIdx.x == 0) {
      ring_init<DT>(rg);
      for (int step = 0; step < p && step < 3; ++step) {
        if (step == 0) map_acquire(maps + 3 * rank);
        map_acquire(kv_map(maps, p, rank, step, 0));
        map_acquire(kv_map(maps, p, rank, step, 1));
      }
    }
    __syncthreads();
  }

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
      if constexpr (BODY == 0) {
        tc_step<DT, MASK>(a, maps, rank, step, items, rg, it, q_phase);
      } else {
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
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

// dynamic shared memory of an instance, set as its attribute (above 48 KB a
// kernel must ask for it); -1 on failure
template <int BODY, int DT, int MASK, typename T>
int prepare() {
  if constexpr (BODY == 0) {
    if (cudaFuncSetAttribute(ring_kernel<BODY, DT, MASK, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<DT>::SMEM_BYTES) != cudaSuccess) {
      return -1;
    }
    return Cfg<DT>::SMEM_BYTES;
  }
  return 0;
}

template <int BODY, int DT, int MASK, typename T>
int blocks_for(int p, int items) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  const int smem = prepare<BODY, DT, MASK, T>();
  if (smem < 0 || cudaGetDevice(&dev) != cudaSuccess) return -1;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ring_kernel<BODY, DT, MASK, T>,
          BODY == 0 ? TC_THREADS : NTHREADS, smem) != cudaSuccess) {
    return -1;
  }
  const int cap = per_sm * sms / p;
  return items < cap ? items : cap;
}

template <int BODY, int DT, int MASK, typename T>
int launch_ring(const RingArgs& a, const void* maps, int items, int nblk,
                cudaStream_t st) {
  const int smem = prepare<BODY, DT, MASK, T>();
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  RingArgs args = a;
  const CUtensorMap* map_arg = static_cast<const CUtensorMap*>(maps);
  void* params[] = {&args, &map_arg, &items};
  const dim3 grid(nblk, a.p);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ring_kernel<BODY, DT, MASK, T>), grid,
      dim3(BODY == 0 ? TC_THREADS : NTHREADS), params, smem, st);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// body: 0 tensor cores (bf16, D 64 / 128; `tail`: S/p not a multiple of
// the 128-row tile), 1 CUDA cores fp32 in, 2 CUDA cores bf16 in
#define K7_DISPATCH(FN, ...)                                                \
  (body == 0 && D == 64 && !tail    ? FN<0, 64, MASK_NONE, bf16>(__VA_ARGS__) \
   : body == 0 && D == 64           ? FN<0, 64, MASK_TAIL, bf16>(__VA_ARGS__) \
   : body == 0 && D == 128 && !tail ? FN<0, 128, MASK_NONE, bf16>(__VA_ARGS__) \
   : body == 0 && D == 128          ? FN<0, 128, MASK_TAIL, bf16>(__VA_ARGS__) \
   : body == 1                      ? FN<1, 0, MASK_NONE, float>(__VA_ARGS__) \
   : body == 2                      ? FN<1, 0, MASK_NONE, bf16>(__VA_ARGS__) \
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
  const int n = K7_DISPATCH(blocks_for, p, items);
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
  return K7_DISPATCH(launch_ring, a, maps, items, nblk, st);
}
