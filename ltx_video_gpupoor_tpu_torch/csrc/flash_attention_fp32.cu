// K1f: flash attention forward in fp32 on Hopper's tensor cores, for
// sm_90a: every product as three TF32 wgmma products (split TF32).
//
// Replaces the fp32 branches of the Pallas TPU kernel
// ltx_video_gpupoor_tpu/ops/flash_attention.py::_flash_kernel (:160,
// reached through flash_attention :412 -> pl.pallas_call :631, and through
// flash_attention_hp :804 -> _hp_kernel :663 -> pl.pallas_call :866). The
// TPU kernel runs its products in the input dtype (:343-352) and writes
// the output in it (:639), so an fp32 caller (FP32_POLICY) gets fp32
// attention; the bf16 kernels (K1/K3/K6, K4/K3q) take bf16 only.
//
// One kernel, five variants (template flags), each the function of a
// plain version in ops/flash_attention.py:
//   exact        o = softmax(q k^T * scale) v          reference_attention
//   bounded      p = exp2(min(s, sb) - sb), no max     bounded_attention_plain
//   qk8          int8 Q.K^T codes, fp32 V (QK tier)    int8_attention_plain
//   qk8 bounded  the same under the bound (K3q's)      int8_attention_plain
//   pv8          int8 Q.K^T and int8 P.V (QK+PV tier)  int8_attention_plain
// with s = (s32 * q_scale) * k_scale in the QK tier (one k scale a kv
// row), s32 * (q_scale * k_scale) with per-kv-block k scales in the QK+PV
// tier (the int8 products are integers below 2**22, exact in fp32, so the
// scores equal the plain version's bit for bit); P codes round(exp2(s - m
// + log2 127)) against the running max as of each 64-row kv tile, and the
// pv8 denominator sums fp32 p at D=128 and 127 * sum(P codes) * (1/127) at
// D=64, as the TPU kernel's ones column of V does. The QK+PV tier reads V
// as the prologue writes it for K4: int8 V^T [B, H, D, Spad] in K4's kv
// order inside each 32-row chunk (k4_v_layout). Masks: a static kv_valid
// tail, segment ids (attend iff q_seg == kv_seg and kv_seg > 0) and
// causal; a row that sees no key returns exactly 0. Head dims 64 and 128;
// any strides with a unit last stride, so head-split views of [B, S, H*D]
// projections and the head-packed layout of K6 are read in place.
//
// What bounds it on an H100: the tensor cores. fp32 operands do not feed
// them as they are, and fp32 fused multiply-adds on the CUDA cores top out
// near 67 TFLOP/s. TF32 wgmma runs at 495 TFLOP/s dense, with 10 mantissa
// bits an operand. Each fp32 operand a splits into big = cvt.rna.tf32(a)
// (written out, not left to how the tensor core reads the low 13 bits) and
// small = cvt.rna.tf32(a - big); then A.B = Ab.Bb + Ab.Bs + As.Bb with
// fp32 accumulation, and the dropped As.Bs is about 2**-22 of |A||B|
// (tests/test_torch_k1f_split.py emulates it: 1 % of atol = rtol = 2e-5
// at Skv 3840). Three products of 4*B*H*Sq*Skv*D / 2 operations each make
// the bound 3 * 4*B*H*Sq*Skv*D / 495e12 s; the exponentials (one ex2 a
// score) and the splits run on the CUDA cores beside them.
//
// Design. 384 threads a block: a producer warpgroup and two consumer
// warpgroups of 64 q rows each (128 q rows a block, as K1).
// - TF32 wgmma reads both operands K-major only (no transpose flag for
//   32-bit types). Q and K [S, D] are K-major already. P.V reduces over kv,
//   so V is held as V^T [D, kv]. P stays in registers as the A operand:
//   a thread holds score columns 2t and 2t + 1 of each 8-column group (the
//   fp32 accumulator), the TF32 A fragment wants k indices t and t + 4, so
//   V^T lays kv row 2t + i at k index t + 4i (ops/flash_attention.py
//   K1F_PV_ORDER) and P needs no shuffle.
// - The producer reads each tile from device memory with 16-byte loads
//   into registers (one tile ahead of the shared-memory ring), splits it
//   and stores big and small into the ring in the layout wgmma reads:
//   K-major panels of 32 floats (128-byte rows) under the 128-byte swizzle
//   (K1's descriptors by bytes: a k-step of 8 values is 32 bytes); V
//   transposed on the way, four kv rows a thread so that each store is 16
//   bytes. It fences the stores to the async proxy and arrives on the
//   stage's full barrier; the consumers release a stage by its empty
//   barrier once their wgmma have read it. No TMA: the split has to pass
//   through registers anyway, and a raw staging tile would cost shared
//   memory that the split operands need.
// - Shared memory is the budget. An fp32 row of D=128 is 512 bytes, and
//   the split doubles it: Q big + small for 128 rows is 128 KB. So the kv
//   tile is 64 rows at D=64 (Q 64 KB + two stages of K and V^T, 32 KB
//   each: 192 KB) and 32 rows at D=128 (Q 128 KB + one stage of K and V^T:
//   192 KB). One block an SM.
// - A consumer warpgroup per kv tile: Q.K^T (SS, 3 x D/8 wgmma), its
//   release of the K stage, the mask, the softmax step, the split of p in
//   registers, P.V (RS, 3 x kv/8 wgmma), its release of the V stage. The
//   two warpgroups share the tensor cores, so one's softmax runs under the
//   other's products. Every consumer thread arrives on an empty barrier
//   (a lane-0 arrival is a divergent path next to the wgmma, which ptxas
//   then serialized), and the descriptors are built where they are used
//   (desc_here), not hoisted out of the kv loop into registers.
// - Registers: 384 threads leave 168 a thread. At D=128 the accumulator
//   is 64 of them, so where a 64-row tile's split P (64 more) would not
//   fit beside it (the int8-score variants), P.V runs in two chunks of 32
//   kv rows, each waited for; pv8 takes its s8 P.V in two halves of 64
//   output columns (one 32-register s32 accumulator).
// - The int8 variants take Q.K^T on s8 wgmma (m64n64k32, K-major codes in
//   64-byte rows under the 64-byte swizzle at D=64, 128-byte rows at
//   D=128, as K4) with a 64-row kv tile at both head dims; qk8 and
//   qk8_bounded then take P.V in split TF32 with an fp32 V, pv8 on s8
//   wgmma with P codes from registers in K4's A-fragment order and V^T
//   codes copied as k4_v_layout wrote them (64-byte rows, 64-byte
//   swizzle).
// - Instances by mask kind: none (no compare), tail (the last kv tile
//   compares), general (segment ids, causal: every tile compares).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int K1F_THREADS = 384;  // a producer and two consumer warpgroups
constexpr int K1F_BQ = 128;       // q rows a block
constexpr float LOG2_127 = 6.9886846867721655f;
constexpr float SUM_COL_SCALE = 0.007874015718698502f;  // float32(1/127)
constexpr float MAGIC = 12582912.0f;  // 1.5 * 2**23, bits 0x4B400000
constexpr uint32_t MAGIC_BITS = 0x4B400000u;

enum Variant { EXACT = 0, BOUNDED_V = 1, QK8 = 2, QK8_BOUNDED = 3, PV8 = 4 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* out;
  const int* q_seg;
  const int* kv_seg;
  const float* q_scale;  // [B, H, Sq]
  const float* k_scale;  // [B, H, nks]: one a k_block kv rows
  const float* v_scale;  // [B, H, D]
  int H, Sq, Skv, nks, k_block;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int kv_end;  // min(Skv, kv_valid)
  int causal;
  float scale_log2;
  float bound_log2;
};

// the kv tile, the ring and the shared-memory layout of one instance;
// every region starts on a 1024-byte boundary (the swizzle's period)
template <int D, int VARIANT>
struct Cfg1f {
  static constexpr bool INT8_QK = VARIANT >= QK8;
  static constexpr bool INT8_PV = VARIANT == PV8;
  static constexpr bool BOUNDED = VARIANT == BOUNDED_V ||
                                  VARIANT == QK8_BOUNDED;
  static constexpr bool SPLIT_QK = !INT8_QK;
  static constexpr int BKV = (SPLIT_QK && D == 128) ? 32 : 64;
  static constexpr int STAGES = (SPLIT_QK && D == 128) ? 1 : 2;
  // kv rows of one split-TF32 P.V chunk: 32 where the accumulator (D=128)
  // and a 64-row tile's split P would not fit beside each other
  static constexpr int PVC = (D == 128 && BKV == 64) ? 32 : BKV;
  // split operands: big, then small, each in panels of 32 floats
  static constexpr int Q_BYTES = INT8_QK ? K1F_BQ * D : 2 * K1F_BQ * D * 4;
  static constexpr int K_BYTES = INT8_QK ? BKV * D : 2 * BKV * D * 4;
  static constexpr int V_BYTES = INT8_PV ? D * BKV : 2 * D * BKV * 4;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int VSC_OFF = V_OFF + STAGES * V_BYTES;
  static constexpr int BAR_OFF = VSC_OFF + (INT8_PV ? 1024 : 0);
  static constexpr int SMEM_BYTES = 1024 + BAR_OFF + 8 * (1 + 4 * STAGES);
  // int8 Q and K rows: 64 bytes under the 64-byte swizzle at D=64
  static constexpr int QK8_LAYOUT = D == 128 ? SWIZZLE_128B : SWIZZLE_64B;
  static_assert(SMEM_BYTES <= 232448, "one block's shared memory");
};

// byte offset of 16-byte chunk c of row r in a tile of ROW-byte rows under
// the swizzle of that span (128: c ^ r % 8; 64: c ^ (r / 2) % 4)
template <int ROW>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (ROW == 128) return r * 128 + ((c ^ (r & 7)) << 4);
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// four floats -> their TF32 big and small parts
__device__ __forceinline__ void split4(float4 v, uint4& big, uint4& small) {
  big.x = tf32_rna(v.x);
  big.y = tf32_rna(v.y);
  big.z = tf32_rna(v.z);
  big.w = tf32_rna(v.w);
  small.x = tf32_rna(v.x - __uint_as_float(big.x));
  small.y = tf32_rna(v.y - __uint_as_float(big.y));
  small.z = tf32_rna(v.z - __uint_as_float(big.z));
  small.w = tf32_rna(v.w - __uint_as_float(big.w));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// the stores of this thread made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// an s32 of magnitude under 2**22 as a float, exactly
__device__ __forceinline__ float i2f(uint32_t x) {
  return __uint_as_float(x + MAGIC_BITS) - MAGIC;
}

__device__ __forceinline__ float quad_sum(float l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  return l;
}

// ---- the producer's tiles ------------------------------------------------------
//
// Each producer thread (tid 0..127) loads its share of a tile into
// registers and stores it later, so that the next tile's loads are in
// flight while the consumers work.

// fp32 rows [row0, row0 + R) of an [S, D] operand (row stride ld floats;
// rows at or past n read as 0): R * D / 4 float4, D / 4 a row; stored at
// row r_off of a tile of PR rows
template <int D, int R, int PR = R>
struct RowsF32 {
  static constexpr int N = R * D / 4 / 128;
  float4 v[N];
  __device__ __forceinline__ void load(const float* src, long long ld,
                                       int row0, int n, int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = tid + 128 * i, r = u / (D / 4), c4 = u % (D / 4);
      v[i] = row0 + r < n
                 ? __ldg(reinterpret_cast<const float4*>(
                       src + (long long)(row0 + r) * ld + c4 * 4))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // big and small, K-major: panel c4 / 8 of PR rows x 128 bytes
  __device__ __forceinline__ void store(uint8_t* dst, int tid,
                                        int r_off = 0) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = tid + 128 * i, r = u / (D / 4) + r_off, c4 = u % (D / 4);
      const int off = (c4 >> 3) * (PR * 128) + swz<128>(r, c4 & 7);
      uint4 big, small;
      split4(v[i], big, small);
      *reinterpret_cast<uint4*>(dst + off) = big;
      *reinterpret_cast<uint4*>(dst + PR * D * 4 + off) = small;
    }
  }
};

// int8 rows [row0, row0 + R) of an [S, D] operand: R * D / 16 chunks of
// 16 bytes, in rows of D bytes (the 64-byte swizzle at D=64)
template <int D, int R>
struct RowsS8 {
  static constexpr int N = R * D / 16 / 128;
  uint4 v[N];
  __device__ __forceinline__ void load(const int8_t* src, long long ld,
                                       int row0, int n, int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = tid + 128 * i, r = u / (D / 16), c = u % (D / 16);
      v[i] = row0 + r < n
                 ? __ldg(reinterpret_cast<const uint4*>(
                       src + (long long)(row0 + r) * ld + c * 16))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void store(uint8_t* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = tid + 128 * i, r = u / (D / 16), c = u % (D / 16);
      *reinterpret_cast<uint4*>(dst + swz<D>(r, c)) = v[i];
    }
  }
};

// fp32 V rows [row0, row0 + BKV) as split V^T [D rows x BKV kv]: panels of
// 32 kv (128-byte rows), kv row 2t + i of each 8-row group at k index
// t + 4i. A unit is four kv rows that land in one 16-byte chunk (rows
// 8 g + h + {0, 2, 4, 6} of a panel at chunk 2 g + h) by four d values.
template <int D, int BKV>
struct VtF32 {
  static constexpr int UNITS = (BKV / 4) * (D / 4) / 128;
  float4 v[4 * UNITS];
  __device__ __forceinline__ void load(const float* src, long long ld,
                                       int row0, int n, int tid) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = tid + 128 * i, kq = u % (BKV / 4), c = u / (BKV / 4);
      const int cp = kq & 7;
      const int kv = (kq >> 3) * 32 + (cp >> 1) * 8 + (cp & 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + kv + 2 * e;
        v[4 * i + e] = row < n
                           ? __ldg(reinterpret_cast<const float4*>(
                                 src + (long long)row * ld + c * 4))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  __device__ __forceinline__ void store(uint8_t* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = tid + 128 * i, kq = u % (BKV / 4), c = u / (BKV / 4);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const int d = c * 4 + dd;
        const int off = (kq >> 3) * (D * 128) + swz<128>(d, kq & 7);
        const float4 col = make_float4(
            comp(v[4 * i], dd), comp(v[4 * i + 1], dd),
            comp(v[4 * i + 2], dd), comp(v[4 * i + 3], dd));
        uint4 big, small;
        split4(col, big, small);
        *reinterpret_cast<uint4*>(dst + off) = big;
        *reinterpret_cast<uint4*>(dst + D * BKV * 4 + off) = small;
      }
    }
  }
};

// int8 V^T columns [col0, col0 + 64) of K4's [D, Spad] codes (d stride
// ld), copied as they are into rows of 64 bytes (64-byte swizzle)
template <int D>
struct VtS8 {
  static constexpr int N = D * 4 / 128;
  uint4 v[N];
  __device__ __forceinline__ void load(const int8_t* src, long long ld,
                                       int col0, int, int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = tid + 128 * i, d = u >> 2, c = u & 3;
      v[i] = __ldg(reinterpret_cast<const uint4*>(src + d * ld + col0 +
                                                  c * 16));
    }
  }
  __device__ __forceinline__ void store(uint8_t* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = tid + 128 * i;
      *reinterpret_cast<uint4*>(dst + swz<64>(u >> 2, u & 3)) = v[i];
    }
  }
};

// ---- wgmma ----------------------------------------------------------------------

// d (64 x 64 fp32) += a (64 x 8 tf32, shared, K-major) * b (64 x 8 tf32, shared,
// K-major)^T; d is overwritten where scale_d == 0
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
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

// the same with a 32 x 8 b
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64 fp32) += a (64 x 8 tf32, registers) * b (64 x 8 tf32, shared,
// K-major)^T
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
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

// the same with a 128 x 8 b
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
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

// d (64 x 64 s32) += a (64 x 32 int8, shared, K-major) * b (64 x 32 int8,
// shared, K-major)^T; d is overwritten where scale_d == 0
__device__ __forceinline__ void wgmma_s8_ss_n64(uint32_t (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64 s32) += a (64 x 32 int8, registers) * b (64 x 32 int8, shared,
// K-major)^T
__device__ __forceinline__ void wgmma_s8_rs_n64(uint32_t (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// A shared-memory descriptor built where it is used: the asm hides its
// value from the compiler, which would otherwise hoist every k-step's
// descriptors out of the kv loop and hold them in registers (128 at D=128)
__device__ __forceinline__ uint64_t desc_here(uint32_t addr, uint32_t sbo,
                                              int layout = SWIZZLE_128B) {
  uint64_t d = wgmma_desc(addr, 16, sbo, layout);
  asm volatile("" : "+l"(d));
  return d;
}

// Q.K^T of one kv tile in split TF32: sc (64 q rows x BKV) = Qb.Ks +
// Qs.Kb, then + Qb.Kb; q and k are the big parts of this warpgroup's Q
// rows (panels of 128 rows) and of the K stage (panels of BKV rows), the
// small parts lie a whole tile further on. A k-step of 8 values is 32
// bytes of a 128-byte row, 16 units of the descriptor's address field.
// Issued and committed.
template <int D, int BKV>
__device__ __forceinline__ void qk_issue_f32(float (&sc)[BKV / 2],
                                             uint32_t q, uint32_t k) {
  constexpr int QP = K1F_BQ * 128, KP = BKV * 128;
  constexpr int QS = K1F_BQ * D * 4, KS = BKV * D * 4;
  const uint64_t qb = desc_here(q, 1024), qs = desc_here(q + QS, 1024);
  const uint64_t kb = desc_here(k, 1024), ks = desc_here(k + KS, 1024);
  auto mma = [&](uint64_t da, uint64_t db, int kk, int scale_d) {
    const uint64_t qo = ((kk >> 2) * QP + (kk & 3) * 32) >> 4;
    const uint64_t ko = ((kk >> 2) * KP + (kk & 3) * 32) >> 4;
    if constexpr (BKV == 64) wgmma_tf32_ss_n64(sc, da + qo, db + ko, scale_d);
    if constexpr (BKV == 32) wgmma_tf32_ss_n32(sc, da + qo, db + ko, scale_d);
  };
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    mma(qb, ks, kk, kk > 0);
    mma(qs, kb, kk, 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) mma(qb, kb, kk, 1);
  wgmma_commit();
}

// acc += P.V of KV kv rows of a tile (from k-step kk0, 8 kv rows a
// k-step) in split TF32: Pb.Vs + Ps.Vb, then Pb.Vb; P from registers
// (k-step kk: score columns 8 kk .. 8 kk + 7, registers 4 kk .. 4 kk + 3
// of the accumulator layout, which are the A fragment's a0, a2, a1, a3),
// V^T big at v (panels of 32 kv), small a tile (BKV kv rows) further.
// Issued and committed.
template <int D, int BKV, int KV>
__device__ __forceinline__ void pv_issue_f32(float (&acc)[D / 2],
                                             uint32_t (&pb)[KV / 2],
                                             uint32_t (&ps)[KV / 2],
                                             uint32_t v, int kk0) {
  constexpr int VP = D * 128, VS = D * BKV * 4;
  auto mma = [&](const uint32_t (&a)[KV / 2], int kk, uint64_t db) {
    const int k = kk0 + kk;
    db += ((k >> 2) * VP + (k & 3) * 32) >> 4;
    if constexpr (D == 64) {
      wgmma_tf32_rs_n64(acc, a[4 * kk], a[4 * kk + 2], a[4 * kk + 1],
                        a[4 * kk + 3], db, 1);
    } else {
      wgmma_tf32_rs_n128(acc, a[4 * kk], a[4 * kk + 2], a[4 * kk + 1],
                         a[4 * kk + 3], db, 1);
    }
  };
  const uint64_t vb = desc_here(v, 1024), vs = desc_here(v + VS, 1024);
  pin(acc);
  pin(pb);
  pin(ps);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KV / 8; ++kk) {
    mma(pb, kk, vs);
    mma(ps, kk, vb);
  }
#pragma unroll
  for (int kk = 0; kk < KV / 8; ++kk) mma(pb, kk, vb);
  wgmma_commit();
}

// s32 Q.K^T of one 64-row kv tile from int8 codes (rows of D bytes).
// Issued and committed.
template <int D>
__device__ __forceinline__ void qk_issue_s8(uint32_t (&sc)[32], uint32_t q,
                                            uint32_t k) {
  constexpr int LAYOUT = Cfg1f<D, QK8>::QK8_LAYOUT;
  const uint64_t qd = desc_here(q, 8 * D, LAYOUT);
  const uint64_t kd = desc_here(k, 8 * D, LAYOUT);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    wgmma_s8_ss_n64(sc, qd + kk * 2, kd + kk * 2, kk > 0);
  }
  wgmma_commit();
}

// pv = P8.V8 (s32, fresh) of one 64-row kv tile against 64 rows (d) of
// V^T codes in rows of 64 bytes: P codes from registers (k-step kk:
// logical kv columns 32 kk .. 32 kk + 31). Issued and committed.
__device__ __forceinline__ void pv_issue_s8(uint32_t (&pv)[32],
                                            uint32_t (&p8)[8], uint32_t v) {
  const uint64_t vd = desc_here(v, 512, SWIZZLE_64B);
  pin(pv);
  pin(p8);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    wgmma_s8_rs_n64(pv, p8[4 * kk], p8[4 * kk + 1], p8[4 * kk + 2],
                    p8[4 * kk + 3], vd + kk * 2, kk > 0);
  }
  wgmma_commit();
}

// p in [0, 127] (32 scores: 8 tiles of 8 columns) -> int8 codes in K4's
// A-fragment order of the s8 P.V (pack_codes in flash_attention_int8.cu):
// k-step kk takes tiles 4 kk .. 4 kk + 3; register r holds tiles
// 4 kk + 2 (r >> 1) and + 1, elements 2 (r & 1) + {0, 1}. The add of MAGIC
// rounds half to even; cs0 / cs1 return the sums of the codes of the
// thread's two rows.
__device__ __forceinline__ void pack_codes(const float (&p)[32],
                                           uint32_t (&p8)[8], float& cs0,
                                           float& cs1) {
  cs0 = 0.f;
  cs1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j0 = 4 * kk + 2 * (r >> 1), e = 2 * (r & 1);
      const float c0 = p[4 * j0 + e] + MAGIC, c1 = p[4 * j0 + e + 1] + MAGIC;
      const float c2 = p[4 * j0 + 4 + e] + MAGIC;
      const float c3 = p[4 * j0 + 4 + e + 1] + MAGIC;
      const uint32_t lo = __byte_perm(__float_as_uint(c0), __float_as_uint(c1),
                                      0x0040);
      const uint32_t hi = __byte_perm(__float_as_uint(c2), __float_as_uint(c3),
                                      0x0040);
      p8[4 * kk + r] = __byte_perm(lo, hi, 0x5410);
      const float sum = ((c0 - MAGIC) + (c1 - MAGIC)) +
                        ((c2 - MAGIC) + (c3 - MAGIC));
      if (r & 1) cs1 += sum; else cs0 += sum;
    }
  }
}

// what a consumer thread knows of its two rows and of the call's masks
struct RowsF {
  int row0, row1, qs0, qs1;
  const int* kv_seg;  // this batch row's kv segment ids, or null
};

// masked scores of one kv tile (columns kv0 + 8 jn + 2 t + c, rows row0
// and row1) go to NEG_INF
template <int MASK, int N>
__device__ __forceinline__ void mask_scores(float (&x)[N], const Params& p,
                                            const RowsF& r, int kv0, int t) {
#pragma unroll
  for (int jn = 0; jn < N / 4; ++jn) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = kv0 + jn * 8 + t * 2 + c;
      bool ok0 = col < p.kv_end, ok1 = ok0;
      if (MASK == MASK_GENERAL) {
        if (p.causal) {
          ok0 = ok0 && r.row0 >= col;
          ok1 = ok1 && r.row1 >= col;
        }
        if (r.kv_seg != nullptr) {
          const int ks = col < p.Skv ? r.kv_seg[col] : 0;
          ok0 = ok0 && ks > 0 && ks == r.qs0;
          ok1 = ok1 && ks > 0 && ks == r.qs1;
        }
      }
      if (!ok0) x[4 * jn + c] = NEG_INF;
      if (!ok1) x[4 * jn + 2 + c] = NEG_INF;
    }
  }
}

// ---- the kernel ---------------------------------------------------------------

template <int D, int MASK, int VARIANT>
__global__ void __launch_bounds__(K1F_THREADS, 1)
    flash_fp32_wgmma_kernel(const Params p) {
  using C = Cfg1f<D, VARIANT>;
  constexpr int BKV = C::BKV, STAGES = C::STAGES;
  constexpr bool INT8_QK = C::INT8_QK, INT8_PV = C::INT8_PV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_full = base + C::BAR_OFF;
  const uint32_t k_full = q_full + 8;
  const uint32_t k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES;
  const uint32_t v_empty = v_full + 8 * STAGES;
  float* vsc_s = reinterpret_cast<float*>(base_ptr + C::VSC_OFF);

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * K1F_BQ;
  const long long bh = (long long)b * p.H + h;
  int kv_hi = p.kv_end;
  if (MASK == MASK_GENERAL && p.causal) kv_hi = min(kv_hi, q0 + K1F_BQ);
  const int n_tiles = (kv_hi + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 128);  // every producer thread arrives
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 128);
      mbar_init(v_full + 8 * s, 128);
      // every consumer thread arrives: a lane-0 arrival is a divergent
      // path that made ptxas serialize the wgmma (C7520)
      mbar_init(k_empty + 8 * s, 256);
      mbar_init(v_empty + 8 * s, 256);
    }
    mbar_init_fence();
  }
  if (INT8_PV) {
    for (int i = threadIdx.x; i < D; i += K1F_THREADS) {
      vsc_s[i] = p.v_scale[bh * D + i];
    }
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    if (n_tiles == 0) return;
    const int tid = threadIdx.x;
    const int esz = INT8_QK ? 1 : 4;
    const char* qg = static_cast<const char*>(p.q) +
                     (b * p.qsb + h * p.qsh) * esz;
    const char* kg = static_cast<const char*>(p.k) +
                     (b * p.ksb + h * p.ksh) * esz;
    const char* vg = static_cast<const char*>(p.v) +
                     (b * p.vsb + h * p.vsh) * (INT8_PV ? 1 : 4);
    if constexpr (INT8_QK) {
      RowsS8<D, K1F_BQ> qt;
      qt.load(reinterpret_cast<const int8_t*>(qg), p.qss, q0, p.Sq, tid);
      qt.store(base_ptr, tid);
    } else {
#pragma unroll 1
      for (int r = 0; r < K1F_BQ; r += 32) {
        RowsF32<D, 32, K1F_BQ> qt;
        qt.load(reinterpret_cast<const float*>(qg), p.qss, q0 + r, p.Sq,
                tid);
        qt.store(base_ptr, tid, r);
      }
    }
    fence_async_shared();
    mbar_arrive(q_full);

    using KT = typename std::conditional<INT8_QK, RowsS8<D, BKV>,
                                         RowsF32<D, BKV>>::type;
    using VT = typename std::conditional<INT8_PV, VtS8<D>,
                                         VtF32<D, BKV>>::type;
    using KE = typename std::conditional<INT8_QK, int8_t, float>::type;
    using VE = typename std::conditional<INT8_PV, int8_t, float>::type;
    const KE* ksrc = reinterpret_cast<const KE*>(kg);
    const VE* vsrc = reinterpret_cast<const VE*>(vg);
    KT kt;
    VT vt;
    kt.load(ksrc, p.kss, 0, p.Skv, tid);
    vt.load(vsrc, p.vss, 0, p.Skv, tid);
#pragma unroll 1
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t empty_phase = ((j / STAGES) & 1) ^ 1;
      if (j >= STAGES) mbar_wait(k_empty + 8 * s, empty_phase);
      kt.store(base_ptr + C::K_OFF + s * C::K_BYTES, tid);
      fence_async_shared();
      mbar_arrive(k_full + 8 * s);
      if (j + 1 < n_tiles) kt.load(ksrc, p.kss, (j + 1) * BKV, p.Skv, tid);
      if (j >= STAGES) mbar_wait(v_empty + 8 * s, empty_phase);
      vt.store(base_ptr + C::V_OFF + s * C::V_BYTES, tid);
      fence_async_shared();
      mbar_arrive(v_full + 8 * s);
      if (j + 1 < n_tiles) vt.load(vsrc, p.vss, (j + 1) * BKV, p.Skv, tid);
    }
    return;
  }

  // the consumer warpgroups
  const int ct = threadIdx.x - 128, cw = ct >> 7;
  const int warp = (ct >> 5) & 3, lane = ct & 31, g = lane >> 2, t = lane & 3;
  RowsF r;
  r.row0 = q0 + cw * 64 + warp * 16 + g;
  r.row1 = r.row0 + 8;
  r.qs0 = r.qs1 = 0;
  r.kv_seg = nullptr;
  if (MASK == MASK_GENERAL && p.q_seg != nullptr) {
    r.qs0 = r.row0 < p.Sq ? p.q_seg[(long long)b * p.Sq + r.row0] : 0;
    r.qs1 = r.row1 < p.Sq ? p.q_seg[(long long)b * p.Sq + r.row1] : 0;
    r.kv_seg = p.kv_seg + (long long)b * p.Skv;
  }
  float qsc0 = 0.f, qsc1 = 0.f;
  if (INT8_QK) {
    qsc0 = r.row0 < p.Sq ? p.q_scale[bh * p.Sq + r.row0] : 0.f;
    qsc1 = r.row1 < p.Sq ? p.q_scale[bh * p.Sq + r.row1] : 0.f;
  }
  const uint32_t sQ = base + cw * (INT8_QK ? 64 * D : 64 * 128);
  const uint32_t sK = base + C::K_OFF, sV = base + C::V_OFF;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = M_FLOOR, m1 = M_FLOOR, l0 = 0.f, l1 = 0.f;

  // One kv tile; `masked` says at compile time whether it compares
  // (MASK_ALWAYS), does not (MASK_NEVER) or finds out (MASK_ASK).
  auto step = [&](int j, auto masked) {
    const int s = j % STAGES, kv0 = j * BKV;
    const uint32_t ph = (j / STAGES) & 1;
    float x[BKV / 2];
    mbar_wait(k_full + 8 * s, ph);
    if constexpr (INT8_QK) {
      uint32_t sc[BKV / 2];
      qk_issue_s8<D>(sc, sQ, sK + s * C::K_BYTES);
      wgmma_wait<0>();
      pin(sc);
      mbar_arrive(k_empty + 8 * s);
      if constexpr (INT8_PV) {
        const float ks = p.k_scale[bh * p.nks + kv0 / p.k_block];
        const float f0 = qsc0 * ks, f1 = qsc1 * ks;
#pragma unroll
        for (int jn = 0; jn < BKV / 8; ++jn) {
          x[4 * jn] = i2f(sc[4 * jn]) * f0;
          x[4 * jn + 1] = i2f(sc[4 * jn + 1]) * f0;
          x[4 * jn + 2] = i2f(sc[4 * jn + 2]) * f1;
          x[4 * jn + 3] = i2f(sc[4 * jn + 3]) * f1;
        }
      } else {  // one k scale a kv row (k_block 1)
        const float* ksr = p.k_scale + bh * p.nks + kv0 + 2 * t;
#pragma unroll
        for (int jn = 0; jn < BKV / 8; ++jn) {
          const float2 k2 = __ldg(reinterpret_cast<const float2*>(ksr + 8 * jn));
          x[4 * jn] = (i2f(sc[4 * jn]) * qsc0) * k2.x;
          x[4 * jn + 1] = (i2f(sc[4 * jn + 1]) * qsc0) * k2.y;
          x[4 * jn + 2] = (i2f(sc[4 * jn + 2]) * qsc1) * k2.x;
          x[4 * jn + 3] = (i2f(sc[4 * jn + 3]) * qsc1) * k2.y;
        }
      }
    } else {
      qk_issue_f32<D, BKV>(x, sQ, sK + s * C::K_BYTES);
      wgmma_wait<0>();
      pin(x);
      mbar_arrive(k_empty + 8 * s);
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) x[i] *= p.scale_log2;
    }
    constexpr int how = decltype(masked)::value;
    if (how == MASK_ALWAYS || (how == MASK_ASK && j == n_tiles - 1)) {
      mask_scores<MASK>(x, p, r, kv0, t);
    }

    // the softmax step: x becomes p
    float ls0 = 0.f, ls1 = 0.f;
    [[maybe_unused]] float a0 = 1.f, a1 = 1.f;
    if constexpr (C::BOUNDED) {
      const float sb = p.bound_log2;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) x[i] = ex2(fminf(x[i], sb) - sb);
    } else {
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int jn = 0; jn < BKV / 8; ++jn) {
        mx0 = fmaxf(mx0, fmaxf(x[4 * jn], x[4 * jn + 1]));
        mx1 = fmaxf(mx1, fmaxf(x[4 * jn + 2], x[4 * jn + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      a0 = ex2(m0 - mn0);
      a1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // the x127 fold: in the QK+PV tier p lives in [0, 127]
      const float off0 = INT8_PV ? mn0 - LOG2_127 : mn0;
      const float off1 = INT8_PV ? mn1 - LOG2_127 : mn1;
#pragma unroll
      for (int jn = 0; jn < BKV / 8; ++jn) {
        x[4 * jn] = ex2(x[4 * jn] - off0);
        x[4 * jn + 1] = ex2(x[4 * jn + 1] - off0);
        x[4 * jn + 2] = ex2(x[4 * jn + 2] - off1);
        x[4 * jn + 3] = ex2(x[4 * jn + 3] - off1);
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= a0;
        acc[4 * n + 1] *= a0;
        acc[4 * n + 2] *= a1;
        acc[4 * n + 3] *= a1;
      }
    }
#pragma unroll
    for (int jn = 0; jn < BKV / 8; ++jn) {
      ls0 += x[4 * jn] + x[4 * jn + 1];
      ls1 += x[4 * jn + 2] + x[4 * jn + 3];
    }

    mbar_wait(v_full + 8 * s, ph);
    if constexpr (INT8_PV) {
      uint32_t p8[8], pv[32];
      float cs0, cs1;
      pack_codes(x, p8, cs0, cs1);
      if (D % 128) {  // JAX's ones column of V sums the codes
        ls0 = (cs0 * 127.f) * SUM_COL_SCALE;
        ls1 = (cs1 * 127.f) * SUM_COL_SCALE;
      }
      // 64 output columns at a time: one s32 accumulator of 32 registers
#pragma unroll
      for (int half = 0; half < D / 64; ++half) {
        pv_issue_s8(pv, p8, sV + s * C::V_BYTES + half * 64 * 64);
        wgmma_wait<0>();
        pin(pv);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int a = 32 * half + 4 * n;
          const float2 vs = *reinterpret_cast<const float2*>(
              vsc_s + 64 * half + n * 8 + 2 * t);
          acc[a] = fmaf(i2f(pv[4 * n]), vs.x, acc[a]);
          acc[a + 1] = fmaf(i2f(pv[4 * n + 1]), vs.y, acc[a + 1]);
          acc[a + 2] = fmaf(i2f(pv[4 * n + 2]), vs.x, acc[a + 2]);
          acc[a + 3] = fmaf(i2f(pv[4 * n + 3]), vs.y, acc[a + 3]);
        }
      }
      mbar_arrive(v_empty + 8 * s);
    } else {
      // in chunks of PVC kv rows, each waited for: the split P of a chunk
      // is 2 x PVC / 2 registers
#pragma unroll
      for (int c = 0; c < BKV / C::PVC; ++c) {
        uint32_t pb[C::PVC / 2], ps[C::PVC / 2];
#pragma unroll
        for (int i = 0; i < C::PVC / 2; ++i) {
          const float pe = x[c * (C::PVC / 2) + i];
          pb[i] = tf32_rna(pe);
          ps[i] = tf32_rna(pe - __uint_as_float(pb[i]));
        }
        pv_issue_f32<D, BKV, C::PVC>(acc, pb, ps, sV + s * C::V_BYTES,
                                     c * (C::PVC / 8));
        wgmma_wait<0>();
        pin(acc);
      }
      mbar_arrive(v_empty + 8 * s);
    }
    if constexpr (C::BOUNDED) {
      l0 += ls0;
      l1 += ls1;
    } else {
      l0 = l0 * a0 + ls0;
      l1 = l1 * a1 + ls1;
    }
  };

  if (n_tiles > 0) {
    mbar_wait(q_full, 0);
    // the tail kind's last tile, the one that straddles kv_end, compares
    if (MASK == MASK_GENERAL) {
      for (int j = 0; j < n_tiles; ++j) step(j, How<MASK_ALWAYS>{});
    } else if (MASK == MASK_TAIL) {
      for (int j = 0; j < n_tiles; ++j) step(j, How<MASK_ASK>{});
    } else {
      for (int j = 0; j < n_tiles; ++j) step(j, How<MASK_NEVER>{});
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float d0 = l0 > 0.f ? l0 : 1.f;
  const float d1 = l1 > 0.f ? l1 : 1.f;
  float* ob = p.out + b * p.osb + h * p.osh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + t * 2;
    if (r.row0 < p.Sq) {
      *reinterpret_cast<float2*>(ob + r.row0 * p.oss + c) =
          make_float2(acc[4 * n] / d0, acc[4 * n + 1] / d0);
    }
    if (r.row1 < p.Sq) {
      *reinterpret_cast<float2*>(ob + r.row1 * p.oss + c) =
          make_float2(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
    }
  }
}

template <int D, int MASK, int VARIANT>
int launch(const Params& p, int B, cudaStream_t stream) {
  auto kern = flash_fp32_wgmma_kernel<D, MASK, VARIANT>;
  constexpr int smem = Cfg1f<D, VARIANT>::SMEM_BYTES;
  // once an instance: a launch does no other host work
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.Sq + K1F_BQ - 1) / K1F_BQ, p.H, B);
  kern<<<grid, K1F_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MASK>
int by_variant(const Params& p, int B, int variant, cudaStream_t s) {
  switch (variant) {
    case EXACT: return launch<D, MASK, EXACT>(p, B, s);
    case BOUNDED_V: return launch<D, MASK, BOUNDED_V>(p, B, s);
    case QK8: return launch<D, MASK, QK8>(p, B, s);
    case QK8_BOUNDED: return launch<D, MASK, QK8_BOUNDED>(p, B, s);
    case PV8: return launch<D, MASK, PV8>(p, B, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int by_mask(const Params& p, int B, int mask_kind, int variant,
            cudaStream_t s) {
  switch (mask_kind) {
    case MASK_NONE: return by_variant<D, MASK_NONE>(p, B, variant, s);
    case MASK_TAIL: return by_variant<D, MASK_TAIL>(p, B, variant, s);
    case MASK_GENERAL: return by_variant<D, MASK_GENERAL>(p, B, variant, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k [B, H, S, D] fp32 (variants exact, bounded) or int8 codes (qk8,
// qk8 bounded, pv8); v [B, H, Skv, D] fp32, or for pv8 int8 V^T [B, H, D,
// Spad] in K4's kv order (its strides b, h, d; Spad a 64 multiple that
// covers Skv); out [B, H, Sq, D] fp32. Strides in elements, last stride
// 1, rows 16-byte aligned; q_seg / kv_seg [B, S] int32 or null; q_scale
// [B, H, Sq], k_scale [B, H, nks] (one a k_block kv rows: k_block 1 for
// qk8 and qk8 bounded, a 64 multiple for pv8), v_scale [B, H, D] fp32 for
// the int8 variants; kv_valid -1 = none; mask_kind as
// flash_attention.MASK_KINDS, refused where it masks less than the call
// needs; variant 0 exact, 1 bounded, 2 qk8, 3 qk8 bounded, 4 pv8;
// scale_log2 = scale * log2(e) (fp32 scores; the int8 variants carry it in
// q_scale), bound_log2 = score_bound * log2(e).
extern "C" int k1f_flash_attention_fp32(
    const void* q, const void* k, const void* v, void* out,
    const void* q_seg, const void* kv_seg, const void* q_scale,
    const void* k_scale, const void* v_scale, int B, int H, int Sq, int Skv,
    int D, int qsb, int qsh, int qss, int ksb, int ksh, int kss, int vsb,
    int vsh, int vss, int osb, int osh, int oss, int kv_valid, int causal,
    int mask_kind, int variant, int k_block, int nks, float scale_log2,
    float bound_log2, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  if (variant < 0 || variant > PV8 || Skv < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant >= QK8 && (q_scale == nullptr || k_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((variant == QK8 || variant == QK8_BOUNDED) && k_block != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant == PV8 && (v_scale == nullptr || k_block < 64 ||
                         k_block % 64 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((q_seg == nullptr) != (kv_seg == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = static_cast<float*>(out);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.q_scale = static_cast<const float*>(q_scale);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.nks = nks;
  p.k_block = k_block;
  p.qsb = qsb; p.qsh = qsh; p.qss = qss;
  p.ksb = ksb; p.ksh = ksh; p.kss = kss;
  p.vsb = vsb; p.vsh = vsh; p.vss = vss;
  p.osb = osb; p.osh = osh; p.oss = oss;
  p.kv_end = kv_valid < 0 ? Skv : (kv_valid < Skv ? kv_valid : Skv);
  p.causal = causal;
  p.scale_log2 = scale_log2;
  p.bound_log2 = bound_log2;
  // the mask kind must compare where the call needs it: a kv tail that
  // ends inside a 64-row tile, segment ids, causal
  int need = p.kv_end % 64 ? MASK_TAIL : MASK_NONE;
  if (q_seg != nullptr || causal) need = MASK_GENERAL;
  if (mask_kind < need) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return by_mask<64>(p, B, mask_kind, variant, s);
  if (D == 128) return by_mask<128>(p, B, mask_kind, variant, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
