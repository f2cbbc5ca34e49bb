// K4: int8 flash attention forward for sm_90a, in the two int8 tiers of
// the JAX package: int8 Q.K^T with int8 P.V ("pallas_int8pv"), or int8
// Q.K^T with bf16 P.V ("pallas_int8"); and K3q, the QK tier under a fixed
// score bound ("pallas_int8" with score_bound=).
//
// Replaces the qk_int8 / pv_int8 branches of the Pallas TPU kernel
// ltx_video_gpupoor_tpu/ops/flash_attention.py::_flash_kernel (reached
// through flash_attention, :412 -> pl.pallas_call :631): the int8 scores
// (:218-239), the int8 P.V (:270-292), the x127 exponent fold (:321-327)
// and the finalize (:393-401). K3q replaces the branch of the same kernel
// that runs qk_int8 scores (:218-239, per-row k scales) into the bounded
// softmax step (_update :296-313) with bf16 P.V (_pv :289-292). The
// quantize prologue (:484-533) runs before the launch
// (ops/flash_attention.py, int8_prologue: Q's rows, and the QK tier's K
// rows, by K2's row kernel in int8_linear.cu; the QK+PV tier's block K
// scales and channel V scales as torch ops), bit-equal to the plain
// version's.
//
// Inputs are the prologue's int8 q and k ([B, H, S, D], any strides with
// a unit last one, 16-byte aligned), fp32 q scales [B, H, Sq] with
// scale*log2(e) folded in, and in the QK+PV tier v as V^T [B, H, D, Spad]
// int8 in the kernel's kv order (ops/flash_attention.py::k4_v_layout, see
// below), fp32 k scales per kv block of the JAX kernel ([B, H, nks], a
// block a 128 multiple) and fp32 v scales [B, H, D] (JAX's v_scale * 127);
// in the QK tier v bf16 [B, H, S, D] and one fp32 k scale a kv row, padded
// to rows of nks = Spad entries. Masks as in K1: a kv_valid tail, segment
// ids (attend iff q_seg == kv_seg and kv_seg > 0), causal; rows that see no
// key return 0. D in {64, 128}, any Sq and Skv; K4 also takes D = 80 (CLIP
// ViT-H/14's heads) in the D = 128 layout: the tensor maps' inner extent
// is 80 (Q and K rows of 80 bytes, V^T's 80 rows, V's 80 columns), TMA
// fills the rest of each box with zeros, the v scales past 80 are 0, the
// epilogue stores 80 columns, and the denominator is the rounded one of
// JAX's ones column (below).
//
// Math per kv tile, as in JAX: s = s32 * (qs * ks) (QK+PV) or
// (s32 * qs) * ks (QK); online softmax in the exp2 domain with the running
// max m; in the QK+PV tier p = exp2(s - (m - log2 127)) lies in [0, 127] and
// rounds half to even to an int8 code p8, and acc = acc * alpha + (p8 . v8)
// * v_scale. The denominator l sums the fp32 p, or, where JAX's head dim is
// not a 128 multiple (its ones column of V, "sum_col"), the rounded p:
// 127 * sum(p8) * SUM_COL_SCALE in the QK+PV tier, sum(bf16(p)) in the QK
// tier. o = acc / l. JAX moves its running max once a kv block (4096 rows
// at the Wan shape), this kernel once a 128-row tile, so p is quantized
// against another max and the two agree to int8 noise, not bit for bit.
// K3q (QK tier, bounded): s = (s32 * qs) * ks as above, then p = exp2(min(s,
// sb) - sb) at the fixed offset sb = score_bound * log2(e): no running max,
// no factor, no rescale of acc; acc += bf16(p) . v, l sums p (the bf16 p at
// D=64), o = acc / l. With per-row k scales and no max, nothing depends on
// the kv block, so K3q agrees with its plain version to fp32 summation
// order and ex2's approximation (int8_attention_plain with score_bound=).
//
// What bounds it on an H100: the softmax on the CUDA cores, not the tensor
// cores. One ex2 a score (16 a clock an SM) takes 6.97 ms at the Wan 2.1
// self-attention shape (B2 H12 S32760 D128), above the 6.66 ms int8 tensor
// bound; the rest of a score's work (max, scale, offset, rounding, sums)
// runs on the FMA and integer pipes beside it. Memory does not bound it.
//
// Design: K1's block (flash_attention_wgmma.cu) with int8 products.
// - 128 q rows a block in two consumer warpgroups of 64; 256 threads,
//   thread 0 issues every TMA load from inside its warpgroup's loop.
// - Q.K^T is wgmma m64n128k32 s32.s8.s8 with Q (loaded once) and the K tile
//   from shared memory, both K-major as the prologue writes them: rows of
//   128 bytes under the 128-byte swizzle at D=128, of 64 bytes under the
//   64-byte swizzle at D=64. The s32 scores become floats exactly by the
//   exponent trick (|s32| < 2**22): bits(s32 + 0x4B400000) - 1.5 * 2**23.
// - P.V in the QK+PV tier is wgmma m64nDk32 s32.s8.s8 with P from
//   registers. A thread holds score columns 8j + 2t + {0, 1}; the s8 A
//   fragment wants 4 consecutive k-bytes 4t..4t+3 (+16) of each 32-wide
//   k-step. So the kv order inside each 32-row chunk is permuted: logical
//   column 4t + i (+16) holds kv row 2t + {0, 1, 8, 9}[i] (+16), the
//   columns a thread already holds, and V arrives as V^T (8-bit wgmma
//   reads B K-major only) in that order, laid out by the wrapper. A code is
//   the low byte of bits(p + 1.5 * 2**23): the add rounds half to even.
//   In the QK tier P.V is K1's bf16 product (transposed-B descriptor).
// - K, V (and the QK tier's k scales, by a bulk copy) arrive by TMA into a
//   two-deep ring under the math; Q.K^T of tile j and P.V of tile j - 1 are
//   issued together and tile j's softmax runs while P.V is in flight.
// - Instances by mask kind, as K1: none, tail (the last tile compares),
//   general (segment ids, causal).
// Registers a thread (ptxas): QK tier 203-214 at D=128, QK+PV tier 232-255
// (the s32 P.V accumulator in flight adds 64), 163-215 at D=64; no spills,
// one block an SM.
// K3q has a kernel of its own (k3q_wgmma_kernel, below) on the same
// products, masks and scores: a producer warp that alone issues the loads,
// the warpgroups taking turns on the tensor cores, staged output stores.

#include <cmath>

#include "hopper.cuh"

namespace {

constexpr float LOG2_127 = 6.9886846867721655f;
// the scale that JAX's ones column of V carries into the denominator in
// the QK+PV tier: float32(float32(1/127)^2 * 127), which is float32(1/127)
constexpr float SUM_COL_SCALE = 0.007874015718698502f;
constexpr float MAGIC = 12582912.0f;  // 1.5 * 2**23, bits 0x4B400000
constexpr uint32_t MAGIC_BITS = 0x4B400000u;
constexpr int K4_THREADS = 256;

// an s32 of magnitude under 2**22 as a float, exactly
__device__ __forceinline__ float i2f(uint32_t x) {
  return __uint_as_float(x + MAGIC_BITS) - MAGIC;
}

// ---- s8 wgmma -----------------------------------------------------------------

// d (64 x 128 s32) += a (64 x 32 int8, shared, K-major) * b (128 x 32
// int8, shared, K-major)^T; d is overwritten where scale_d == 0
__device__ __forceinline__ void wgmma_s8_ss_n128(uint32_t (&d)[64], uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128 s32) += a (64 x 32 int8, registers) * b (128 x 32 int8,
// shared, K-major)^T
__device__ __forceinline__ void wgmma_s8_rs_n128(uint32_t (&d)[64], uint32_t a0, uint32_t a1,
    uint32_t a2, uint32_t a3, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// the same with a 64 x 32 b
__device__ __forceinline__ void wgmma_s8_rs_n64(uint32_t (&d)[32], uint32_t a0, uint32_t a1,
    uint32_t a2, uint32_t a3, uint64_t desc_b, int scale_d) {
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

template <int D, bool PV8>
struct K4Cfg {
  static constexpr int QK_LAYOUT = D == 128 ? SWIZZLE_128B : SWIZZLE_64B;
  static constexpr int QK_SBO = 8 * D;  // bytes between 8-row groups
  static constexpr int Q_BYTES = BQ * D;
  static constexpr int K_BYTES = BKV * D;
  // V^T int8 [D x 128 kv] (QK+PV), or V bf16 [128 kv x D] in panels (QK)
  static constexpr int V_BYTES = PV8 ? D * BKV : BKV * D * 2;
  static constexpr int KS_BYTES = PV8 ? 0 : BKV * 4;  // a tile's k scales
  static constexpr int STAGES = 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int KS_OFF = V_OFF + STAGES * V_BYTES;
  static constexpr int VSC_OFF = KS_OFF + STAGES * KS_BYTES;
  static constexpr int BAR_OFFSET = VSC_OFF + (PV8 ? D * 4 : 0);
  static constexpr int SMEM_BYTES = 1024 + BAR_OFFSET + 8 * (1 + 4 * STAGES);
};

// sc = Q K^T (s32) for one kv tile, issued and committed, not waited for
template <int D, bool PV8>
__device__ __forceinline__ void qk_issue_s8(uint32_t (&sc)[64],
                                            uint32_t q_rows, uint32_t k_tile) {
  using C = K4Cfg<D, PV8>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    wgmma_s8_ss_n128(sc, wgmma_desc(q_rows + kk * 32, 16, C::QK_SBO,
                                    C::QK_LAYOUT),
                     wgmma_desc(k_tile + kk * 32, 16, C::QK_SBO,
                                C::QK_LAYOUT), kk > 0);
  }
  wgmma_commit();
}

// pv = P8 . V8 (s32, fresh) for one kv tile: P8 from registers (k-step kk
// takes logical kv columns 32 kk .. 32 kk + 31), V^T [D x 128] from shared
// memory; issued and committed, not waited for
template <int D>
__device__ __forceinline__ void pv_issue_s8(uint32_t (&pv)[D / 2],
                                            uint32_t (&p8)[16],
                                            uint32_t vt_tile) {
  pin(pv);
  pin(p8);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 32; ++kk) {
    const uint64_t dv = wgmma_desc(vt_tile + kk * 32, 16, 1024);
    if constexpr (D == 128) {
      wgmma_s8_rs_n128(pv, p8[4 * kk], p8[4 * kk + 1], p8[4 * kk + 2],
                       p8[4 * kk + 3], dv, kk > 0);
    } else {
      wgmma_s8_rs_n64(pv, p8[4 * kk], p8[4 * kk + 1], p8[4 * kk + 2],
                      p8[4 * kk + 3], dv, kk > 0);
    }
  }
  wgmma_commit();
}

// One online-softmax step in the exp2 domain, in place: s becomes p =
// exp2(s - m) (QK) or exp2(s - (m - log2 127)) (QK+PV) with m the running
// max; ls0 and ls1 are this thread's sums of the fp32 p; a0 and a1 the
// factors that the accumulator's two rows owe the new max.
template <bool PV8>
__device__ __forceinline__ void softmax_k4(float (&s)[64], float& m0,
                                           float& m1, float& a0, float& a1,
                                           float& ls0, float& ls1) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int jn = 0; jn < 16; ++jn) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * jn], s[4 * jn + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * jn + 2], s[4 * jn + 3]));
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
  // the x127 fold: in the QK+PV tier p lives in [0, 127], the int8 grid
  const float off0 = PV8 ? mn0 - LOG2_127 : mn0;
  const float off1 = PV8 ? mn1 - LOG2_127 : mn1;
  ls0 = 0.f;
  ls1 = 0.f;
#pragma unroll
  for (int jn = 0; jn < 16; ++jn) {
    s[4 * jn] = ex2(s[4 * jn] - off0);
    s[4 * jn + 1] = ex2(s[4 * jn + 1] - off0);
    s[4 * jn + 2] = ex2(s[4 * jn + 2] - off1);
    s[4 * jn + 3] = ex2(s[4 * jn + 3] - off1);
    ls0 += s[4 * jn] + s[4 * jn + 1];
    ls1 += s[4 * jn + 2] + s[4 * jn + 3];
  }
}

// p in [0, 127] -> int8 codes in the A-fragment order of the s8 P.V:
// k-step kk takes score tiles 4 kk .. 4 kk + 3; its register 0 holds rows
// g's codes of tiles 4 kk (elements 0, 1) and 4 kk + 1 (0, 1), register 1
// the same of row g + 8 (elements 2, 3), registers 2 and 3 tiles 4 kk + 2
// and 4 kk + 3. With `rounded`, cs0 / cs1 return the sums of the codes.
template <bool ROUNDED>
__device__ __forceinline__ void pack_codes(const float (&p)[64],
                                           uint32_t (&p8)[16], float& cs0,
                                           float& cs1) {
  cs0 = 0.f;
  cs1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // register r: tiles 4 kk + 2 (r >> 1) and + 1, elements 2 (r & 1) + {0, 1}
      const int j0 = 4 * kk + 2 * (r >> 1), e = 2 * (r & 1);
      const float c0 = p[4 * j0 + e] + MAGIC, c1 = p[4 * j0 + e + 1] + MAGIC;
      const float c2 = p[4 * j0 + 4 + e] + MAGIC;
      const float c3 = p[4 * j0 + 4 + e + 1] + MAGIC;
      const uint32_t lo = __byte_perm(__float_as_uint(c0), __float_as_uint(c1),
                                      0x0040);
      const uint32_t hi = __byte_perm(__float_as_uint(c2), __float_as_uint(c3),
                                      0x0040);
      p8[4 * kk + r] = __byte_perm(lo, hi, 0x5410);
      if (ROUNDED) {
        const float sum = ((c0 - MAGIC) + (c1 - MAGIC)) +
                          ((c2 - MAGIC) + (c3 - MAGIC));
        if (r & 1) cs1 += sum; else cs0 += sum;
      }
    }
  }
}

// tile j of an operand goes to stage j % STAGES, its full barrier completes
// phase (j / STAGES) & 1, and so does its empty barrier when every consumer
// warp has released it
template <int STAGES>
__device__ __forceinline__ void ring_wait_empty(uint32_t empty, int j) {
  if (j >= STAGES) {
    mbar_wait(empty + 8 * (j % STAGES), ((j / STAGES) & 1) ^ 1);
  }
}

// DV: the head's values, D or (80, in the D = 128 layout) fewer
template <int D, bool PV8, int MASK, int DV = D>
__global__ void __launch_bounds__(K4_THREADS, 1)
flash_int8_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        bf16* __restrict__ o, const int* __restrict__ q_seg,
                        const int* __restrict__ kv_seg,
                        const float* __restrict__ qscale,
                        const float* __restrict__ kscale,
                        const float* __restrict__ vscale, int Sq, int Skv,
                        long long osb, long long osh, long long oss,
                        int ks_block, int nks, int kv_end, int causal) {
  using C = K4Cfg<D, PV8>;
  constexpr int STAGES = C::STAGES;
  constexpr bool SUM_ROUNDED = DV % 128 != 0;  // JAX's sum_col
  static_assert(DV <= D && DV % 8 == 0, "whole 8-column groups of acc");
  extern __shared__ uint8_t smem_raw[];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base;
  const uint32_t sK = base + C::K_OFF;
  const uint32_t sV = base + C::V_OFF;
  const uint32_t sKS = base + C::KS_OFF;
  float* vsc_s = reinterpret_cast<float*>(
      const_cast<uint8_t*>(base_ptr) + C::VSC_OFF);
  const uint32_t q_full = base + C::BAR_OFFSET;
  const uint32_t k_full = q_full + 8;
  const uint32_t k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES;
  const uint32_t v_empty = v_full + 8 * STAGES;

  const int b = blockIdx.z, h = blockIdx.y;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
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
  if (PV8) {
    for (int i = threadIdx.x; i < D; i += K4_THREADS) {
      vsc_s[i] = i < DV ? vscale[bh * DV + i] : 0.f;
    }
  }
  __syncthreads();

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
  const float qsc0 = r.row0 < Sq ? qscale[bh * Sq + r.row0] : 0.f;
  const float qsc1 = r.row1 < Sq ? qscale[bh * Sq + r.row1] : 0.f;
  auto needs_mask = [&](int j) {
    if (MASK == MASK_TAIL) return j == n_tiles - 1;
    if (MASK == MASK_GENERAL) {
      return r.kv_seg != nullptr || (j + 1) * BKV > kv_lim ||
             (causal && (j + 1) * BKV - 1 > wg_row0);
    }
    return false;
  };
  const bool loads = threadIdx.x == 0;
  auto load_k = [&](int j) {
    ring_wait_empty<STAGES>(k_empty, j);
    const int s = j % STAGES;
    mbar_expect_tx(k_full + 8 * s, C::K_BYTES + C::KS_BYTES);
    tma_load_4d(sK + s * C::K_BYTES, &kmap, k_full + 8 * s, 0, j * BKV, h, b);
    if (!PV8) {
      bulk_load(sKS + s * C::KS_BYTES, kscale + bh * nks + j * BKV,
                C::KS_BYTES, k_full + 8 * s);
    }
  };
  auto load_v = [&](int j) {
    ring_wait_empty<STAGES>(v_empty, j);
    const int s = j % STAGES;
    const uint32_t dst = sV + s * C::V_BYTES;
    mbar_expect_tx(v_full + 8 * s, C::V_BYTES);
    if (PV8) {
      tma_load_4d(dst, &vmap, v_full + 8 * s, j * BKV, 0, h, b);
    } else {
#pragma unroll
      for (int p = 0; p < D / 64; ++p) {
        tma_load_4d(dst + p * PANEL_BYTES, &vmap, v_full + 8 * s, p * 64,
                    j * BKV, h, b);
      }
    }
  };
  // the QK+PV tier's k scale of tile j (one kv block's)
  auto block_scale = [&](int j) {
    return PV8 ? kscale[bh * nks + (j * BKV) / ks_block] : 0.f;
  };
  // the s32 scores of tile j (stage s) as floats in the exp2 domain; ks:
  // block_scale(j)
  auto scores = [&](const uint32_t (&sc)[64], float (&sf)[64], float ks,
                    int s) {
    if (PV8) {
      const float f0 = qsc0 * ks, f1 = qsc1 * ks;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        sf[4 * jn] = i2f(sc[4 * jn]) * f0;
        sf[4 * jn + 1] = i2f(sc[4 * jn + 1]) * f0;
        sf[4 * jn + 2] = i2f(sc[4 * jn + 2]) * f1;
        sf[4 * jn + 3] = i2f(sc[4 * jn + 3]) * f1;
      }
    } else {
      const float* ks = reinterpret_cast<const float*>(
          base_ptr + C::KS_OFF + s * C::KS_BYTES);
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const float2 k2 = *reinterpret_cast<const float2*>(ks + jn * 8 + 2 * t);
        sf[4 * jn] = (i2f(sc[4 * jn]) * qsc0) * k2.x;
        sf[4 * jn + 1] = (i2f(sc[4 * jn + 1]) * qsc0) * k2.y;
        sf[4 * jn + 2] = (i2f(sc[4 * jn + 2]) * qsc1) * k2.x;
        sf[4 * jn + 3] = (i2f(sc[4 * jn + 3]) * qsc1) * k2.y;
      }
    }
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = M_FLOOR, m1 = M_FLOOR, l0 = 0.f, l1 = 0.f;

  if (n_tiles > 0) {
    const uint32_t sQw = sQ + wg * (64 * D);  // this warpgroup's rows
    // P of the tile whose P.V is next: int8 codes or bf16 pairs
    uint32_t p[PV8 ? 16 : 32];
    uint32_t pv[PV8 ? D / 2 : 1];
#pragma unroll
    for (int i = 0; i < (PV8 ? D / 2 : 1); ++i) pv[i] = 0u;
    float a0, a1;
    // P -> registers and the denominator's step, from the p of one tile
    auto take_p = [&](float (&sf)[64], float ls0, float ls1) {
      if constexpr (PV8) {
        float cs0, cs1;
        pack_codes<SUM_ROUNDED>(sf, p, cs0, cs1);
        if (SUM_ROUNDED) {
          ls0 = (cs0 * 127.f) * SUM_COL_SCALE;
          ls1 = (cs1 * 127.f) * SUM_COL_SCALE;
        }
      } else {
        pack_p(sf, p);
        if (SUM_ROUNDED) {  // l sums the bf16 p that P.V multiplies
          ls0 = ls1 = 0.f;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const __nv_bfloat162 pr = *reinterpret_cast<__nv_bfloat162*>(&p[i]);
            const float sum = __low2float(pr) + __high2float(pr);
            if (i & 1) ls1 += sum; else ls0 += sum;
          }
        }
      }
      l0 = l0 * a0 + ls0;
      l1 = l1 * a1 + ls1;
    };
    auto issue_pv = [&](int s) {
      if constexpr (PV8) {
        pv_issue_s8<D>(pv, p, sV + s * C::V_BYTES);
      } else {
        pv_issue_bf16<D>(acc, p, sV + s * C::V_BYTES);
      }
    };
    // after P.V of a tile has landed: the QK+PV tier adds (p8 . v8) * v
    // scale; then both take the next tile's factors (1 after the last)
    auto fold_pv = [&](float f0, float f1) {
      if constexpr (PV8) {
        pin(pv);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const float2 vs =
              *reinterpret_cast<const float2*>(vsc_s + n * 8 + 2 * t);
          acc[4 * n] = fmaf(i2f(pv[4 * n]), vs.x, acc[4 * n]) * f0;
          acc[4 * n + 1] = fmaf(i2f(pv[4 * n + 1]), vs.y, acc[4 * n + 1]) * f0;
          acc[4 * n + 2] = fmaf(i2f(pv[4 * n + 2]), vs.x, acc[4 * n + 2]) * f1;
          acc[4 * n + 3] = fmaf(i2f(pv[4 * n + 3]), vs.y, acc[4 * n + 3]) * f1;
        }
      } else {
        pin(acc);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n] *= f0;
          acc[4 * n + 1] *= f0;
          acc[4 * n + 2] *= f1;
          acc[4 * n + 3] *= f1;
        }
      }
    };

    if (loads) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      tma_load_4d(sQ, &qmap, q_full, 0, q0, h, b);
      for (int j = 0; j < STAGES && j < n_tiles; ++j) {  // the stages are empty
        load_k(j);
        load_v(j);
      }
    }

    // tile 0: scores and softmax; its P.V is issued with tile 1's Q.K^T
    {
      uint32_t sc[64];
      float sf[64], ls0, ls1;
      const float ks = block_scale(0);
      mbar_wait(q_full, 0);
      mbar_wait(k_full, 0);
      qk_issue_s8<D, PV8>(sc, sQw, sK);
      wgmma_wait<0>();
      pin(sc);
      scores(sc, sf, ks, 0);
      __syncwarp();  // the warp's reads of the stage's k scales are done
      if (lane == 0) mbar_arrive(k_empty);
      if (needs_mask(0)) mask_tile<MASK>(sf, r, 0, t);
      softmax_k4<PV8>(sf, m0, m1, a0, a1, ls0, ls1);
      take_p(sf, ls0, ls1);
    }

    // One step of the loop, for tile j >= 1, as K1's: `masked` says at
    // compile time whether the tile compares (MASK_ALWAYS), does not
    // (MASK_NEVER) or finds out (MASK_ASK).
    auto step = [&](int j, auto masked) {
      const int s = j % STAGES, sp = (j - 1) % STAGES;
      // K of tile j - 1 was released in the last iteration, V of tile j - 2
      // in the one before: their stages take the tiles STAGES further on
      if (loads && j - 1 + STAGES < n_tiles) load_k(j - 1 + STAGES);
      if (loads && j >= 2 && j - 2 + STAGES < n_tiles) load_v(j - 2 + STAGES);
      uint32_t sc[64];
      float sf[64], ls0, ls1;
      const float ks = block_scale(j);
      mbar_wait(k_full + 8 * s, (j / STAGES) & 1);
      qk_issue_s8<D, PV8>(sc, sQw, sK + s * C::K_BYTES);
      mbar_wait(v_full + 8 * sp, ((j - 1) / STAGES) & 1);
      issue_pv(sp);
      wgmma_wait<1>();  // the scores of tile j are in
      pin(sc);
      scores(sc, sf, ks, s);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty + 8 * s);
      // tile j's softmax runs under tile j - 1's P.V
      constexpr int how = decltype(masked)::value;
      if (how == MASK_ALWAYS || (how == MASK_ASK && needs_mask(j))) {
        mask_tile<MASK>(sf, r, j * BKV, t);
      }
      softmax_k4<PV8>(sf, m0, m1, a0, a1, ls0, ls1);
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(v_empty + 8 * sp);
      fold_pv(a0, a1);
      take_p(sf, ls0, ls1);
    };
    if (MASK == MASK_GENERAL) {
      for (int j = 1; j < n_tiles; ++j) step(j, How<MASK_ASK>{});
    } else {
      const int n_free = MASK == MASK_TAIL ? n_tiles - 1 : n_tiles;
      for (int j = 1; j < n_free; ++j) step(j, How<MASK_NEVER>{});
      if (MASK == MASK_TAIL && n_tiles > 1) {
        step(n_tiles - 1, How<MASK_ALWAYS>{});
      }
    }

    const int sl = (n_tiles - 1) % STAGES;
    mbar_wait(v_full + 8 * sl, ((n_tiles - 1) / STAGES) & 1);
    issue_pv(sl);
    wgmma_wait<0>();
    fold_pv(1.f, 1.f);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 > 0.f ? l0 : 1.f;
  const float d1 = l1 > 0.f ? l1 : 1.f;
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
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

// ---- K3q: the QK tier under the bounded softmax ------------------------------

// K3q's block: the QK tier's products, masks and scores with the bounded
// softmax, laid out for what measuring K4's block at the 13B pass 2
// self-attention showed (ablations of its source; PERF.md): without its
// scores and exponentials it took 4.47 of 6.59 ms, without Q.K^T 5.67,
// without P.V 5.68; clock64 stamps put the two warpgroups in the same
// phase, their softmax at once (two warps of an SM quarter share its ex2
// unit, 4 a clock), and thread 0 stalled for about 600 cycles a tile
// issuing the loads and waiting on the empty barriers of a two-deep ring,
// with its warpgroup's next product waiting on it.
// - A producer warp (the ninth) issues every load: Q, then each tile's K
//   (int8), its k scales (a bulk copy) and V (bf16 in K1's panels) into a
//   ring of stages; it alone waits on the empty barriers.
// - 288 threads leave 168 registers a thread (three warps share an SM
//   quarter's registers). At D=64 that holds K4's overlap (a tile's
//   scores, 64 registers, in flight beside the P.V of the tile before,
//   32 + 32): a tile's softmax runs under that P.V, and the warpgroups
//   take their turns to issue (FlashAttention-3's ping-pong). At D=128 it
//   does not (the 64 accumulator registers more), so a warpgroup takes a
//   tile at a time: its turn runs from the Q.K^T issue to the end of the
//   softmax, so that one warpgroup's exponentials run while the other's
//   wait for their products, and its P.V stays in flight while it waits
//   for its next turn. (Keeping 128 kv rows in flight in halves of 64
//   under the same cap, or issuing the loads from the consumer warp
//   whose release frees a stage, both measured slower than K4's block.)
// - The output is staged through the drained ring and leaves in 16-byte
//   stores, a row's 16-byte chunks on neighbouring threads.
constexpr int K3Q_THREADS = 288;
constexpr int K3Q_CONSUMERS = 256;

template <int D>
struct K3qCfg {
  // whether a tile's softmax runs under the P.V of the tile before
  static constexpr bool OVERLAP = D == 64;
  // a ring 4 deep at D=64 (106 KB); at D=128 (113 KB) 2 deep, which
  // leaves the L1 the general mask's kv segment ids go through (with a
  // 4-deep ring, 210 KB, a text cross-attention took longer)
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int Q_BYTES = BQ * D;
  static constexpr int K_BYTES = BKV * D;
  static constexpr int V_BYTES = BKV * D * 2;  // D / 64 panels of K1's
  static constexpr int KS_BYTES = BKV * 4;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int KS_OFF = V_OFF + STAGES * V_BYTES;
  static constexpr int BAR_OFFSET = KS_OFF + STAGES * KS_BYTES;
  static constexpr int SMEM_BYTES = 1024 + BAR_OFFSET + 8 * (1 + 4 * STAGES);
  // the staged output, bf16 rows padded by 16 bytes (conflict-free writes
  // of a quad's four 4-byte columns by eight rows), over the V stages
  static constexpr int O_PITCH = D * 2 + 16;
  static_assert(BQ * O_PITCH <= STAGES * V_BYTES, "staging fits the ring");
};

// K3q's step over a tile, in place: s becomes p = exp2(min(s, sb)
// - sb) at the fixed offset sb (a masked score, NEG_INF, gives 0); ls0 and
// ls1 are this thread's sums of the fp32 p. No max, no shuffle, no factor.
__device__ __forceinline__ void softmax_bounded(float (&s)[64], float sb,
                                                float& ls0, float& ls1) {
  ls0 = 0.f;
  ls1 = 0.f;
#pragma unroll
  for (int jn = 0; jn < 16; ++jn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * jn + e] = ex2(fminf(s[4 * jn + e], sb) - sb);
    }
    ls0 += s[4 * jn] + s[4 * jn + 1];
    ls1 += s[4 * jn + 2] + s[4 * jn + 3];
  }
}

// DV: the head's values, D or (80, in the D = 128 layout) fewer
template <int D, int MASK, int DV = D>
__global__ void __launch_bounds__(K3Q_THREADS, 1)
k3q_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 bf16* __restrict__ o, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg,
                 const float* __restrict__ qscale,
                 const float* __restrict__ kscale, int Sq, int Skv,
                 long long osb, long long osh, long long oss, int nks,
                 int kv_end, int causal, float bound_log2) {
  using C = K3qCfg<D>;
  constexpr int STAGES = C::STAGES;
  constexpr bool SUM_ROUNDED = DV % 128 != 0;  // JAX's sum_col
  static_assert(DV <= D && DV % 8 == 0, "whole 16-byte chunks a row");
  extern __shared__ uint8_t smem_raw[];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sQ = base;
  const uint32_t sK = base + C::K_OFF;
  const uint32_t sV = base + C::V_OFF;
  const uint32_t sKS = base + C::KS_OFF;
  const uint32_t q_full = base + C::BAR_OFFSET;
  const uint32_t k_full = q_full + 8;
  const uint32_t k_empty = k_full + 8 * STAGES;
  const uint32_t v_full = k_empty + 8 * STAGES;
  const uint32_t v_empty = v_full + 8 * STAGES;

  const int b = blockIdx.z, h = blockIdx.y;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  const int q0 = blockIdx.x * BQ;

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

  if (threadIdx.x >= K3Q_CONSUMERS) {
    // ---- the producer warp: its first thread keeps the ring full ----
    if (threadIdx.x == K3Q_CONSUMERS && n_tiles > 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      tma_load_4d(sQ, &qmap, q_full, 0, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        ring_wait_empty<STAGES>(k_empty, j);
        mbar_expect_tx(k_full + 8 * s, C::K_BYTES + C::KS_BYTES);
        tma_load_4d(sK + s * C::K_BYTES, &kmap, k_full + 8 * s, 0, j * BKV, h,
                    b);
        bulk_load(sKS + s * C::KS_BYTES, kscale + bh * nks + j * BKV,
                  C::KS_BYTES, k_full + 8 * s);
        ring_wait_empty<STAGES>(v_empty, j);
        mbar_expect_tx(v_full + 8 * s, C::V_BYTES);
#pragma unroll
        for (int p = 0; p < D / 64; ++p) {
          tma_load_4d(sV + s * C::V_BYTES + p * PANEL_BYTES, &vmap,
                      v_full + 8 * s, p * 64, j * BKV, h, b);
        }
      }
    }
    return;
  }

  // ---- two consumer warpgroups of 64 q rows ----
  const int wg = threadIdx.x >> 7;
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
  const float qsc0 = r.row0 < Sq ? qscale[bh * Sq + r.row0] : 0.f;
  const float qsc1 = r.row1 < Sq ? qscale[bh * Sq + r.row1] : 0.f;
  auto needs_mask = [&](int j) {
    if (MASK == MASK_TAIL) return j == n_tiles - 1;
    if (MASK == MASK_GENERAL) {
      return r.kv_seg != nullptr || (j + 1) * BKV > kv_lim ||
             (causal && (j + 1) * BKV - 1 > wg_row0);
    }
    return false;
  };
  // tile j's s32 scores as floats in the exp2 domain, (s32 * qs) * ks
  auto scores = [&](const uint32_t (&sc)[64], float (&sf)[64], int j) {
    const float* ks = reinterpret_cast<const float*>(
        base_ptr + C::KS_OFF + (j % STAGES) * C::KS_BYTES);
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const float2 k2 = *reinterpret_cast<const float2*>(ks + jn * 8 + 2 * t);
      sf[4 * jn] = (i2f(sc[4 * jn]) * qsc0) * k2.x;
      sf[4 * jn + 1] = (i2f(sc[4 * jn + 1]) * qsc0) * k2.y;
      sf[4 * jn + 2] = (i2f(sc[4 * jn + 2]) * qsc1) * k2.x;
      sf[4 * jn + 3] = (i2f(sc[4 * jn + 3]) * qsc1) * k2.y;
    }
  };
  auto k_tile = [&](int j) { return sK + (j % STAGES) * C::K_BYTES; };
  auto v_tile = [&](int j) { return sV + (j % STAGES) * C::V_BYTES; };
  // this warp is done with tile j's K (its k scales too) or V
  auto release = [&](uint32_t empty, int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (j % STAGES));
  };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float l0 = 0.f, l1 = 0.f;

  if (n_tiles > 0) {
    const uint32_t sQw = sQ + wg * (64 * D);  // this warpgroup's rows
    uint32_t p[32];  // bf16 P of the tile whose P.V is next
    // P -> registers, and l's step (the bf16 p at D=64)
    auto take_p = [&](float (&sf)[64], float ls0, float ls1) {
      pack_p(sf, p);
      if (SUM_ROUNDED) {
        ls0 = ls1 = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const __nv_bfloat162 pr = *reinterpret_cast<__nv_bfloat162*>(&p[i]);
          const float sum = __low2float(pr) + __high2float(pr);
          if (i & 1) ls1 += sum; else ls0 += sum;
        }
      }
      l0 += ls0;
      l1 += ls1;
    };
    // The warpgroups take turns (named barriers 2 and 3, warpgroup 0
    // first) where the kv loop is long enough to pay for the hand-over; a
    // short loop (a text cross-attention's two tiles) runs them side by
    // side.
    const bool turns = n_tiles > STAGES;
    if (turns && wg == 1) bar_arrive(2, K3Q_CONSUMERS);
    mbar_wait(q_full, 0);

    if constexpr (C::OVERLAP) {
      // tile 0: scores and softmax; its P.V is issued with tile 1's Q.K^T
      {
        uint32_t sc[64];
        float sf[64], ls0, ls1;
        mbar_wait(k_full, 0);
        qk_issue_s8<D, false>(sc, sQw, k_tile(0));
        wgmma_wait<0>();
        pin(sc);
        scores(sc, sf, 0);
        release(k_empty, 0);
        if (needs_mask(0)) mask_tile<MASK>(sf, r, 0, t);
        softmax_bounded(sf, bound_log2, ls0, ls1);
        take_p(sf, ls0, ls1);
      }
      // tile j >= 1: Q.K^T of tile j and P.V of tile j - 1 issued together
      // in this warpgroup's turn, tile j's softmax under that P.V;
      // `masked` as in K4's loop
      auto step = [&](int j, auto masked) {
        uint32_t sc[64];
        float sf[64], ls0, ls1;
        mbar_wait(k_full + 8 * (j % STAGES), (j / STAGES) & 1);
        mbar_wait(v_full + 8 * ((j - 1) % STAGES), ((j - 1) / STAGES) & 1);
        if (turns) bar_sync(2 + wg, K3Q_CONSUMERS);
        qk_issue_s8<D, false>(sc, sQw, k_tile(j));
        pv_issue_bf16<D>(acc, p, v_tile(j - 1));
        if (turns) bar_arrive(3 - wg, K3Q_CONSUMERS);
        wgmma_wait<1>();  // the scores of tile j are in
        pin(sc);
        scores(sc, sf, j);
        release(k_empty, j);
        constexpr int how = decltype(masked)::value;
        if (how == MASK_ALWAYS || (how == MASK_ASK && needs_mask(j))) {
          mask_tile<MASK>(sf, r, j * BKV, t);
        }
        softmax_bounded(sf, bound_log2, ls0, ls1);
        wgmma_wait<0>();
        pin(acc);
        release(v_empty, j - 1);
        take_p(sf, ls0, ls1);
      };
      if (MASK == MASK_GENERAL) {
        for (int j = 1; j < n_tiles; ++j) step(j, How<MASK_ASK>{});
      } else {
        const int n_free = MASK == MASK_TAIL ? n_tiles - 1 : n_tiles;
        for (int j = 1; j < n_free; ++j) step(j, How<MASK_NEVER>{});
        if (MASK == MASK_TAIL && n_tiles > 1) {
          step(n_tiles - 1, How<MASK_ALWAYS>{});
        }
      }
      const int jl = n_tiles - 1;
      mbar_wait(v_full + 8 * (jl % STAGES), (jl / STAGES) & 1);
      pv_issue_bf16<D>(acc, p, v_tile(jl));
    } else {
      // one tile a step: the turn runs from the Q.K^T issue to the end of
      // the softmax, so that one warpgroup's exponentials run while the
      // other's wait for their products; the tile's P.V stays in flight
      // while the warpgroup waits for its next turn
      auto serial = [&](int j, auto masked) {
        uint32_t sc[64];
        float sf[64], ls0, ls1;
        mbar_wait(k_full + 8 * (j % STAGES), (j / STAGES) & 1);
        if (turns) bar_sync(2 + wg, K3Q_CONSUMERS);
        wgmma_wait<0>();  // the P.V of tile j - 1
        pin(acc);
        if (j > 0) release(v_empty, j - 1);
        qk_issue_s8<D, false>(sc, sQw, k_tile(j));
        wgmma_wait<0>();
        pin(sc);
        scores(sc, sf, j);
        release(k_empty, j);
        constexpr int how = decltype(masked)::value;
        if (how == MASK_ALWAYS || (how == MASK_ASK && needs_mask(j))) {
          mask_tile<MASK>(sf, r, j * BKV, t);
        }
        softmax_bounded(sf, bound_log2, ls0, ls1);
        if (turns) bar_arrive(3 - wg, K3Q_CONSUMERS);
        take_p(sf, ls0, ls1);
        mbar_wait(v_full + 8 * (j % STAGES), (j / STAGES) & 1);
        pv_issue_bf16<D>(acc, p, v_tile(j));
      };
      if (MASK == MASK_GENERAL) {
        for (int j = 0; j < n_tiles; ++j) serial(j, How<MASK_ASK>{});
      } else {
        const int n_free = MASK == MASK_TAIL ? n_tiles - 1 : n_tiles;
        for (int j = 0; j < n_free; ++j) serial(j, How<MASK_NEVER>{});
        if (MASK == MASK_TAIL) serial(n_tiles - 1, How<MASK_ALWAYS>{});
      }
    }
    wgmma_wait<0>();
    pin(acc);
  }

  // both warpgroups are done with the ring (every load issued was waited
  // for), so its V stages take the output tile
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 > 0.f ? l0 : 1.f;
  const float d1 = l1 > 0.f ? l1 : 1.f;
  bar_sync(1, K3Q_CONSUMERS);
  uint8_t* stage = base_ptr + C::V_OFF;
  const int lr = wg * 64 + warp * 16 + g;  // this thread's first row
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    const int cb = (n * 8 + t * 2) * 2;  // column bytes
    *reinterpret_cast<uint32_t*>(stage + lr * C::O_PITCH + cb) =
        pack_f(acc[4 * n] / d0, acc[4 * n + 1] / d0);
    *reinterpret_cast<uint32_t*>(stage + (lr + 8) * C::O_PITCH + cb) =
        pack_f(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
  }
  bar_sync(1, K3Q_CONSUMERS);
  constexpr int CHUNKS = DV / 8;  // 16-byte chunks a row
  bf16* ob = o + b * osb + h * osh;
#pragma unroll 4
  for (int i = threadIdx.x; i < BQ * CHUNKS; i += K3Q_CONSUMERS) {
    const int row = i / CHUNKS, c = i % CHUNKS;
    if (q0 + row < Sq) {
      *reinterpret_cast<uint4*>(ob + (q0 + row) * oss + c * 8) =
          *reinterpret_cast<const uint4*>(stage + row * C::O_PITCH + c * 16);
    }
  }
}

// ---- host side ------------------------------------------------------------------

// int8 (DV, S, H, B) with byte strides (ss, sh, sb): boxes of [128 rows x D
// bytes] (bytes past DV read as 0), the 128-byte swizzle at D=128, the
// 64-byte one at D=64
bool make_qk_map(CUtensorMap* map, const void* ptr, int D, int DV, int S,
                 int H, int B, long long ss, long long sh, long long sb) {
  const cuuint64_t dims[4] = {(cuuint64_t)DV, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const long long strides[3] = {ss, sh, sb};
  const cuuint32_t box[4] = {(cuuint32_t)D, 128, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 4, ptr, dims,
                    strides, box,
                    D == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B);
}

// V^T int8 (Spad, DV, H, B) with byte strides (row, sh, sb): boxes of [D
// rows x 128 kv bytes] (rows past DV read as 0), 128-byte swizzle
bool make_vt_map(CUtensorMap* map, const void* ptr, int D, int DV, int Spad,
                 int H, int B, long long row, long long sh, long long sb) {
  const cuuint64_t dims[4] = {(cuuint64_t)Spad, (cuuint64_t)DV,
                              (cuuint64_t)H, (cuuint64_t)B};
  const long long strides[3] = {row, sh, sb};
  const cuuint32_t box[4] = {128, (cuuint32_t)D, 1, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 4, ptr, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// bf16 V (D, S, H, B) with element strides: K1's panels of [128 x 64]
bool make_v_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
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
  const float *qsc, *ksc, *vsc;
  int B, H, Sq, Skv;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  int ks_block, nks, kv_end, causal;
  float bound_log2;
  cudaStream_t stream;
};

template <int D, bool PV8, int MASK, int DV>
int launch_instance(const Call& c) {
  CUtensorMap qmap = {}, kmap = {}, vmap = {};
  if (c.kv_end > 0) {  // with no key in sight the block loads nothing
    const int spad = (c.Skv + BKV - 1) / BKV * BKV;
    const bool ok =
        make_qk_map(&qmap, c.q, D, DV, c.Sq, c.H, c.B, c.qss, c.qsh,
                    c.qsb) &&
        make_qk_map(&kmap, c.k, D, DV, c.Skv, c.H, c.B, c.kss, c.ksh,
                    c.ksb) &&
        (PV8 ? make_vt_map(&vmap, c.v, D, DV, spad, c.H, c.B, c.vss, c.vsh,
                           c.vsb)
             : make_v_map(&vmap, c.v, DV, c.Skv, c.H, c.B, c.vss, c.vsh,
                          c.vsb));
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_int8_wgmma_kernel<D, PV8, MASK, DV>;
  constexpr int smem = K4Cfg<D, PV8>::SMEM_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c.Sq + BQ - 1) / BQ, c.H, c.B);
  kernel<<<grid, K4_THREADS, smem, c.stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(c.o), c.q_seg, c.kv_seg, c.qsc,
      c.ksc, c.vsc, c.Sq, c.Skv, c.osb, c.osh, c.oss, c.ks_block, c.nks,
      c.kv_end, c.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool PV8, int DV = D>
int launch_kind(const Call& c, int mask_kind) {
  if (mask_kind == MASK_NONE) {
    return launch_instance<D, PV8, MASK_NONE, DV>(c);
  }
  if (mask_kind == MASK_TAIL) {
    return launch_instance<D, PV8, MASK_TAIL, DV>(c);
  }
  return launch_instance<D, PV8, MASK_GENERAL, DV>(c);
}

template <int D, int MASK, int DV>
int launch_k3q(const Call& c) {
  CUtensorMap qmap = {}, kmap = {}, vmap = {};
  if (c.kv_end > 0) {  // with no key in sight the block loads nothing
    const bool ok =
        make_qk_map(&qmap, c.q, D, DV, c.Sq, c.H, c.B, c.qss, c.qsh,
                    c.qsb) &&
        make_qk_map(&kmap, c.k, D, DV, c.Skv, c.H, c.B, c.kss, c.ksh,
                    c.ksb) &&
        make_v_map(&vmap, c.v, DV, c.Skv, c.H, c.B, c.vss, c.vsh, c.vsb);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = k3q_wgmma_kernel<D, MASK, DV>;
  constexpr int smem = K3qCfg<D>::SMEM_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c.Sq + BQ - 1) / BQ, c.H, c.B);
  kernel<<<grid, K3Q_THREADS, smem, c.stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(c.o), c.q_seg, c.kv_seg, c.qsc,
      c.ksc, c.Sq, c.Skv, c.osb, c.osh, c.oss, c.nks, c.kv_end, c.causal,
      c.bound_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV = D>
int launch_k3q_kind(const Call& c, int mask_kind) {
  if (mask_kind == MASK_NONE) return launch_k3q<D, MASK_NONE, DV>(c);
  if (mask_kind == MASK_TAIL) return launch_k3q<D, MASK_TAIL, DV>(c);
  return launch_k3q<D, MASK_GENERAL, DV>(c);
}

// the call's kv_end from kv_valid; false where the mask kind masks less
// than the call needs, or segment ids come alone
bool checked(Call& c, int kv_valid, int mask_kind) {
  if (kv_valid >= 0 && kv_valid < c.kv_end) c.kv_end = kv_valid;
  int need = MASK_NONE;
  if (c.kv_end % BKV != 0) need = MASK_TAIL;
  if (c.q_seg != nullptr || c.causal) need = MASK_GENERAL;
  return mask_kind >= need && mask_kind <= MASK_GENERAL &&
         (c.q_seg == nullptr) == (c.kv_seg == nullptr);
}

}  // namespace

// q8, k8 [B, H, S, D] int8 with element strides (b, h, s); v: QK+PV tier
// V^T [B, H, D, Spad] int8 in the kernel's kv order (Spad = Skv rounded up
// to 128) with strides (b, h, d), QK tier bf16 [B, H, S, D] with strides
// (b, h, s); out bf16 with strides (b, h, s). k scales: QK+PV tier one per
// `ks_block` kv rows (a 128 multiple), nks a (b, h) row; QK tier one a kv
// row (ks_block 1) in rows of nks = Spad entries. kv_valid -1 = none;
// mask_kind 0 none, 1 tail, 2 general (ops/flash_attention.py::mask_kind);
// a kind that masks less than the call needs is refused.
extern "C" int k4_flash_attention_int8(
    const void* q, const void* k, const void* v, void* o,
    const void* q_seg, const void* kv_seg,
    const void* q_scale, const void* k_scale, const void* v_scale,
    int B, int H, int Sq, int Skv, int D,
    int qsb, int qsh, int qss, int ksb, int ksh, int kss,
    int vsb, int vsh, int vss, int osb, int osh, int oss,
    int ks_block, int nks, int kv_valid, int causal, int pv_int8,
    int mask_kind, void* stream) {
  if (Sq <= 0 || B <= 0 || H <= 0) return cudaGetLastError();
  const int spad = (Skv + BKV - 1) / BKV * BKV;
  if (pv_int8 ? (v_scale == nullptr || ks_block <= 0 || ks_block % BKV != 0)
              : (ks_block != 1 || nks != spad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Call c = {q, k, v, o, static_cast<const int*>(q_seg),
            static_cast<const int*>(kv_seg),
            static_cast<const float*>(q_scale),
            static_cast<const float*>(k_scale),
            static_cast<const float*>(v_scale), B, H, Sq, Skv,
            qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
            ks_block, nks, Skv, causal, 0.f,
            static_cast<cudaStream_t>(stream)};
  if (!checked(c, kv_valid, mask_kind)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (D == 64 && pv_int8) return launch_kind<64, true>(c, mask_kind);
  if (D == 64) return launch_kind<64, false>(c, mask_kind);
  if (D == 128 && pv_int8) return launch_kind<128, true>(c, mask_kind);
  if (D == 128) return launch_kind<128, false>(c, mask_kind);
  // a head of 80 in the D = 128 layout
  if (D == 80 && pv_int8) return launch_kind<128, true, 80>(c, mask_kind);
  if (D == 80) return launch_kind<128, false, 80>(c, mask_kind);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3q: the QK tier's operands (q8, k8 and bf16 v [B, H, S, D] with element
// strides (b, h, s), one fp32 k scale a kv row in rows of nks = Spad
// entries), out bf16 with strides (b, h, s), then bound_log2 =
// score_bound * log2(e); kv_valid and mask_kind as K4's
extern "C" int k3q_flash_attention_int8_bounded(
    const void* q, const void* k, const void* v, void* o,
    const void* q_seg, const void* kv_seg,
    const void* q_scale, const void* k_scale,
    int B, int H, int Sq, int Skv, int D,
    int qsb, int qsh, int qss, int ksb, int ksh, int kss,
    int vsb, int vsh, int vss, int osb, int osh, int oss,
    int nks, int kv_valid, int causal, int mask_kind, float bound_log2,
    void* stream) {
  if (Sq <= 0 || B <= 0 || H <= 0) return cudaGetLastError();
  const int spad = (Skv + BKV - 1) / BKV * BKV;
  Call c = {q, k, v, o, static_cast<const int*>(q_seg),
            static_cast<const int*>(kv_seg),
            static_cast<const float*>(q_scale),
            static_cast<const float*>(k_scale), nullptr, B, H, Sq, Skv,
            qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
            1, nks, Skv, causal, bound_log2,
            static_cast<cudaStream_t>(stream)};
  if (nks != spad || !std::isfinite(bound_log2) ||
      !checked(c, kv_valid, mask_kind)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (D == 64) return launch_k3q_kind<64>(c, mask_kind);
  if (D == 128) return launch_k3q_kind<128>(c, mask_kind);
  // a head of 80 in the D = 128 layout
  if (D == 80) return launch_k3q_kind<128, 80>(c, mask_kind);
  return static_cast<int>(cudaErrorInvalidValue);
}
