// K1f: flash attention forward in fp32 on the CUDA cores, for sm_90a.
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
// with s = (s32 * q_scale) * k_scale in the QK tier, s32 * (q_scale *
// k_scale) with per-kv-block k scales in the QK+PV tier (the int8 products
// are integers below 2**24 and exact in fp32, so the scores equal the
// plain version's bit for bit); P codes round(exp2(s - m + log2 127))
// against the running max as of each 64-row kv tile, and the pv8
// denominator sums fp32 p at D=128 and 127 * sum(P codes) * (1/127) at
// D=64, as the TPU kernel's ones column of V does. The QK+PV tier reads V
// as the prologue writes it for K4: int8 V^T [B, H, D, Spad] in K4's kv
// order inside each 32-row chunk (k4_v_layout). Masks: a static kv_valid
// tail, segment ids (attend iff q_seg == kv_seg and kv_seg > 0) and
// causal; a row that sees no key returns exactly 0. Head dims 64 and 128;
// any strides with a unit last stride, so head-split views of [B, S, H*D]
// projections and the head-packed layout of K6 are read in place.
//
// What bounds it on an H100: fp32 operands do not feed the tensor cores
// (tf32 would change the numbers), so the CUDA cores' fused multiply-adds
// bind: 4*B*H*Sq*Skv*D operations at 132 SMs x 128 lanes x 2 x the SM
// clock, about 67 TFLOP/s, 15x below bf16 on wgmma. Memory does not: every
// K/V tile serves 64 q rows and stays in L2 across the q tiles of a head.
//
// Design, simple first. One block of 256 threads = 64 q rows of one
// (batch, head). The Q tile stays in shared memory; K and V tiles of 64 kv
// rows are loaded in turn (16-byte loads, rows past S zeroed). Each thread
// holds a 4 x 4 block of the 64 x 64 scores (rows ty + 16i, columns tx +
// 16j), built from 16-byte shared-memory reads of Q and K (rows padded by
// four floats, so the eight threads of a quarter warp read eight banks
// groups), reduces its rows' max over the 16 threads of a half warp with
// shuffles, and writes p into shared memory over the K tile, which it has
// finished reading. Then each thread accumulates 4 rows x D/16 output
// columns of P.V from 16-byte reads of P and V. The online softmax keeps m
// and a per-thread share of l a row; the shares are summed at the end.
// No tf32, no wgmma, no cp.async ring: later PRs may pipeline the loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows a block
constexpr int BKV = 64;       // kv rows a tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int PST = BKV + 16; // the P tile's row stride (floats)
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;
constexpr float LOG2_127 = 6.9886846867721655f;
constexpr float SUM_COL_SCALE = 0.007874015718698502f;  // float32(1/127)

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

template <int D>
__host__ __device__ constexpr int kp_width() {  // the K tile's row stride, or P's if wider
  return (D + 4 > PST) ? D + 4 : PST;
}

template <int D>
__host__ __device__ constexpr int smem_floats() {
  return BQ * (D + 4) + BKV * kp_width<D>() + BKV * D;
}

// rows [row0, row0 + 64) of a [S, D] operand (fp32, or int8 codes as
// floats) into dst with row stride ld; rows at or past n are zero
template <int D, bool INT8>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const void* src,
                                          long long row_stride, int row0,
                                          int n) {
  constexpr int C4 = D / 4;
  for (int idx = threadIdx.x; idx < BQ * C4; idx += THREADS) {
    const int r = idx / C4, c = (idx % C4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) {
      const long long off = (long long)(row0 + r) * row_stride + c;
      if (INT8) {
        const char4 cv =
            *reinterpret_cast<const char4*>(static_cast<const int8_t*>(src) +
                                            off);
        val = make_float4((float)cv.x, (float)cv.y, (float)cv.z,
                          (float)cv.w);
      } else {
        val = *reinterpret_cast<const float4*>(
            static_cast<const float*>(src) + off);
      }
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// kv rows [j0, j0 + 64) of K4's int8 V^T [D, Spad] (d stride d_stride)
// into dst [64, D]: inside each 32-row chunk, column 16 h + 4 t + 2 a + c
// holds kv row 16 h + 8 a + 2 t + c (k4_v_layout); Spad covers the tile
template <int D>
__device__ __forceinline__ void load_vt8(float* dst, const int8_t* src,
                                         long long d_stride, int j0) {
  for (int idx = threadIdx.x; idx < D * (BKV / 4); idx += THREADS) {
    const int d = idx / (BKV / 4), x = (idx % (BKV / 4)) * 4;
    const char4 cv =
        *reinterpret_cast<const char4*>(src + d * d_stride + j0 + x);
    const signed char vals[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int xx = x + e, w = xx & 31;
      const int t = (w & 15) >> 2, a = (w & 3) >> 1, c = w & 1;
      const int j = (xx & ~31) + (w & 16) + 8 * a + 2 * t + c;
      dst[j * D + d] = (float)vals[e];
    }
  }
}

template <int NC>
__device__ __forceinline__ void fma4(float (&dst)[NC], int c, float a,
                                     float4 v) {
  dst[c + 0] = fmaf(a, v.x, dst[c + 0]);
  dst[c + 1] = fmaf(a, v.y, dst[c + 1]);
  dst[c + 2] = fmaf(a, v.z, dst[c + 2]);
  dst[c + 3] = fmaf(a, v.w, dst[c + 3]);
}

template <int D, int MASK, int VARIANT>
__global__ void __launch_bounds__(THREADS)
    flash_fp32_kernel(const Params p) {
  constexpr bool INT8_QK = VARIANT >= QK8;
  constexpr bool BOUNDED = VARIANT == BOUNDED_V || VARIANT == QK8_BOUNDED;
  constexpr bool PV_INT8 = VARIANT == PV8;
  constexpr int QST = D + 4, KST = D + 4, NC = D / 16, NV = D / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QST;
  float* Ps = Ks;  // P overwrites the K tile once every score is read
  float* Vs = Ks + BKV * kp_width<D>();

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * p.H + h;
  const char* qb = static_cast<const char*>(p.q) +
                   (b * p.qsb + h * p.qsh) * (INT8_QK ? 1 : 4);
  const char* kb = static_cast<const char*>(p.k) +
                   (b * p.ksb + h * p.ksh) * (INT8_QK ? 1 : 4);
  const char* vb = static_cast<const char*>(p.v) +
                   (b * p.vsb + h * p.vsh) * (PV_INT8 ? 1 : 4);

  load_rows<D, INT8_QK>(Qs, QST, qb, p.qss, r0, p.Sq);

  int rows[4], qseg[4];
  float qsc[4], m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rows[i] = r0 + ty + 16 * i;
    const bool in = rows[i] < p.Sq;
    qsc[i] = (INT8_QK && in) ? p.q_scale[bh * p.Sq + rows[i]] : 0.f;
    qseg[i] = (MASK == 2 && p.q_seg != nullptr && in)
                  ? p.q_seg[(long long)b * p.Sq + rows[i]]
                  : 0;
    m[i] = M_FLOOR;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  float vsc[NC];
#pragma unroll
  for (int kq = 0; kq < NV; ++kq) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      vsc[kq * 4 + e] =
          PV_INT8 ? p.v_scale[bh * D + kq * 64 + tx * 4 + e] : 0.f;
    }
  }

  int kv_hi = p.kv_end;
  if (MASK == 2 && p.causal) kv_hi = min(kv_hi, r0 + BQ);
  for (int c0 = 0; c0 < kv_hi; c0 += BKV) {
    __syncthreads();  // the previous tile's P and V are read
    load_rows<D, INT8_QK>(Ks, KST, kb, p.kss, c0, p.Skv);
    if (PV_INT8) {
      load_vt8<D>(Vs, reinterpret_cast<const int8_t*>(vb), p.vss, c0);
    } else {
      load_rows<D, false>(Vs, D, vb, p.vss, c0, p.Skv);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QST +
                                                 d0);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * KST +
                                                 d0);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qa[i].x, ka[j].x, t);
          t = fmaf(qa[i].y, ka[j].y, t);
          t = fmaf(qa[i].z, ka[j].z, t);
          t = fmaf(qa[i].w, ka[j].w, t);
          s[i][j] = t;
        }
      }
    }

    // scale, mask
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      const float ks = INT8_QK ? p.k_scale[bh * p.nks + col / p.k_block]
                               : 0.f;
      const int kseg = (MASK == 2 && p.kv_seg != nullptr && col < p.Skv)
                           ? p.kv_seg[(long long)b * p.Skv + col]
                           : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x;
        if (PV_INT8) {
          x = s[i][j] * (qsc[i] * ks);
        } else if (INT8_QK) {
          x = (s[i][j] * qsc[i]) * ks;
        } else {
          x = s[i][j] * p.scale_log2;
        }
        bool keep = true;
        if (MASK >= 1) keep = col < p.kv_end;
        if (MASK == 2) {
          if (p.q_seg != nullptr) {
            keep = keep && qseg[i] == kseg && kseg > 0;
          }
          if (p.causal) keep = keep && rows[i] >= col;
        }
        s[i][j] = keep ? x : NEG_INF;
      }
    }

    // softmax step: s becomes p (or P codes)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (BOUNDED) {
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pe = exp2f(fminf(s[i][j], p.bound_log2) - p.bound_log2);
          s[i][j] = pe;
          ls += pe;
        }
        l[i] += ls;
      } else {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        const float m_new = fmaxf(m[i], mx);
        const float alpha = exp2f(m[i] - m_new);
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (PV_INT8) {
            const float pe = exp2f(s[i][j] - (m_new - LOG2_127));
            const float p8 = rintf(pe);
            ls += (D % 128) ? p8 : pe;
            s[i][j] = p8;
          } else {
            const float pe = exp2f(s[i][j] - m_new);
            ls += pe;
            s[i][j] = pe;
          }
        }
        if (PV_INT8 && (D % 128)) ls = (ls * 127.f) * SUM_COL_SCALE;
        l[i] = alpha * l[i] + ls;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
        m[i] = m_new;
      }
    }

    __syncthreads();  // every thread has read the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * PST + tx + 16 * j] = s[i][j];
      }
    }
    __syncthreads();

    float t8[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) t8[i][c] = 0.f;
    }
#pragma unroll 2
    for (int j = 0; j < BKV; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PST +
                                                 j);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int kq = 0; kq < NV; ++kq) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (j + jj) * D + kq * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pij = jj == 0 ? pr[i].x
                              : jj == 1 ? pr[i].y
                              : jj == 2 ? pr[i].z
                                        : pr[i].w;
            if (PV_INT8) {
              fma4<NC>(t8[i], kq * 4, pij, vv);
            } else {
              fma4<NC>(acc[i], kq * 4, pij, vv);
            }
          }
        }
      }
    }
    if (PV_INT8) {  // the tile's integer P.V, then its channel scale
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += t8[i][c] * vsc[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      lt += __shfl_xor_sync(0xffffffffu, lt, o);
    }
    if (rows[i] >= p.Sq) continue;
    const float den = lt > 0.f ? lt : 1.f;
    float* orow = p.out + b * p.osb + h * p.osh + rows[i] * p.oss;
#pragma unroll
    for (int kq = 0; kq < NV; ++kq) {
      float4 o;
      o.x = acc[i][kq * 4 + 0] / den;
      o.y = acc[i][kq * 4 + 1] / den;
      o.z = acc[i][kq * 4 + 2] / den;
      o.w = acc[i][kq * 4 + 3] / den;
      *reinterpret_cast<float4*>(orow + kq * 64 + tx * 4) = o;
    }
  }
}

template <int D, int MASK, int VARIANT>
int launch(const Params& p, int B, cudaStream_t stream) {
  auto kern = flash_fp32_kernel<D, MASK, VARIANT>;
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  kern<<<grid, THREADS, smem, stream>>>(p);
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
    case 0: return by_variant<D, 0>(p, B, variant, s);
    case 1: return by_variant<D, 1>(p, B, variant, s);
    case 2: return by_variant<D, 2>(p, B, variant, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k [B, H, S, D] fp32 (variants exact, bounded) or int8 codes (qk8,
// qk8 bounded, pv8); v [B, H, Skv, D] fp32, or for pv8 int8 V^T [B, H, D,
// Spad] in K4's kv order (its strides b, h, d); out [B, H, Sq, D] fp32.
// Strides in elements, last stride 1; q_seg / kv_seg [B, S] int32 or null;
// q_scale [B, H, Sq], k_scale [B, H, nks] (one a k_block kv rows), v_scale
// [B, H, D] fp32 for the int8 variants; kv_valid -1 = none; mask_kind as
// flash_attention.MASK_KINDS; variant 0 exact, 1 bounded, 2 qk8, 3 qk8
// bounded, 4 pv8; scale_log2 = scale * log2(e) (fp32 scores; the int8
// variants carry it in q_scale), bound_log2 = score_bound * log2(e).
extern "C" int k1f_flash_attention_fp32(
    const void* q, const void* k, const void* v, void* out,
    const void* q_seg, const void* kv_seg, const void* q_scale,
    const void* k_scale, const void* v_scale, int B, int H, int Sq, int Skv,
    int D, int qsb, int qsh, int qss, int ksb, int ksh, int kss, int vsb,
    int vsh, int vss, int osb, int osh, int oss, int kv_valid, int causal,
    int mask_kind, int variant, int k_block, int nks, float scale_log2,
    float bound_log2, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  if (variant < 0 || variant > PV8 || Skv < 0 || k_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant >= QK8 && (q_scale == nullptr || k_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant == PV8 && v_scale == nullptr) {
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return by_mask<64>(p, B, mask_kind, variant, s);
  if (D == 128) return by_mask<128>(p, B, mask_kind, variant, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
