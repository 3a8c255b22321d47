// Flash-attention forward, float32 form above head dim 128: one templated
// kernel on the FMA units behind four entry points of ops/kernels/flash.py.
// The C entry points at the end of this file take both dtypes and choose the
// form by dtype and head dim: bf16 runs the tensor-core kernel of
// flash_attn_sm90.cu, float32 with d <= 128 the 3xTF32 tensor-core kernel of
// flash_attn_tf32x3_sm90.cu, float32 above 128 this kernel; all three
// compute the same function in every mode.
//
// Replaces these Pallas TPU kernels of aniportrait_tpu/ops/pallas_attention.py:
//   K1  _tok_flash_banked_impl / _tokf_banked_kernel: token-layout (B, S, C)
//       attention over two KV segments, the row's own tokens and then the
//       reference bank read at bank row b / rep, with shared accumulators.
//       The concat of the two segments is never built.
//   K2  flash_attention_tokens_unshifted / _tokf_fwd_kernel and its guard
//       fallback flash_attention_tokens / _tok_fwd_kernel: token-layout
//       self attention with heads sliced from C.  This kernel keeps a running
//       max, so it is exact without the TPU kernel's overflow guard and
//       computes what both TPU kernels return.
//   K4  _flash_nopad / _fwd_kernel_nopad: (B, S, H, D) attention, the same
//       memory as (B, S, H*D).  Rows flagged in drop_tail attend only to the
//       first kv_split columns.
//   K5a _flash_fwd_impl / _fwd_kernel with want_lse: K4 that also writes the
//       float32 log-sum-exp of every (row, head) for the backward
//       (csrc/flash_bwd.cu).  The kernel already keeps the running max m and
//       denominator l per row in registers, so the LSE is m + log(l); a fully
//       masked row gets output 0 and LSE 0, the TPU kernel's contract.
//
// and, through the softmax-mode template parameter MODE, the three fixed-shift
// token-layout kernels of the token-kernel A/B (aniportrait_tok_flash_fwd):
//   K7  flash_attention_tokens_noshift / _tokns_fwd_kernel (NOSHIFT_E): q
//       arrives multiplied by 1/sqrt(d) in its dtype, p = exp(logit) with no
//       shift, rounded to v's dtype; l sums the rounded p.
//   K8  flash_attention_tokens_bounded / _tokb_fwd_kernel (BOUNDED_2): q
//       arrives multiplied by log2(e)/sqrt(d) in its dtype, p =
//       exp2(logit - bound[row, head]) with the Cauchy-Schwarz bound an input;
//       l sums the unrounded p, PV takes p rounded to v's dtype.
//   K2  flash_attention_tokens_unshifted / _tokf_fwd_kernel in its TPU form
//       (UNSHIFTED_2): q multiplied by log2(e)/sqrt(d) in its dtype at the
//       load, p = exp2(logit); l sums the unrounded p.
// (Every rounding to an operand's dtype is the identity in float32.)  Only
// the logits stage and the epilogue differ from RUNMAX: no max, no
// rescale of the accumulator, output acc / (l == 0 ? 1 : l).  Each of these
// computes its Pallas caller's guard (a row-head is bad if l is not > 1e-30;
// for K7 and K2 also if l or one of its outputs is not finite) and ORs it,
// once per block, into an int32 flag in device memory.  The guard's fallback,
// the caller's lax.cond to the running-max kernel, is a second launch of the
// RUNMAX mode into the same output that every block leaves at once unless the
// flag is set: no host round trip, as lax.cond has none.
//
// What bounds it on an H100: at the main path's shapes (S = 4096, d = 40,
// 8 heads, 16 rows; 4096 x 8192 logits per head for K1) the work is
// 4*S*Skv*d FLOPs per head against S*d + 2*Skv*d loaded elements, far above
// the card's ~295 FLOP/byte ridge, so the kernel is compute bound.  This form
// computes on the float32 FMA units (67 TFLOP/s peak).  The float32 reference
// runs (micro pipeline, micro train step against the CPU) need float32
// products, which one TF32 tensor-core product would round to 11 bits; the
// 3xTF32 split of flash_attn_tf32x3_sm90.cu keeps ~20-21 bits on the tensor
// cores, so every float32 call the port makes (d = 40, 64, 80, 88) runs
// there, and this kernel only float32 at d > 128, which no path takes.
//
// Design against that bound and the card's differences from the TPU:
//   * one block = 64 query rows of one (batch row, head); the TPU grid's
//     sequential KV axis becomes a loop inside the block, and the online
//     softmax state (m, l, acc) lives in registers, so nothing carries over
//     between blocks, which run in any order.  At S = 4096 the grid holds
//     64 x heads x B blocks (8192 for K1), enough to fill 132 SMs.
//   * 128 threads; thread (ty, tx) owns 8 query rows x 4 KV columns of the
//     logits tile and the same 8 rows x DP/16 head columns of the output, so
//     the row statistics never leave the 16 lanes of a half warp
//     (shuffle reductions only).
//   * head dims such as 160 are not powers of two: the head tile is padded
//     in shared memory to DP = round_up(d, 16) and zero filled, loads are
//     masked, and DP is a template parameter (144 ... 256).
//   * float32 inputs (bf16 goes to flash_attn_sm90.cu, float32 at d <= 128
//     to flash_attn_tf32x3_sm90.cu), float32 accumulation and softmax; q is
//     pre-multiplied by scale * log2(e) so the softmax runs on exp2.
#include "flash_fwd.cuh"

namespace aniportrait {
namespace {

// Calls CASE(DP) for the head tile DP = round_up(d, 16) in 144 ... 256, the
// FMA form's head dims, and returns cudaErrorInvalidValue for any other d.
#define ANIPORTRAIT_FMA_HEAD_DIM_SWITCH(d, CASE) \
  switch (((d) + 15) / 16) {                     \
    case 9: CASE(144)                            \
    case 10: CASE(160)                           \
    case 11: CASE(176)                           \
    case 12: CASE(192)                           \
    case 13: CASE(208)                           \
    case 14: CASE(224)                           \
    case 15: CASE(240)                           \
    case 16: CASE(256)                           \
    default: return cudaErrorInvalidValue;       \
  }

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;
constexpr int LDQ = BQ + 4;   // q tile stored transposed: [DP][LDQ]
constexpr int LDK = BKV + 4;  // k tile stored transposed: [DP][LDK]
constexpr int LDP = BQ + 4;   // probabilities stored transposed: [BKV][LDP]

template <int DP>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (DP * LDQ + DP * LDK + BKV * DP + BKV * LDP);
}

template <int DP, int MODE, bool LSE>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const FlashArgs a) {
  static_assert(MODE == RUNMAX || !LSE, "the LSE is a RUNMAX output");
  constexpr int DPT = DP / 16;
  if (MODE == RUNMAX && a.pred != nullptr && *a.pred == 0) return;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + DP * LDQ;
  float* sV = sK + DP * LDK;
  float* sP = sV + BKV * DP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d = a.d;
  const int ld = a.heads * d;

  const float* q = static_cast<const float*>(a.q) + (size_t)b * a.sq * ld + h * d;
  const float q_mult = a.scale_log2;
  for (int i = tid; i < BQ * DP; i += THREADS) {
    const int r = i / DP;
    const int c = i - r * DP;
    float x = 0.f;
    if (q0 + r < a.sq && c < d) {
      x = q[(size_t)(q0 + r) * ld + c];
      if (MODE == RUNMAX || MODE == UNSHIFTED_2) x *= q_mult;
    }
    sQ[c * LDQ + r] = x;
  }

  float m[8], l[8], acc[8][DPT], bnd[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
    bnd[i] = 0.f;
    const int r = q0 + ty * 8 + i;
    if (MODE == BOUNDED_2 && r < a.sq) bnd[i] = a.bound[((size_t)b * a.sq + r) * a.heads + h];
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int seg = 0; seg < 2; ++seg) {
    const float* kp;
    const float* vp;
    int len;
    if (seg == 0) {
      kp = static_cast<const float*>(a.k) + (size_t)b * a.skv * ld + h * d;
      vp = static_cast<const float*>(a.v) + (size_t)b * a.skv * ld + h * d;
      len = (a.drop != nullptr && a.drop[b] != 0) ? a.kv_split : a.skv;
    } else {
      if (a.kb == nullptr) break;
      const int bb = b / a.rep;
      kp = static_cast<const float*>(a.kb) + (size_t)bb * a.sbank * ld + h * d;
      vp = static_cast<const float*>(a.vb) + (size_t)bb * a.sbank * ld + h * d;
      len = a.sbank;
    }
    for (int k0 = 0; k0 < len; k0 += BKV) {
      __syncthreads();  // the previous tile's readers are done (and sQ is written)
      for (int i = tid; i < BKV * DP; i += THREADS) {
        const int r = i / DP;
        const int c = i - r * DP;
        float kx = 0.f, vx = 0.f;
        if (k0 + r < len && c < d) {
          const size_t off = (size_t)(k0 + r) * ld + c;
          kx = kp[off];
          vx = vp[off];
        }
        sK[c * LDK + r] = kx;
        sV[r * DP + c] = vx;
      }
      __syncthreads();

      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int c = 0; c < d; ++c) {
        const float4 qa = *reinterpret_cast<const float4*>(&sQ[c * LDQ + ty * 8]);
        const float4 qb = *reinterpret_cast<const float4*>(&sQ[c * LDQ + ty * 8 + 4]);
        const float4 kk = *reinterpret_cast<const float4*>(&sK[c * LDK + tx * 4]);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }

      const int nvalid = len - k0;  // >= 1: column 0 of the tile is valid
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (tx * 4 + j >= nvalid) {
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i][j] = neg_inf();
        }
      }

      if (MODE == RUNMAX) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[i], mx);  // finite: the row sees column 0
          const float alpha = exp2f(m[i] - m_new);
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = exp2f(s[i][j] - m_new);
            s[i][j] = p;
            rs += p;
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
          l[i] = l[i] * alpha + rs;
          m[i] = m_new;
#pragma unroll
          for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
        }
      } else {
        // a fixed shift: p depends on this tile alone; masked columns
        // (-inf) give p = 0
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float x = MODE == BOUNDED_2 ? s[i][j] - bnd[i] : s[i][j];
            const float p = MODE == NOSHIFT_E ? expf(x) : exp2f(x);
            rs += p;
            s[i][j] = p;
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
          l[i] += rs;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) sP[(tx * 4 + j) * LDP + ty * 8 + i] = s[i][j];
      __syncthreads();

      const int jmax = nvalid < BKV ? nvalid : BKV;
      for (int j = 0; j < jmax; ++j) {
        const float4 pa = *reinterpret_cast<const float4*>(&sP[j * LDP + ty * 8]);
        const float4 pb = *reinterpret_cast<const float4*>(&sP[j * LDP + ty * 8 + 4]);
        const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const float vv = sV[j * DP + tx * DPT + c];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

  float* o = static_cast<float*>(a.o) + (size_t)b * a.sq * ld + h * d;
  bool bad = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty * 8 + i;
    if (r >= a.sq) continue;
    if (MODE != RUNMAX) {
      // the guard of the Pallas caller; !(l > 1e-30) also catches NaN
      bad |= !(l[i] > 1e-30f);
      if (MODE != BOUNDED_2) bad |= !isfinite(l[i]);
      const float safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int col = tx * DPT + c;
        if (col >= d) continue;
        const float x = acc[i][c] / safe;
        // K7 and K2u test the output (stored as computed in float32)
        if (MODE == NOSHIFT_E || MODE == UNSHIFTED_2) bad |= !isfinite(x);
        o[(size_t)r * ld + col] = x;
      }
      continue;
    }
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    if (LSE && tx == 0) {
      // m is in base-2 units (q carries log2(e)): lse = ln 2 * (m + log2 l)
      a.lse[((size_t)b * a.heads + h) * a.sq + r] =
          l[i] > 0.f ? kLn2 * (m[i] + log2f(l[i])) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx * DPT + c;
      if (col < d) o[(size_t)r * ld + col] = acc[i][c] * inv;
    }
  }
  if (MODE != RUNMAX) {
    if (__syncthreads_or(bad) && tid == 0) atomicOr(a.guard, 1);
  }
}

template <int DP, int MODE, bool LSE>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<DP>();
  cudaError_t err = set_smem(flash_fwd_kernel<DP, MODE, LSE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.heads, a.batch);
  flash_fwd_kernel<DP, MODE, LSE><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_lse(const FlashArgs& a, cudaStream_t stream) {
  return a.lse != nullptr ? launch<DP, RUNMAX, true>(a, stream)
                          : launch<DP, RUNMAX, false>(a, stream);
}

cudaError_t dispatch(const FlashArgs& a, cudaStream_t stream) {
#define ANIPORTRAIT_CASE(DP) return launch_lse<DP>(a, stream);
  ANIPORTRAIT_FMA_HEAD_DIM_SWITCH(a.d, ANIPORTRAIT_CASE)
#undef ANIPORTRAIT_CASE
}

// The fixed-shift mode into `fast.o`, then the guard's fallback: RUNMAX into
// the same output, predicated on the flag the first launch sets.
template <int DP>
cudaError_t launch_tok(int mode, const FlashArgs& fast, const FlashArgs& fallback,
                       cudaStream_t stream) {
  cudaError_t err;
  if (mode == NOSHIFT_E) err = launch<DP, NOSHIFT_E, false>(fast, stream);
  else if (mode == BOUNDED_2) err = launch<DP, BOUNDED_2, false>(fast, stream);
  else if (mode == UNSHIFTED_2) err = launch<DP, UNSHIFTED_2, false>(fast, stream);
  else return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return launch<DP, RUNMAX, false>(fallback, stream);
}

cudaError_t dispatch_tok(int mode, const FlashArgs& fast, const FlashArgs& fallback,
                         cudaStream_t stream) {
#define ANIPORTRAIT_CASE(DP) return launch_tok<DP>(mode, fast, fallback, stream);
  ANIPORTRAIT_FMA_HEAD_DIM_SWITCH(fast.d, ANIPORTRAIT_CASE)
#undef ANIPORTRAIT_CASE
}

}  // namespace
}  // namespace aniportrait

// q, k, v, o: (batch, S, heads * d) token layout, contiguous.
// kb, vb: (batch / rep, sbank, heads * d) or null (no bank segment).
// drop: (batch,) int32 or null; flagged rows attend to keys [0, kv_split).
// lse: (batch, heads, sq) float32 or null (not written).
// scale: the natural softmax scale.  Returns a cudaError_t code.
extern "C" int aniportrait_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                                     const void* kb, const void* vb, const void* drop, void* o,
                                     void* lse, int batch, int sq, int skv, int sbank, int heads,
                                     int d, int rep, int kv_split, float scale, void* stream) {
  using namespace aniportrait;
  FlashArgs a{q, k, v, kb, vb, static_cast<const int32_t*>(drop), o,
              static_cast<float*>(lse), batch, sq, skv, sbank, heads, d, rep, kv_split,
              scale * kLog2e, nullptr, nullptr, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return static_cast<int>(flash_fwd_sm90(a, RUNMAX, st));
  if (dtype == kFloat32 && d <= kTf32x3MaxHeadDim)
    return static_cast<int>(flash_fwd_tf32x3(a, RUNMAX, st));
  if (dtype == kFloat32) return static_cast<int>(dispatch(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7 / K8 / K2's TPU form (mode 1 / 2 / 3) with the guard and its fallback.
// q, k, v, o: (batch, S, heads * d) token layout, contiguous.  qs: q as the
// mode reads it (modes 1, 2: pre-scaled by the caller; mode 3: q itself,
// multiplied by q_scale, rounded to q's dtype, in the kernel).  bound:
// (batch, sq, heads) float32 (mode 2) or null.  guard: one int32, zero on
// entry; left nonzero if the fast path's guard tripped, in which case o holds
// the running-max result computed from q with the natural softmax `scale`.
extern "C" int aniportrait_tok_flash_fwd(int dtype, int mode, const void* q, const void* qs,
                                         const void* k, const void* v, const void* bound,
                                         void* o, void* guard, int batch, int sq, int skv,
                                         int heads, int d, float scale, float q_scale,
                                         void* stream) {
  using namespace aniportrait;
  if (mode < NOSHIFT_E || mode > UNSHIFTED_2 || (mode == BOUNDED_2 && bound == nullptr) ||
      guard == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t* flag = static_cast<int32_t*>(guard);
  const FlashArgs fast{qs, k, v, nullptr, nullptr, nullptr, o, nullptr, batch, sq, skv, 0,
                       heads, d, 1, 0, q_scale, static_cast<const float*>(bound), flag,
                       nullptr};
  const FlashArgs fallback{q, k, v, nullptr, nullptr, nullptr, o, nullptr, batch, sq, skv, 0,
                           heads, d, 1, 0, scale * kLog2e, nullptr, nullptr, flag};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    // the fixed-shift launch, then the guard's predicated running-max one
    cudaError_t err = flash_fwd_sm90(fast, mode, st);
    return static_cast<int>(err != cudaSuccess ? err : flash_fwd_sm90(fallback, RUNMAX, st));
  }
  if (dtype == kFloat32 && d <= kTf32x3MaxHeadDim) {
    cudaError_t err = flash_fwd_tf32x3(fast, mode, st);
    return static_cast<int>(err != cudaSuccess ? err : flash_fwd_tf32x3(fallback, RUNMAX, st));
  }
  if (dtype == kFloat32) return static_cast<int>(dispatch_tok(mode, fast, fallback, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
