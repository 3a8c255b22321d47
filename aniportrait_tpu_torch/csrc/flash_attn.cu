// Flash-attention forward for Hopper (sm_90a): one templated kernel behind
// three entry points of ops/kernels/flash.py.
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
//
// What bounds it on an H100: at the main path's shapes (S = 4096, d = 40,
// 8 heads, 16 rows; 4096 x 8192 logits per head for K1) the work is
// 4*S*Skv*d FLOPs per head against S*d + 2*Skv*d loaded elements, far above
// the card's ~295 FLOP/byte ridge, so the kernel is compute bound.  This first
// version computes on the float32 FMA units (67 TFLOP/s peak), not the tensor
// cores (989 TFLOP/s bf16); moving QK^T and PV onto mma.sync/wgmma is the
// next step and the reason it is written as two tile products.
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
//   * head dims 40, 80, 88, 160 are not powers of two: the head tile is
//     padded in shared memory to DP = round_up(d, 16) and zero filled, loads
//     are masked, and DP is a template parameter (16 ... 256).
//   * bf16 or float32 inputs, float32 accumulation and softmax; q is
//     pre-multiplied by scale * log2(e) so the softmax runs on exp2.
#include "common.cuh"

namespace aniportrait {
namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;
constexpr int LDQ = BQ + 4;   // q tile stored transposed: [DP][LDQ]
constexpr int LDK = BKV + 4;  // k tile stored transposed: [DP][LDK]
constexpr int LDP = BQ + 4;   // probabilities stored transposed: [BKV][LDP]

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* kb;       // bank keys (B / rep, sbank, C) or nullptr
  const void* vb;
  const int32_t* drop;  // (B,) drop_tail flags or nullptr
  void* o;
  int batch, sq, skv, sbank, heads, d, rep, kv_split;
  float scale_log2;
};

template <int DP>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (DP * LDQ + DP * LDK + BKV * DP + BKV * LDP);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const FlashArgs a) {
  constexpr int DPT = DP / 16;
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

  const T* q = static_cast<const T*>(a.q) + (size_t)b * a.sq * ld + h * d;
  for (int i = tid; i < BQ * DP; i += THREADS) {
    const int r = i / DP;
    const int c = i - r * DP;
    float x = 0.f;
    if (q0 + r < a.sq && c < d) x = to_f32(q[(size_t)(q0 + r) * ld + c]) * a.scale_log2;
    sQ[c * LDQ + r] = x;
  }

  float m[8], l[8], acc[8][DPT];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int seg = 0; seg < 2; ++seg) {
    const T* kp;
    const T* vp;
    int len;
    if (seg == 0) {
      kp = static_cast<const T*>(a.k) + (size_t)b * a.skv * ld + h * d;
      vp = static_cast<const T*>(a.v) + (size_t)b * a.skv * ld + h * d;
      len = (a.drop != nullptr && a.drop[b] != 0) ? a.kv_split : a.skv;
    } else {
      if (a.kb == nullptr) break;
      const int bb = b / a.rep;
      kp = static_cast<const T*>(a.kb) + (size_t)bb * a.sbank * ld + h * d;
      vp = static_cast<const T*>(a.vb) + (size_t)bb * a.sbank * ld + h * d;
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
          kx = to_f32(kp[off]);
          vx = to_f32(vp[off]);
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

  T* o = static_cast<T*>(a.o) + (size_t)b * a.sq * ld + h * d;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + ty * 8 + i;
    if (r >= a.sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = tx * DPT + c;
      if (col < d) store_f32(&o[(size_t)r * ld + col], acc[i][c] * inv);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const FlashArgs& a, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<DP>();
  cudaError_t err = set_smem(flash_fwd_kernel<T, DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.heads, a.batch);
  flash_fwd_kernel<T, DP><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const FlashArgs& a, cudaStream_t stream) {
  switch ((a.d + 15) / 16) {
    case 1: return launch<T, 16>(a, stream);
    case 2: return launch<T, 32>(a, stream);
    case 3: return launch<T, 48>(a, stream);
    case 4: return launch<T, 64>(a, stream);
    case 5: return launch<T, 80>(a, stream);
    case 6: return launch<T, 96>(a, stream);
    case 7: return launch<T, 112>(a, stream);
    case 8: return launch<T, 128>(a, stream);
    case 9: return launch<T, 144>(a, stream);
    case 10: return launch<T, 160>(a, stream);
    case 11: return launch<T, 176>(a, stream);
    case 12: return launch<T, 192>(a, stream);
    case 13: return launch<T, 208>(a, stream);
    case 14: return launch<T, 224>(a, stream);
    case 15: return launch<T, 240>(a, stream);
    case 16: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace aniportrait

// q, k, v, o: (batch, S, heads * d) token layout, contiguous.
// kb, vb: (batch / rep, sbank, heads * d) or null (no bank segment).
// drop: (batch,) int32 or null; flagged rows attend to keys [0, kv_split).
// scale: the natural softmax scale.  Returns a cudaError_t code.
extern "C" int aniportrait_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                                     const void* kb, const void* vb, const void* drop, void* o,
                                     int batch, int sq, int skv, int sbank, int heads, int d,
                                     int rep, int kv_split, float scale, void* stream) {
  using namespace aniportrait;
  FlashArgs a{q, k, v, kb, vb, static_cast<const int32_t*>(drop), o,
              batch, sq, skv, sbank, heads, d, rep, kv_split,
              scale * 1.4426950408889634f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return static_cast<int>(dispatch<__nv_bfloat16>(a, st));
  if (dtype == kFloat32) return static_cast<int>(dispatch<float>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
