// Flash-attention backward for Hopper (sm_90a): two kernels behind
// flash_attention_bwd of ops/kernels/flash.py.
//
// Replaces K5b of aniportrait_tpu/ops/pallas_attention.py, the two Pallas
// kernels of _flash_bwd_kernels: _dq_kernel (dq) and _dkv_kernel (dk, dv).
// Both recompute the probabilities from the forward's float32 log-sum-exp
// (K5a, csrc/flash_attn.cu) instead of storing them:
//   s  = q k^T * scale  (masked: drop_tail rows ignore keys >= kv_split)
//   p  = exp(s - lse)
//   dp = do v^T
//   ds = p * (dp - delta) * scale,  delta = rowsum(do * o) (a torch reduction
//        in the wrapper, as on the TPU where it is XLA outside the kernels)
//   dq = ds k,  dk = ds^T q,  dv = p^T do.
// As on the TPU, p and ds are rounded to the operand dtype before the
// products that take them (pallas_attention.py:148, :191, :199).
//
// What bounds it on an H100: five products of 2 * Sq * Skv * d FLOPs per
// (row, head), 2.5x the forward's work; this split recomputes s and dp in
// both kernels, 3.5x.  At the training shapes (Sq = 4096, Skv = 8192,
// d = 40) that is far above the ~295 FLOP/byte ridge: compute bound.  Like
// the forward, this first version runs on the float32 FMA units, not the
// tensor cores; mma.sync/wgmma is the next step.
//
// Design against the card's differences from the TPU:
//   * the TPU's sequential grid axis (KV tiles for dq, q tiles for dk/dv)
//     becomes a loop inside the block, and the accumulators live in
//     registers, so blocks run in any order and nothing carries over.
//   * natural (B, S, H, D) layout, read in place: no head fold, and the
//     head dim is padded only in shared memory to DP = round_up(d, 16).
//   * 128 threads; thread (ty, tx) owns RQ = BQ / 8 rows and BKV / 16
//     columns of the logits tile, and accumulator columns c = cc * 16 + tx.
//     BQ = BKV = 64 up to DP = 128, 32 above, so the five tiles fit the
//     227 KB of shared memory a block may use.
//   * q (dq kernel) or k (dk/dv kernel) is pre-multiplied by
//     scale * log2(e), and lse by log2(e), so p is one exp2.
#include "common.cuh"

namespace aniportrait {
namespace {

constexpr int THREADS = 128;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // (B, heads, sq)
  const float* delta;   // (B, heads, sq)
  const int32_t* drop;  // (B,) or nullptr
  void* dq;
  void* dk;
  void* dv;
  int batch, sq, skv, heads, d, kv_split;
  float scale;  // natural softmax scale
};

template <int DP>
struct Tiles {
  static constexpr int BQ = DP <= 128 ? 64 : 32;
  static constexpr int BKV = BQ;
  static constexpr int LDQ = BQ + 4;
  static constexpr int LDK = BKV + 4;
};

__device__ __forceinline__ int kv_len(const BwdArgs& a, int b) {
  return (a.drop != nullptr && a.drop[b] != 0) ? a.kv_split : a.skv;
}

// dq: one block = BQ query rows of one (batch row, head), walking the KV tiles.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const BwdArgs a) {
  using TL = Tiles<DP>;
  constexpr int BQ = TL::BQ, BKV = TL::BKV, LDQ = TL::LDQ, LDK = TL::LDK;
  constexpr int RQ = BQ / 8;    // rows per thread
  constexpr int CJ = BKV / 16;  // logit columns per thread
  constexpr int DPT = DP / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [DP][LDQ]  q * scale * log2e, transposed
  float* sDO = sQ + DP * LDQ;    // [DP][LDQ]  do, transposed
  float* sK = sDO + DP * LDQ;    // [DP][LDK]  k, transposed
  float* sV = sK + DP * LDK;     // [DP][LDK]  v, transposed
  float* sDS = sV + DP * LDK;    // [BKV][LDQ] ds, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d = a.d;
  const int ld = a.heads * d;
  const float scale_log2 = a.scale * kLog2e;

  const size_t qoff = (size_t)b * a.sq * ld + h * d;
  const T* q = static_cast<const T*>(a.q) + qoff;
  const T* dout = static_cast<const T*>(a.dout) + qoff;
  for (int i = tid; i < BQ * DP; i += THREADS) {
    const int r = i / DP;
    const int c = i - r * DP;
    float qx = 0.f, dx = 0.f;
    if (q0 + r < a.sq && c < d) {
      const size_t off = (size_t)(q0 + r) * ld + c;
      qx = to_f32(q[off]) * scale_log2;
      dx = to_f32(dout[off]);
    }
    sQ[c * LDQ + r] = qx;
    sDO[c * LDQ + r] = dx;
  }
  float lse2[RQ], delta[RQ], acc[RQ][DPT];
  const size_t stat = ((size_t)b * a.heads + h) * a.sq;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty * RQ + i;
    lse2[i] = r < a.sq ? a.lse[stat + r] * kLog2e : 0.f;
    delta[i] = r < a.sq ? a.delta[stat + r] : 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  const int len = kv_len(a, b);
  const size_t koff = (size_t)b * a.skv * ld + h * d;
  const T* kp = static_cast<const T*>(a.k) + koff;
  const T* vp = static_cast<const T*>(a.v) + koff;
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
      sV[c * LDK + r] = vx;
    }
    __syncthreads();

    float s[RQ][CJ], dp[RQ][CJ];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RQ], dv[RQ], kv[CJ], vv[CJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = sQ[c * LDQ + ty * RQ + i];
        dv[i] = sDO[c * LDQ + ty * RQ + i];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kv[j] = sK[c * LDK + tx * CJ + j];
        vv[j] = sV[c * LDK + tx * CJ + j];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const bool valid = k0 + tx * CJ + j < len;
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = valid ? exp2f(s[i][j] - lse2[i]) : 0.f;
        sDS[(tx * CJ + j) * LDQ + ty * RQ + i] =
            round_as<T>(p * (dp[i][j] - delta[i]) * a.scale);
      }
    }
    __syncthreads();

    const int jmax = len - k0 < BKV ? len - k0 : BKV;
    for (int j = 0; j < jmax; ++j) {
      float dsv[RQ], kv[DPT];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = sDS[j * LDQ + ty * RQ + i];
#pragma unroll
      for (int c = 0; c < DPT; ++c) kv[c] = sK[(c * 16 + tx) * LDK + j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  T* dq = static_cast<T*>(a.dq) + qoff;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty * RQ + i;
    if (r >= a.sq) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = c * 16 + tx;
      if (col < d) store_f32(&dq[(size_t)r * ld + col], acc[i][c]);
    }
  }
}

// dk, dv: one block = BKV key rows of one (batch row, head), walking the
// query tiles.  Keys a drop_tail row never sees get zero gradients.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(const BwdArgs a) {
  using TL = Tiles<DP>;
  constexpr int BQ = TL::BQ, BKV = TL::BKV, LDQ = TL::LDQ, LDK = TL::LDK;
  constexpr int RJ = BKV / 8;   // key rows per thread
  constexpr int CI = BQ / 16;   // logit (query) columns per thread
  constexpr int DPT = DP / 16;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* sK = smem;              // [DP][LDK]  k * scale * log2e, transposed
  float* sV = sK + DP * LDK;     // [DP][LDK]  v, transposed
  float* sQ = sV + DP * LDK;     // [DP][LDQ]  q, transposed
  float* sDO = sQ + DP * LDQ;    // [DP][LDQ]  do, transposed
  float* sP = sDO + DP * LDQ;    // [BQ][LDK]  p
  float* sDS = sP + BQ * LDK;    // [BQ][LDK]  ds
  float* sL = sDS + BQ * LDK;    // [BQ] lse * log2e
  float* sD = sL + BQ;           // [BQ] delta

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d = a.d;
  const int ld = a.heads * d;
  const int len = kv_len(a, b);
  const float scale_log2 = a.scale * kLog2e;

  const size_t koff = (size_t)b * a.skv * ld + h * d;
  float dk[RJ][DPT], dv[RJ][DPT];
#pragma unroll
  for (int j = 0; j < RJ; ++j)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk[j][c] = dv[j][c] = 0.f;

  if (k0 < len) {
    const T* kp = static_cast<const T*>(a.k) + koff;
    const T* vp = static_cast<const T*>(a.v) + koff;
    for (int i = tid; i < BKV * DP; i += THREADS) {
      const int r = i / DP;
      const int c = i - r * DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < len && c < d) {
        const size_t off = (size_t)(k0 + r) * ld + c;
        kx = to_f32(kp[off]) * scale_log2;
        vx = to_f32(vp[off]);
      }
      sK[c * LDK + r] = kx;
      sV[c * LDK + r] = vx;
    }
    const size_t qoff = (size_t)b * a.sq * ld + h * d;
    const T* q = static_cast<const T*>(a.q) + qoff;
    const T* dout = static_cast<const T*>(a.dout) + qoff;
    const size_t stat = ((size_t)b * a.heads + h) * a.sq;
    for (int q0 = 0; q0 < a.sq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done (and sK is written)
      for (int i = tid; i < BQ * DP; i += THREADS) {
        const int r = i / DP;
        const int c = i - r * DP;
        float qx = 0.f, dx = 0.f;
        if (q0 + r < a.sq && c < d) {
          const size_t off = (size_t)(q0 + r) * ld + c;
          qx = to_f32(q[off]);
          dx = to_f32(dout[off]);
        }
        sQ[c * LDQ + r] = qx;
        sDO[c * LDQ + r] = dx;
      }
      for (int r = tid; r < BQ; r += THREADS) {
        const bool in = q0 + r < a.sq;
        sL[r] = in ? a.lse[stat + q0 + r] * kLog2e : 0.f;
        sD[r] = in ? a.delta[stat + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[RJ][CI], dp[RJ][CI];
#pragma unroll
      for (int j = 0; j < RJ; ++j)
#pragma unroll
        for (int i = 0; i < CI; ++i) s[j][i] = dp[j][i] = 0.f;
      for (int c = 0; c < d; ++c) {
        float kv[RJ], vv[RJ], qv[CI], dov[CI];
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          kv[j] = sK[c * LDK + ty * RJ + j];
          vv[j] = sV[c * LDK + ty * RJ + j];
        }
#pragma unroll
        for (int i = 0; i < CI; ++i) {
          qv[i] = sQ[c * LDQ + tx * CI + i];
          dov[i] = sDO[c * LDQ + tx * CI + i];
        }
#pragma unroll
        for (int j = 0; j < RJ; ++j)
#pragma unroll
          for (int i = 0; i < CI; ++i) {
            s[j][i] = fmaf(kv[j], qv[i], s[j][i]);
            dp[j][i] = fmaf(vv[j], dov[i], dp[j][i]);
          }
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const bool kvalid = k0 + ty * RJ + j < len;
#pragma unroll
        for (int i = 0; i < CI; ++i) {
          const int qi = tx * CI + i;
          const float p = (kvalid && q0 + qi < a.sq) ? exp2f(s[j][i] - sL[qi]) : 0.f;
          sP[qi * LDK + ty * RJ + j] = round_as<T>(p);
          sDS[qi * LDK + ty * RJ + j] = round_as<T>(p * (dp[j][i] - sD[qi]) * a.scale);
        }
      }
      __syncthreads();

      const int imax = a.sq - q0 < BQ ? a.sq - q0 : BQ;
      for (int i = 0; i < imax; ++i) {
        float pv[RJ], dsv[RJ], qv[DPT], dov[DPT];
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          pv[j] = sP[i * LDK + ty * RJ + j];
          dsv[j] = sDS[i * LDK + ty * RJ + j];
        }
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          qv[c] = sQ[(c * 16 + tx) * LDQ + i];
          dov[c] = sDO[(c * 16 + tx) * LDQ + i];
        }
#pragma unroll
        for (int j = 0; j < RJ; ++j)
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            dv[j][c] = fmaf(pv[j], dov[c], dv[j][c]);
            dk[j][c] = fmaf(dsv[j], qv[c], dk[j][c]);
          }
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk) + koff;
  T* dvp = static_cast<T*>(a.dv) + koff;
#pragma unroll
  for (int j = 0; j < RJ; ++j) {
    const int r = k0 + ty * RJ + j;
    if (r >= a.skv) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int col = c * 16 + tx;
      if (col < d) {
        store_f32(&dkp[(size_t)r * ld + col], dk[j][c]);
        store_f32(&dvp[(size_t)r * ld + col], dv[j][c]);
      }
    }
  }
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  using TL = Tiles<DP>;
  return sizeof(float) * (2 * DP * TL::LDQ + 2 * DP * TL::LDK + TL::BKV * TL::LDQ);
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  using TL = Tiles<DP>;
  return sizeof(float) *
         (2 * DP * TL::LDK + 2 * DP * TL::LDQ + 2 * TL::BQ * TL::LDK + 2 * TL::BQ);
}

template <typename T, int DP>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  using TL = Tiles<DP>;
  static_assert(dq_smem_bytes<DP>() <= 232448 && dkv_smem_bytes<DP>() <= 232448,
                "backward tiles exceed the shared memory of a block");
  constexpr size_t smem_dq = dq_smem_bytes<DP>();
  constexpr size_t smem_dkv = dkv_smem_bytes<DP>();
  cudaError_t err = set_smem(flash_bwd_dq_kernel<T, DP>, smem_dq);
  if (err != cudaSuccess) return err;
  err = set_smem(flash_bwd_dkv_kernel<T, DP>, smem_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.sq + TL::BQ - 1) / TL::BQ, a.heads, a.batch);
  flash_bwd_dq_kernel<T, DP><<<grid_q, THREADS, smem_dq, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((a.skv + TL::BKV - 1) / TL::BKV, a.heads, a.batch);
  flash_bwd_dkv_kernel<T, DP><<<grid_kv, THREADS, smem_dkv, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const BwdArgs& a, cudaStream_t stream) {
#define ANIPORTRAIT_CASE(DP) return launch<T, DP>(a, stream);
  ANIPORTRAIT_HEAD_DIM_SWITCH(a.d, ANIPORTRAIT_CASE)
#undef ANIPORTRAIT_CASE
}

}  // namespace
}  // namespace aniportrait

// q, dout, dq: (batch, sq, heads * d); k, v, dk, dv: (batch, skv, heads * d),
// all contiguous in the operand dtype.  lse, delta: (batch, heads, sq)
// float32.  drop: (batch,) int32 or null; flagged rows attend to keys
// [0, kv_split).  scale: the natural softmax scale.  Returns a cudaError_t
// code.
extern "C" int aniportrait_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* drop, void* dq, void* dk, void* dv, int batch,
                                     int sq, int skv, int heads, int d, int kv_split, float scale,
                                     void* stream) {
  using namespace aniportrait;
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<const int32_t*>(drop), dq, dk, dv, batch, sq, skv, heads, d, kv_split,
            scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return static_cast<int>(dispatch<__nv_bfloat16>(a, st));
  if (dtype == kFloat32) return static_cast<int>(dispatch<float>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
