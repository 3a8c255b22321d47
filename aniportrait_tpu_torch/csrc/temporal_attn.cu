// Temporal (frame-axis) attention for Hopper (sm_90a) on natural-layout
// activations, FMA form: ops/kernels/temporal.py's nat_temporal for float32
// operands (and bf16 head dims that are not a multiple of 8, which no model
// has); bf16 otherwise runs the tensor-core form, temporal_attn_sm90.cu.  The
// C entry point at the end of this file chooses.
//
// Replaces the Pallas TPU kernel K3 of aniportrait_tpu/ops/pallas_attention.py:
// nat_temporal_attention_pallas / _nat_kernel (reached through nat_packed).
// Input is (b * f, s, c) exactly as the motion module's projections produce
// it; each (clip row, spatial position, head) is one sequence of f frames.
// The activation is never transposed in device memory.
//
// What bounds it on an H100: per sequence the work is 4 * f * f * d FLOPs
// over 4 * f * d elements moved (q, k, v in, o out): at f = 16 that is 16
// FLOPs per element, about 8 per byte in bf16, far below the card's ~295
// FLOP/byte ridge.  The kernel is bound by device memory bandwidth
// (3.35 TB/s), so its job is to read each input element once and write each
// output element once.
//
// Design against that bound:
//   * one block = one clip row, one head and a run of `sp` consecutive
//     spatial positions, all f frames of each; q, k, v of the block are read
//     once into shared memory (the entry point picks sp so that the block
//     fits in 64 KB), the f x f logits stay in shared memory, and the output
//     is written once.  Blocks are independent (no cross-block state).
//   * reads walk the head's d channels with consecutive threads on
//     consecutive addresses; rows in shared memory are padded to d + 1
//     floats (odd for the model's even head dims) so the logits pass reads
//     without bank conflicts.
//   * bf16 or float32 inputs, float32 logits and softmax, the exact
//     softmax (no bf16 rounding inside).  The kernel takes the natural
//     softmax scale; the entry point converts the JAX package's base-2
//     scale (log2(e) / sqrt(d)).
#include "common.cuh"

namespace aniportrait {

// The bf16 tensor-core form (temporal_attn_sm90.cu); scale2 is the base-2
// scale.  Needs d % 8 == 0 and 16-byte aligned operands.
cudaError_t temporal_fwd_mma(const void* q, const void* k, const void* v, void* o, int batch,
                             int frames, int s, int heads, int d, float scale2,
                             cudaStream_t stream);

namespace {

constexpr int THREADS = 256;

struct TemporalArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int batch, frames, s, heads, d, sp;
  float scale;
};

inline size_t temporal_floats_per_position(int f, int d) {
  return (size_t)f * (2 * (d + 1) + d + (f + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) temporal_kernel(const TemporalArgs a) {
  extern __shared__ float smem[];
  const int f = a.frames, d = a.d, sp = a.sp;
  const int ldq = d + 1, lds = f + 1;
  float* sQ = smem;                // [sp][f][ldq]
  float* sK = sQ + sp * f * ldq;   // [sp][f][ldq]
  float* sV = sK + sp * f * ldq;   // [sp][f][d]
  float* sS = sV + sp * f * d;     // [sp][f][lds]

  const int p0 = blockIdx.x * sp;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = a.heads * d;
  const size_t frame_stride = (size_t)a.s * c;
  const size_t base = (size_t)b * f * frame_stride + (size_t)h * d;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  const int n_el = sp * f * d;
  for (int i = threadIdx.x; i < n_el; i += blockDim.x) {
    const int dd = i % d;
    const int t = i / d;
    const int fi = t % f;
    const int pi = t / f;
    float qx = 0.f, kx = 0.f, vx = 0.f;
    if (p0 + pi < a.s) {
      const size_t off = base + fi * frame_stride + (size_t)(p0 + pi) * c + dd;
      qx = to_f32(q[off]);
      kx = to_f32(k[off]);
      vx = to_f32(v[off]);
    }
    sQ[t * ldq + dd] = qx * a.scale;
    sK[t * ldq + dd] = kx;
    sV[t * d + dd] = vx;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < sp * f * f; i += blockDim.x) {
    const int j = i % f;
    const int t = i / f;  // = pi * f + fi
    const int pi = t / f;
    const float* qr = sQ + t * ldq;
    const float* kr = sK + (pi * f + j) * ldq;
    float acc = 0.f;
    for (int dd = 0; dd < d; ++dd) acc = fmaf(qr[dd], kr[dd], acc);
    sS[t * lds + j] = acc;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < sp * f; t += blockDim.x) {
    float* row = sS + t * lds;
    float mx = neg_inf();
    for (int j = 0; j < f; ++j) mx = fmaxf(mx, row[j]);
    float sum = 0.f;
    for (int j = 0; j < f; ++j) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    const float inv = 1.f / sum;
    for (int j = 0; j < f; ++j) row[j] *= inv;
  }
  __syncthreads();

  T* o = static_cast<T*>(a.o);
  for (int i = threadIdx.x; i < n_el; i += blockDim.x) {
    const int dd = i % d;
    const int t = i / d;
    const int fi = t % f;
    const int pi = t / f;
    if (p0 + pi >= a.s) continue;
    const float* pr = sS + t * lds;
    const float* vc = sV + pi * f * d + dd;
    float acc = 0.f;
    for (int j = 0; j < f; ++j) acc = fmaf(pr[j], vc[j * d], acc);
    store_f32(&o[base + fi * frame_stride + (size_t)(p0 + pi) * c + dd], acc);
  }
}

template <typename T>
cudaError_t launch(const TemporalArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = set_smem(temporal_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + a.sp - 1) / a.sp, a.heads, a.batch);
  temporal_kernel<T><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace aniportrait

// q, k, v, o: (batch * frames, s, heads * d), contiguous.  Attention runs
// along the frame axis independently per (batch row, position, head).
// scale: the base-2 softmax scale of the JAX nat_packed contract (q times
// it, exp2).  bf16 with d % 8 == 0 runs the tensor-core form in that
// contract's rounding (temporal_attn_sm90.cu); float32, and bf16 at other
// head dims, this file's kernel on the natural scale.  Returns a
// cudaError_t code.
extern "C" int aniportrait_temporal_fwd(int dtype, const void* q, const void* k, const void* v,
                                        void* o, int batch, int frames, int s, int heads, int d,
                                        float scale, void* stream) {
  using namespace aniportrait;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && d % 8 == 0)
    return static_cast<int>(temporal_fwd_mma(q, k, v, o, batch, frames, s, heads, d, scale, st));
  constexpr size_t kBudget = 64 * 1024;
  const size_t per_pos = temporal_floats_per_position(frames, d) * sizeof(float);
  if (per_pos > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  int sp = static_cast<int>(kBudget / per_pos);
  sp = sp < 1 ? 1 : (sp > 16 ? 16 : sp);
  if (sp > s) sp = s;
  TemporalArgs a{q, k, v, o, batch, frames, s, heads, d, sp, scale * kLn2};
  const size_t smem = per_pos * sp;
  if (dtype == kBFloat16) return static_cast<int>(launch<__nv_bfloat16>(a, smem, st));
  if (dtype == kFloat32) return static_cast<int>(launch<float>(a, smem, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
