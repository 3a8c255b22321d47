// Attention over many short contiguous sequences for Hopper (sm_90a):
// ops/kernels/small_seq.py's ctg_packed.
//
// Replaces the Pallas TPU kernel K6 of aniportrait_tpu/ops/pallas_attention.py:
// ctg_seq_attention_pallas / _ctg_kernel (reached through ctg_packed).  Input
// is (N, seq, C) token layout, C = heads * d, with each sequence's rows
// contiguous; every (sequence, head) attends within itself.  The TPU packs
// 128 // seq sequences into one 128-row tile and masks the block diagonal;
// that packing is a layout choice of the TPU's matrix unit, and (n, g * seq, C)
// is the same memory as (n * g, seq, C), so this kernel works per sequence
// and takes any N.
//
// The contract kept from _ctg_kernel:
//   * `scale` multiplies q in q's dtype (the caller passes
//     log2(e) / sqrt(d)) and the softmax is base 2 (exp2);
//   * the float32 probabilities are summed unrounded, rounded to v's dtype
//     before the PV product, and the row is normalised after that product.
// K9 (small_seq_attention_pallas, head-folded, q pre-scaled, base e, a
// valid-row mask) differs only in those three steps: the q load, the exp and
// the column mask of the softmax loop below.
//
// What bounds it on an H100: per (sequence, head) the work is 4 * seq^2 * d
// FLOPs over 4 * seq * d elements moved (q, k, v in, o out): at seq = 16
// that is 16 FLOPs per element, ~8 per byte in bf16, far below the card's
// ~295 FLOP/byte ridge.  The kernel is bound by device memory bandwidth
// (3.35 TB/s), so its job is to read each input element once and write each
// output element once.
//
// Design against that bound: one block = one (sequence, head); consecutive
// blocks are the heads of one sequence, so a sequence's rows are read by
// neighbouring blocks at once.  q, k, v of the block are read once into
// shared memory (consecutive threads on consecutive channels), the seq x seq
// logits stay in shared memory, and the output is written once.  Rows in
// shared memory are padded to d + 1 floats (odd for the model's even head
// dims) so the logits pass reads without bank conflicts.  No cross-block
// state.
#include "common.cuh"

namespace aniportrait {
namespace {

constexpr int THREADS = 128;
constexpr int MAX_SEQ = 32;
constexpr int MAX_D = 256;

struct CtgArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int n, seq, heads, d;
  float scale;
};

inline size_t ctg_smem_floats(int seq, int d) {
  return (size_t)seq * (2 * (d + 1) + d + (seq + 1) + 1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ctg_kernel(const CtgArgs a) {
  extern __shared__ float smem[];
  const int f = a.seq, d = a.d;
  const int ldq = d + 1, lds = f + 1;
  float* sQ = smem;             // [f][ldq]  q * scale, rounded to T
  float* sK = sQ + f * ldq;     // [f][ldq]
  float* sV = sK + f * ldq;     // [f][d]
  float* sP = sV + f * d;       // [f][lds]  exp2(logit - max), rounded to T
  float* sR = sP + f * lds;     // [f]       1 / row sum

  const int seq_idx = blockIdx.x / a.heads;
  const int h = blockIdx.x - seq_idx * a.heads;
  const int c = a.heads * d;
  const size_t base = (size_t)seq_idx * f * c + (size_t)h * d;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float scale = round_as<T>(a.scale);

  const int n_el = f * d;
  for (int i = threadIdx.x; i < n_el; i += THREADS) {
    const int t = i / d;
    const int dd = i - t * d;
    const size_t off = base + (size_t)t * c + dd;
    sQ[t * ldq + dd] = round_as<T>(to_f32(q[off]) * scale);
    sK[t * ldq + dd] = to_f32(k[off]);
    sV[t * d + dd] = to_f32(v[off]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < f * f; i += THREADS) {
    const int r = i / f;
    const int j = i - r * f;
    const float* qr = sQ + r * ldq;
    const float* kr = sK + j * ldq;
    float acc = 0.f;
    for (int dd = 0; dd < d; ++dd) acc = fmaf(qr[dd], kr[dd], acc);
    sP[r * lds + j] = acc;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < f; r += THREADS) {
    float* row = sP + r * lds;
    float mx = neg_inf();
    for (int j = 0; j < f; ++j) mx = fmaxf(mx, row[j]);
    float sum = 0.f;
    for (int j = 0; j < f; ++j) {
      const float e = exp2f(row[j] - mx);
      sum += e;
      row[j] = round_as<T>(e);
    }
    sR[r] = 1.f / sum;
  }
  __syncthreads();

  T* o = static_cast<T*>(a.o);
  for (int i = threadIdx.x; i < n_el; i += THREADS) {
    const int t = i / d;
    const int dd = i - t * d;
    const float* pr = sP + t * lds;
    const float* vc = sV + dd;
    float acc = 0.f;
    for (int j = 0; j < f; ++j) acc = fmaf(pr[j], vc[j * d], acc);
    store_f32(&o[base + (size_t)t * c + dd], acc * sR[t]);
  }
}

template <typename T>
cudaError_t launch(const CtgArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = set_smem(ctg_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)a.n * a.heads;
  ctg_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace aniportrait

// q, k, v, o: (n * seq, heads * d), contiguous; rows [i * seq, (i + 1) * seq)
// are sequence i.  scale: multiplies q (base-2 softmax).  Returns a
// cudaError_t code.
extern "C" int aniportrait_ctg_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, int n, int seq, int heads, int d, float scale,
                                   void* stream) {
  using namespace aniportrait;
  if (n < 1 || seq < 1 || seq > MAX_SEQ || heads < 1 || d < 1 || d > MAX_D ||
      (long long)n * heads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CtgArgs a{q, k, v, o, n, seq, heads, d, scale};
  const size_t smem = ctg_smem_floats(seq, d) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return static_cast<int>(launch<__nv_bfloat16>(a, smem, st));
  if (dtype == kFloat32) return static_cast<int>(launch<float>(a, smem, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
