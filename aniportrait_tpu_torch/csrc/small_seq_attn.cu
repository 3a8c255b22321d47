// Attention over many short contiguous sequences for Hopper (sm_90a), FMA
// form: ops/kernels/small_seq.py's ctg_packed (K6) and ssa_packed (K9) for
// float32 operands (and bf16 head dims that are not a multiple of 8, which
// no model has); bf16 otherwise runs the tensor-core form,
// small_seq_attn_sm90.cu.  The C entry points at the end of this file
// choose.
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
//
// And K9: small_seq_attention_pallas / _small_seq_kernel (reached through
// ssa_packed), the head-folded form.  Input is (n, T, dp) tiles, T <= 128
// rows of one head each, cut into groups of `seq` rows (the last group of a
// tile is shorter when T % seq != 0).  Row r attends column c iff both lie
// in one group and (c < n_valid_rows or r >= n_valid_rows): rows from
// n_valid_rows on are dead padding that attends within its group.  The
// contract kept from _small_seq_kernel differs from K6's in four steps:
// q arrives pre-scaled (no multiply), the exponent is base e, masked logits
// give p = 0 (the TPU's -1e9 underflows exactly), and p is normalised by its
// row sum *before* it is rounded to v's dtype for the PV product.
//
// What bounds it on an H100: per (sequence, head) the work is 4 * seq^2 * d
// FLOPs over 4 * seq * d elements moved (q, k, v in, o out): at seq = 16
// that is 16 FLOPs per element, ~8 per byte in bf16, far below the card's
// ~295 FLOP/byte ridge.  The kernel is bound by device memory bandwidth
// (3.35 TB/s), so its job is to read each input element once and write each
// output element once.
//
// Design against that bound: one block = one (sequence, head) for K6, one
// (tile, group) for K9; consecutive K6 blocks are the heads of one sequence,
// so a sequence's rows are read by neighbouring blocks at once.  q, k, v of the block are read once into
// shared memory (consecutive threads on consecutive channels), the seq x seq
// logits stay in shared memory, and the output is written once.  Rows in
// shared memory are padded to d + 1 floats (odd for the model's even head
// dims) so the logits pass reads without bank conflicts.  No cross-block
// state.
#include "common.cuh"

namespace aniportrait {

// The bf16 tensor-core forms (small_seq_attn_sm90.cu): need d % 8 == 0 and
// 16-byte aligned operands.
cudaError_t ctg_fwd_mma(const void* q, const void* k, const void* v, void* o, int n, int seq,
                        int heads, int d, float scale2, cudaStream_t stream);
cudaError_t ssa_fwd_mma(const void* q, const void* k, const void* v, void* o, int n, int t,
                        int seq, int d, int n_valid, cudaStream_t stream);

namespace {

constexpr int THREADS = 128;
constexpr int MAX_SEQ = 32;
constexpr int MAX_D = 256;
constexpr int MAX_TILE = 128;  // K9's rows per tile

struct CtgArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int n, seq, heads, d;
  float scale;
  int t, n_valid;  // K9: rows per tile, first dead row of a tile
};

inline size_t ctg_smem_floats(int seq, int d) {
  return (size_t)seq * (2 * (d + 1) + d + (seq + 1) + 1);
}

// FOLDED = false: K6 (block = sequence x head of (n * seq, heads * d) rows).
// FOLDED = true: K9 (block = group of rows of an (n, t, d) tile, one head).
template <typename T, bool FOLDED>
__global__ void __launch_bounds__(THREADS) ctg_kernel(const CtgArgs a) {
  extern __shared__ float smem[];
  const int d = a.d;
  const int ldq = d + 1, lds = a.seq + 1;
  int f, c, r0 = 0;
  size_t base;
  if (FOLDED) {
    const int groups = (a.t + a.seq - 1) / a.seq;
    const int tile = blockIdx.x / groups;
    r0 = (blockIdx.x - tile * groups) * a.seq;
    f = min(a.seq, a.t - r0);
    c = d;
    base = ((size_t)tile * a.t + r0) * d;
  } else {
    const int seq_idx = blockIdx.x / a.heads;
    const int h = blockIdx.x - seq_idx * a.heads;
    f = a.seq;
    c = a.heads * d;
    base = (size_t)seq_idx * f * c + (size_t)h * d;
  }
  float* sQ = smem;               // [f][ldq]  K6: q * scale, rounded to T
  float* sK = sQ + a.seq * ldq;   // [f][ldq]
  float* sV = sK + a.seq * ldq;   // [f][d]
  float* sP = sV + a.seq * d;     // [f][lds]  p as PV takes it, rounded to T
  float* sR = sP + a.seq * lds;   // [f]       K6: 1 / row sum

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float scale = round_as<T>(a.scale);

  const int n_el = f * d;
  for (int i = threadIdx.x; i < n_el; i += THREADS) {
    const int t = i / d;
    const int dd = i - t * d;
    const size_t off = base + (size_t)t * c + dd;
    sQ[t * ldq + dd] = FOLDED ? to_f32(q[off]) : round_as<T>(to_f32(q[off]) * scale);
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
    if (FOLDED) {
      // valid rows see the valid columns of their group, dead rows all of it
      const int ncol = r0 + r >= a.n_valid ? f : min(f, a.n_valid - r0);
      for (int j = 0; j < ncol; ++j) mx = fmaxf(mx, row[j]);
      float sum = 0.f;
      for (int j = 0; j < f; ++j) {
        const float e = j < ncol ? expf(row[j] - mx) : 0.f;
        sum += e;
        row[j] = e;
      }
      for (int j = 0; j < f; ++j) row[j] = round_as<T>(row[j] / sum);
      sR[r] = 1.f;
    } else {
      for (int j = 0; j < f; ++j) mx = fmaxf(mx, row[j]);
      float sum = 0.f;
      for (int j = 0; j < f; ++j) {
        const float e = exp2f(row[j] - mx);
        sum += e;
        row[j] = round_as<T>(e);
      }
      sR[r] = 1.f / sum;
    }
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

template <typename T, bool FOLDED>
cudaError_t launch(const CtgArgs& a, long long blocks, cudaStream_t stream) {
  const size_t smem = ctg_smem_floats(a.seq, a.d) * sizeof(float);
  cudaError_t err = set_smem(ctg_kernel<T, FOLDED>, smem);
  if (err != cudaSuccess) return err;
  ctg_kernel<T, FOLDED><<<(unsigned)blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool FOLDED>
int launch_dtype(int dtype, const CtgArgs& a, long long blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return static_cast<int>(launch<__nv_bfloat16, FOLDED>(a, blocks, st));
  if (dtype == kFloat32) return static_cast<int>(launch<float, FOLDED>(a, blocks, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace aniportrait

// q, k, v, o: (n * seq, heads * d), contiguous; rows [i * seq, (i + 1) * seq)
// are sequence i.  scale: multiplies q (base-2 softmax).  bf16 with d % 8 ==
// 0 runs the tensor-core form.  Returns a cudaError_t code.
extern "C" int aniportrait_ctg_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, int n, int seq, int heads, int d, float scale,
                                   void* stream) {
  using namespace aniportrait;
  if (n < 1 || seq < 1 || seq > MAX_SEQ || heads < 1 || d < 1 || d > MAX_D ||
      (long long)n * heads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBFloat16 && d % 8 == 0)
    return static_cast<int>(ctg_fwd_mma(q, k, v, o, n, seq, heads, d, scale,
                                        static_cast<cudaStream_t>(stream)));
  const CtgArgs a{q, k, v, o, n, seq, heads, d, scale, 0, 0};
  return launch_dtype<false>(dtype, a, (long long)n * heads, stream);
}

// K9.  q (pre-scaled), k, v, o: (n, t, d), contiguous; each tile's rows are
// cut into groups of seq rows, rows >= n_valid are dead.  t <= 128,
// seq <= 32, d <= 256.  Forms as for K6.  Returns a cudaError_t code.
extern "C" int aniportrait_ssa_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, int n, int t, int seq, int d, int n_valid,
                                   void* stream) {
  using namespace aniportrait;
  if (n < 1 || t < 1 || t > MAX_TILE || seq < 1 || seq > MAX_SEQ || d < 1 || d > MAX_D ||
      n_valid < 0 || n_valid > t)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBFloat16 && d % 8 == 0)
    return static_cast<int>(ssa_fwd_mma(q, k, v, o, n, t, seq, d, n_valid,
                                        static_cast<cudaStream_t>(stream)));
  const long long blocks = (long long)n * ((t + seq - 1) / seq);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const CtgArgs a{q, k, v, o, n, seq, 1, d, 1.f, t, n_valid};
  return launch_dtype<true>(dtype, a, blocks, stream);
}
