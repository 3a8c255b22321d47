// Attention over many short contiguous sequences, bf16 form, for Hopper
// (sm_90a): ops/kernels/small_seq.py's ctg_packed (K6) and ssa_packed (K9).
// The C entry points of small_seq_attn.cu send every bf16 call with a head
// dim that is a multiple of 8 here; float32 (and other head dims) keep that
// file's FMA kernel.
//
// Replaces the Pallas TPU kernels K6 (_ctg_kernel, reached through
// ctg_packed) and K9 (_small_seq_kernel, through ssa_packed) of
// aniportrait_tpu/ops/pallas_attention.py, each with its rounding contract
// (seq_attn_mma.cuh's attend_warp: K6 base 2 with q x scale rounded to bf16
// and 1 / sum after PV, K9 base e with p / sum rounded before PV).
//
// What bounds it on an H100: per sequence the work is 4 seq^2 d FLOPs over
// 4 seq d bf16 elements moved (q, k, v in, o out): at seq = 16 about 8 FLOPs
// per byte, far below the card's ~295 FLOP/byte ridge.  Device memory bounds
// it (3.35 TB/s); the kernels' job is to read each input byte once, fully
// coalesced, and write each output byte once, in blocks large enough to keep
// the card's memory busy (the FMA kernel's one small block per (sequence,
// head) or per group left it waiting on block start-up).
//
// K6: (N * seq, C) rows, C = heads * d, each sequence's seq rows
// contiguous.  That is K3's layout with a sequence's rows for its frames (C
// apart) and the sequences for its positions (seq * C apart), and K3's
// contract (the Pallas _ctg_kernel and _nat_kernel bodies round alike).  So
// K6 runs K3's block, seq_attn_mma.cuh's strided_block, with those strides:
// a run of up to 8 whole sequences, or where one sequence of all heads
// passes the ~72 KB budget a group of heads, each row's slice one contiguous
// span; one warp per (sequence, head).  Its own instantiations
// (ctg_kernel_mma) keep its time apart from K3's in a profile.
//
// K9: (n, T, dp) tiles, T <= 128 rows of one head each, cut into groups of
// seq <= 32 rows (the last group of a tile shorter when T % seq != 0); a row
// attends within its group, live rows (below n_valid_rows) only to live
// columns, dead rows to their whole group; dead rows' outputs are written
// too.  A block takes a run of whole tiles, one contiguous span of the
// input, as many as fit the ~72 KB budget (2 at (T, dp) = (128, 40), 1 at
// (128, 80)); rows land an odd number of 16-byte units apart (dp = 80 gets
// one unit of padding); one warp per group, padded to 16 or 32 rows.
#include "seq_attn_mma.cuh"

namespace aniportrait {
namespace {

// K6, FT = ceil(seq / 16)
template <int FT>
__global__ void __launch_bounds__(kSeqThreads, 1) ctg_kernel_mma(const StridedArgs a) {
  extern __shared__ __align__(16) bf16 csm[];
  strided_block<FT>(a, csm);
}

struct SsaMmaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int n, t, seq, d, n_valid;
  int tiles;   // tiles per block
  int stride;  // elements between rows in shared memory
};

// K9, FT = ceil(min(seq, t) / 16)
template <int FT>
__global__ void __launch_bounds__(kSeqThreads, 1) ssa_kernel_mma(const SsaMmaArgs a) {
  extern __shared__ __align__(16) bf16 ssm[];
  const int tile0 = blockIdx.x * a.tiles;
  const int nt = min(a.tiles, a.n - tile0);
  const int per_row = a.d / 8;  // 16-byte vectors of a row
  const int vecs = nt * a.t * per_row;
  const size_t g0 = static_cast<size_t>(tile0) * a.t * a.d;
  bf16* sq = ssm;
  bf16* sk = sq + a.tiles * a.t * a.stride;
  bf16* sv = sk + a.tiles * a.t * a.stride;

  // ---- load: the block's tiles are one contiguous span
  for (int i = threadIdx.x; i < vecs; i += kSeqThreads) {
    const int r = i / per_row;
    const int sofs = r * a.stride + (i - r * per_row) * 8;
    const size_t g = g0 + static_cast<size_t>(i) * 8;
    cp_async16(sq + sofs, a.q + g);
    cp_async16(sk + sofs, a.k + g);
    cp_async16(sv + sofs, a.v + g);
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- one warp per group
  const int groups = (a.t + a.seq - 1) / a.seq;
  for (int gi = threadIdx.x / 32; gi < nt * groups; gi += kSeqWarps) {
    const int ti = gi / groups;
    const int r0 = (gi - ti * groups) * a.seq;
    const int f = min(a.seq, a.t - r0);
    const int live = max(0, min(f, a.n_valid - r0));
    const int base = (ti * a.t + r0) * a.stride;
    attend_warp<FT, true>(SeqTile{sq + base, sk + base, sv + base, a.stride, f, a.d, live},
                          1.f);
  }
  __syncthreads();

  // ---- store: 16 bytes a thread, coalesced
  for (int i = threadIdx.x; i < vecs; i += kSeqThreads) {
    const int r = i / per_row;
    *reinterpret_cast<uint4*>(a.o + g0 + static_cast<size_t>(i) * 8) =
        *reinterpret_cast<const uint4*>(sq + r * a.stride + (i - r * per_row) * 8);
  }
}

template <int FT>
cudaError_t launch_ctg(const StridedArgs& a, cudaStream_t stream) {
  const size_t smem = size_t(3) * a.frames * a.stride * sizeof(bf16);
  cudaError_t err = set_smem(ctg_kernel_mma<FT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((a.s + a.n - 1) / a.n) * (a.heads / a.hg), 1);
  ctg_kernel_mma<FT><<<grid, kSeqThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int FT>
cudaError_t launch_ssa(const SsaMmaArgs& a, cudaStream_t stream) {
  const size_t smem = size_t(3) * a.tiles * a.t * a.stride * sizeof(bf16);
  cudaError_t err = set_smem(ssa_kernel_mma<FT>, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((a.n + a.tiles - 1) / a.tiles);
  ssa_kernel_mma<FT><<<blocks, kSeqThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned_operands(const void* q, const void* k, const void* v, const void* o) {
  return aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
}

}  // namespace

// K6 on the tensor cores: (n * seq, heads * d) bf16, d % 8 == 0, seq <= 32,
// 16-byte aligned operands; scale2 is the base-2 scale.
cudaError_t ctg_fwd_mma(const void* q, const void* k, const void* v, void* o, int n, int seq,
                        int heads, int d, float scale2, cudaStream_t stream) {
  if (d % 8 != 0 || seq < 1 || seq > 32 || !aligned_operands(q, k, v, o))
    return cudaErrorInvalidValue;
  const long long c = static_cast<long long>(heads) * d;
  const StridedArgs a = strided_layout(q, k, v, o, seq, n, heads, d, c, seq * c, scale2);
  return seq <= 16 ? launch_ctg<1>(a, stream) : launch_ctg<2>(a, stream);
}

// K9 on the tensor cores: (n, t, d) bf16 tiles, q pre-scaled, d % 8 == 0,
// t <= 128, seq <= 32, 16-byte aligned operands.
cudaError_t ssa_fwd_mma(const void* q, const void* k, const void* v, void* o, int n, int t,
                        int seq, int d, int n_valid, cudaStream_t stream) {
  if (d % 8 != 0 || t < 1 || t > 128 || seq < 1 || seq > 32 || !aligned_operands(q, k, v, o))
    return cudaErrorInvalidValue;
  const int stride = ((d / 8) | 1) * 8;  // an odd count of 16-byte units
  const size_t per_tile = size_t(3) * t * stride * sizeof(bf16);
  int tiles = static_cast<int>(kSeqBlockBytes / per_tile);
  tiles = tiles < 1 ? 1 : (tiles > 8 ? 8 : tiles);
  tiles = tiles > n ? n : tiles;
  const SsaMmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<bf16*>(o), n, t, seq, d,
                     n_valid, tiles, stride};
  return (seq < t ? seq : t) <= 16 ? launch_ssa<1>(a, stream) : launch_ssa<2>(a, stream);
}

}  // namespace aniportrait
