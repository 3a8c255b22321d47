// Temporal (frame-axis) attention, bf16 form, for Hopper (sm_90a) on
// natural-layout activations: ops/kernels/temporal.py's nat_temporal.  The
// C entry point of temporal_attn.cu sends every bf16 call with a head dim
// that is a multiple of 8 here (float32 keeps temporal_attn.cu's kernel).
//
// Replaces the Pallas TPU kernel K3 of aniportrait_tpu/ops/pallas_attention.py,
// nat_temporal_attention_pallas / _nat_kernel (reached through nat_packed),
// with its rounding contract (:1986-2007): q x scale rounded to bf16 first
// (scale = log2(e) / sqrt(d), itself rounded to bf16), logits q.k summed in
// float32, p = exp2(logit - row max), p rounded to bf16 for PV, and the
// float32 PV sum times 1 / sum(unrounded p) after the product.
//
// What bounds it on an H100: per (clip row, position, head) sequence of f
// frames the work is 4 f^2 d FLOPs over 4 f d bf16 elements moved (q, k, v
// in, o out): at f = 16 about 8 FLOPs per byte, far below the card's ~295
// FLOP/byte ridge.  Device memory bounds it (3.35 TB/s); the kernel's job is
// to read each input byte once, fully coalesced, and write each output byte
// once.
//
// Design against that bound (the Pallas block's idea: cut (f, positions, c)
// slabs with all heads in the lane axis), seq_attn_mma.cuh's strided_block
// with frames as its rows and positions as its sequences:
//   * one block = one clip row, a run of n consecutive positions and a
//     group of hg heads, all f frames: each frame's slice of the block is one
//     contiguous span (hg = heads, or n = 1), copied with 16-byte cp.async
//     into shared memory, so every input byte is read once and each warp's
//     requests cover whole 32-byte sectors.  strided_layout picks n (and,
//     where one position of all heads does not fit, hg) so that q, k and v
//     take at most ~72 KB and several blocks share an SM.
//   * frame rows sit an odd number of 16-byte units apart in shared memory,
//     so ldmatrix's eight row addresses hit eight different bank groups.
//   * one warp per (position, head) sequence (attend_warp): QK^T and PV on
//     the tensor cores with mma.sync, f padded to a multiple of 16 and
//     masked, softmax in registers.
//   * the output overwrites the sequence's own q in shared memory and leaves
//     with 16-byte coalesced stores.
// K6 (small_seq_attn_sm90.cu) runs the same block with other strides.
#include "seq_attn_mma.cuh"

namespace aniportrait {
namespace {

// FT = ceil(f / 16) tiles of 16 frames
template <int FT>
__global__ void __launch_bounds__(kSeqThreads, 1) temporal_kernel_mma(const StridedArgs a) {
  extern __shared__ __align__(16) bf16 tsm[];
  strided_block<FT>(a, tsm);
}

template <int FT>
cudaError_t launch_ft(const StridedArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = size_t(3) * a.frames * a.stride * sizeof(bf16);
  cudaError_t err = set_smem(temporal_kernel_mma<FT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((a.s + a.n - 1) / a.n) * (a.heads / a.hg), batch);
  temporal_kernel_mma<FT><<<grid, kSeqThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

cudaError_t temporal_fwd_mma(const void* q, const void* k, const void* v, void* o, int batch,
                             int frames, int s, int heads, int d, float scale2,
                             cudaStream_t stream) {
  if (d % 8 != 0 || frames < 1 || frames > 64 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o))
    return cudaErrorInvalidValue;
  const long long c = static_cast<long long>(heads) * d;
  const StridedArgs a = strided_layout(q, k, v, o, frames, s, heads, d, s * c, c, scale2);
  switch ((frames + 15) / 16) {
    case 1: return launch_ft<1>(a, batch, stream);
    case 2: return launch_ft<2>(a, batch, stream);
    case 3: return launch_ft<3>(a, batch, stream);
    default: return launch_ft<4>(a, batch, stream);
  }
}

}  // namespace aniportrait
