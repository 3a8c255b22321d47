// The flash forward's arguments and softmax modes, shared by its three
// forms: the bf16 tensor-core kernel (flash_attn_sm90.cu), the float32
// tensor-core kernel in 3xTF32 for head dims up to 128
// (flash_attn_tf32x3_sm90.cu) and the float32 FMA kernel above 128
// (flash_attn.cu).  The C entry points in flash_attn.cu choose the form by
// dtype and head dim.
#pragma once

#include "common.cuh"

namespace aniportrait {

// softmax modes (the codes of aniportrait_tok_flash_fwd's `mode`)
constexpr int RUNMAX = 0;       // online running max: K1, K2, K4, K5a
constexpr int NOSHIFT_E = 1;    // K7
constexpr int BOUNDED_2 = 2;    // K8
constexpr int UNSHIFTED_2 = 3;  // K2 in its TPU form

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* kb;       // bank keys (B / rep, sbank, C) or nullptr
  const void* vb;
  const int32_t* drop;  // (B,) drop_tail flags or nullptr
  void* o;
  float* lse;           // (B, heads, sq) float32, written when not null
  int batch, sq, skv, sbank, heads, d, rep, kv_split;
  // RUNMAX: the logits' float32 multiplier scale * log2(e); UNSHIFTED_2: the
  // multiplier applied to q in its dtype; NOSHIFT_E, BOUNDED_2: unused (q
  // arrives scaled)
  float scale_log2;
  const float* bound;   // BOUNDED_2: (B, sq, heads) float32 base-2 bound
  int32_t* guard;       // modes other than RUNMAX: the flag they OR into
  const int32_t* pred;  // RUNMAX: run only if *pred != 0 (nullptr: always)
};

// The bf16 tensor-core form (flash_attn_sm90.cu): one launch of `mode`.
cudaError_t flash_fwd_sm90(const FlashArgs& a, int mode, cudaStream_t stream);

// The float32 tensor-core form (flash_attn_tf32x3_sm90.cu), d <= 128: one
// launch of `mode`.
constexpr int kTf32x3MaxHeadDim = 128;
cudaError_t flash_fwd_tf32x3(const FlashArgs& a, int mode, cudaStream_t stream);

}  // namespace aniportrait
