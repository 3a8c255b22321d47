// The flash backward's arguments, shared by its two forms: the FMA kernels
// (flash_bwd.cu: float32, and bf16 head dims above 128) and the bf16
// tensor-core kernel (flash_bwd_sm90.cu, head dims up to 128).  The C entry
// point in flash_bwd.cu chooses the form by dtype and head dim.
#pragma once

#include "common.cuh"

namespace aniportrait {

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
  float* dq_ws;         // tensor-core form: zeroed float32 (B, heads, sq, DP)
  int batch, sq, skv, heads, d, kv_split;
  float scale;  // natural softmax scale
};

// keys a batch row attends to: rows flagged in drop stop at kv_split
__host__ __device__ __forceinline__ int kv_len(const BwdArgs& a, int b) {
  return (a.drop != nullptr && a.drop[b] != 0) ? a.kv_split : a.skv;
}

// The largest head dim the tensor-core form takes (DP = 128).
constexpr int kBwdSm90MaxHeadDim = 128;

// The bf16 tensor-core form (flash_bwd_sm90.cu): the dk/dv/dq kernel and the
// conversion of the dq workspace into dq.
cudaError_t flash_bwd_sm90(const BwdArgs& a, cudaStream_t stream);

}  // namespace aniportrait
