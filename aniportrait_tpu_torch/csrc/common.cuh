// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aniportrait {

// dtype codes passed across the C interface (see ops/kernels/build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// x rounded to T's precision and back (the TPU kernels round a float32
// operand to the storage dtype before a product with a storage-dtype tile).
template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Calls CASE(DP) for the head tile DP = round_up(d, 16) in 16 ... 256 and
// returns cudaErrorInvalidValue for any other d.
#define ANIPORTRAIT_HEAD_DIM_SWITCH(d, CASE) \
  switch (((d) + 15) / 16) {                 \
    case 1: CASE(16)                         \
    case 2: CASE(32)                         \
    case 3: CASE(48)                         \
    case 4: CASE(64)                         \
    case 5: CASE(80)                         \
    case 6: CASE(96)                         \
    case 7: CASE(112)                        \
    case 8: CASE(128)                        \
    case 9: CASE(144)                        \
    case 10: CASE(160)                       \
    case 11: CASE(176)                       \
    case 12: CASE(192)                       \
    case 13: CASE(208)                       \
    case 14: CASE(224)                       \
    case 15: CASE(240)                       \
    case 16: CASE(256)                       \
    default: return cudaErrorInvalidValue;   \
  }

// Opt a kernel into more than 48 KB of dynamic shared memory (Hopper
// allows up to 227 KB per block).
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace aniportrait
