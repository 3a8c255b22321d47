// Normalisation kernels for Hopper (sm_90a): ops/kernels/norm.py's
// group_norm (N1) and layer_norm (N2) on bf16 activations.
//
// Replaces no TPU kernel: the JAX package leaves its GroupNorm and LayerNorm
// (aniportrait_tpu/models/resnet.py, models/attention.py) to XLA, which fuses
// the float32 casts around them into one pass.  Eager PyTorch does not: the
// port's composition (x.float(), the float32 ATen norm, .to(bf16), then a
// separate SiLU or positional-encoding add) moves ~20 bytes an element where
// a norm needs 4.  These kernels read the bf16 activation once and write it
// once, with the statistics and the affine map in float32 and the epilogue
// of the call site fused in.
//
// What bounds them on an H100: a few FLOPs an element over 4 bytes moved, so
// device memory bandwidth (3.35 TB/s).  Their job is one read and one write
// an element, with enough loads in flight to cover the latency.
//
// Rounding: exactly where the composition rounds.  The normalised, affine
// value is rounded to bf16 once; the SiLU is computed in float32 on that
// bf16 value and rounded again (F.silu on a bf16 tensor); the positional
// encoding, rounded to bf16, is added in float32 to the rounded norm output
// and rounded (norm(x) + pe in bf16).  Only the order in which the
// statistics are summed differs from ATen's.
//
// N1, GroupNorm on frames-folded (rows, c, h, w), num_groups groups.  A slab
// is the elements of one (sample, group): `frames` chunks of c / groups * h
// * w contiguous elements, frame_stride apart (frames = 1: the per-frame
// norm, one contiguous chunk; frames = f: the pooled norm over a sample's
// f frames).  One cluster of k <= 8 blocks takes a slab, each block a
// contiguous part of it:
//   * pass 1 reads the part once with 16-byte loads, keeps up to kResident
//     elements of it in shared memory, and sums each thread's elements
//     shifted by the thread's first one, x - x0 and (x - x0)^2, into its
//     (count, mean, M2): with x0 a sample of the slab there is no
//     E[x^2] - E[x]^2 cancellation;
//   * the block merges its threads' moments by Chan's rule over warp
//     shuffles, and the cluster its blocks' through distributed shared
//     memory, every block in the same order, so all blocks of a slab hold
//     the same statistics;
//   * pass 2 normalises from shared memory (the part beyond kResident, only
//     in the VAE's 128-512 px levels, is read again from device memory) and
//     writes once with 16-byte stores.
// Slabs range from 2.5 K elements (the UNet's 8x8 level) to 2 M (the VAE
// decoder at 512x512, 256 channels); k = ceil(slab / kResident) up to 8 keeps
// a block's part resident up to 128 K-element slabs (every UNet and
// PoseGuider level, the VAE's 64 px level).  Shapes whose h * w is not a
// multiple of 8 (the 9x12 level of a 576x768 request), or unaligned tensors,
// take the same kernel with scalar accesses.
//
// N2, LayerNorm over the last dim C of (rows, C).  One warp a row, the row in
// registers (NV 16-byte vectors a lane, C <= 2048), two passes over the
// registers for the mean and the variance, warp shuffles only.  The optional
// addend pe[frame(row), :], frame(row) = (row / positions) % frames, is the
// motion module's positional encoding on natural (b, f, s, c) activations.
// C % 8 != 0, C > 2048 or unaligned tensors take a scalar warp-a-row form
// that reads the row three times.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cgs = cooperative_groups;

namespace aniportrait {
namespace {

constexpr int kNormThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kResident = 16384;  // elements of a block's part in shared memory

// byte offset of the per-channel coefficients behind a part's resident elements
__host__ __device__ __forceinline__ size_t coef_offset(int resident) {
  return (static_cast<size_t>(resident) * 2 + 15) / 16 * 16;
}

struct Moments {
  float n, mean, m2;
};

__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float wb = b.n / n;
  return {n, a.mean + d * wb, a.m2 + b.m2 + d * d * a.n * wb};
}

// lane 0 ends with the merge of the warp's 32 moments
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Moments other{__shfl_down_sync(0xffffffffu, m.n, o),
                  __shfl_down_sync(0xffffffffu, m.mean, o),
                  __shfl_down_sync(0xffffffffu, m.m2, o)};
    m = merge(m, other);
  }
  return m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float load_param(const void* p, int dtype, int i) {
  return dtype == kBFloat16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// F.silu on a bf16 value, in float32 as ATen computes it, rounded to bf16
__device__ __forceinline__ float silu_rounded(float v) {
  return bf16_round(v / (1.0f + expf(-v)));
}

// 8 bf16 <-> 8 floats
__device__ __forceinline__ void unpack8(const uint4& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return r;
}

// ------------------------------------------------------------------- N1

struct GroupNormArgs {
  const __nv_bfloat16* x;
  __nv_bfloat16* y;
  const void* weight;
  const void* bias;
  int wdtype;        // kFloat32 or kBFloat16
  int cg;            // channels a group
  int hw;            // elements a channel a frame
  int chunk;         // cg * hw: contiguous elements of a slab a frame
  int frames;        // chunks a slab
  long long frame_stride;  // c * hw
  int slab;          // frames * chunk
  int part;          // elements a block (a multiple of 8 in the vector form)
  int resident;      // elements of a part kept in shared memory
  float eps;
};

template <int VEC, bool SILU>
__global__ void __launch_bounds__(kNormThreads) group_norm_kernel(const GroupNormArgs a) {
  using Vec = std::conditional_t<VEC == 8, uint4, __nv_bfloat16>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Vec* cache = reinterpret_cast<Vec*>(smem_raw);
  float2* coef = reinterpret_cast<float2*>(smem_raw + coef_offset(a.resident));
  __shared__ Moments warp_m[kNormThreads / 32];
  __shared__ Moments block_m;
  __shared__ float stats[2];

  const int g = blockIdx.y;
  const long long sample_base = static_cast<long long>(blockIdx.z) * a.frames * a.frame_stride;
  const long long base = sample_base + static_cast<long long>(g) * a.chunk;
  const int p0 = blockIdx.x * a.part;
  const int p1 = min(a.slab, p0 + a.part);
  const int nv = p1 > p0 ? (p1 - p0) / VEC : 0;
  const int nres = a.resident / VEC;

  // element i of the slab -> its offset from the slab's first element
  auto offset = [&](int i) -> long long {
    if (a.frames == 1) return i;
    const int q = i / a.chunk;
    return static_cast<long long>(q) * a.frame_stride + (i - q * a.chunk);
  };
  const Vec* xv = reinterpret_cast<const Vec*>(a.x + base);
  Vec* yv = reinterpret_cast<Vec*>(a.y + base);

  // pass 1: read the part once, keep what fits, and sum each thread's
  // elements shifted by its first one (sums of x - x0 and (x - x0)^2: no
  // cancellation while x0 lies within a few deviations of the mean)
  constexpr int U = VEC == 8 ? 4 : 8;  // loads in flight a thread
  float shift = 0.f, s1 = 0.f, s2 = 0.f;
  for (int v0 = threadIdx.x; v0 < nv; v0 += U * kNormThreads) {
    Vec r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * kNormThreads;
      if (v < nv) r[u] = __ldg(&xv[offset(p0 + v * VEC) / VEC]);
    }
    if (v0 == static_cast<int>(threadIdx.x))
      shift = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(&r[0]));
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * kNormThreads;
      if (v < nv) {
        if (v < nres) cache[v] = r[u];
        float f[VEC];
        if constexpr (VEC == 8) unpack8(r[u], f);
        else f[0] = __bfloat162float(r[u]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = f[j] - shift;
          s1 += d;
          s2 = fmaf(d, d, s2);
        }
      }
    }
  }
  const int mine = nv > static_cast<int>(threadIdx.x) ? (nv - 1 - threadIdx.x) / kNormThreads + 1 : 0;
  Moments acc{0.f, 0.f, 0.f};
  if (mine) {
    acc.n = static_cast<float>(mine * VEC);
    const float m = s1 / acc.n;
    acc.mean = shift + m;
    acc.m2 = fmaxf(s2 - s1 * m, 0.f);
  }
  acc = warp_merge(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_m[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    Moments m = lane < kNormThreads / 32 ? warp_m[lane] : Moments{0.f, 0.f, 0.f};
    m = warp_merge(m);
    if (lane == 0) block_m = m;
  }
  __syncthreads();

  // the slab's moments: the cluster's blocks merged in rank order
  if (gridDim.x > 1) {
    cgs::cluster_group cluster = cgs::this_cluster();
    cluster.sync();
    if (threadIdx.x == 0) {
      Moments t{0.f, 0.f, 0.f};
      for (unsigned r = 0; r < gridDim.x; ++r) t = merge(t, *cluster.map_shared_rank(&block_m, r));
      stats[0] = t.mean;
      stats[1] = rsqrtf(fmaxf(t.m2 / t.n, 0.f) + a.eps);
    }
    cluster.sync();  // no block leaves while another reads its moments
  } else if (threadIdx.x == 0) {
    stats[0] = block_m.mean;
    stats[1] = rsqrtf(fmaxf(block_m.m2 / block_m.n, 0.f) + a.eps);
  }
  __syncthreads();
  const float mean = stats[0], rstd = stats[1];
  // y = a * x + b per channel of the group, as ATen fuses the affine map
  for (int j = threadIdx.x; j < a.cg; j += kNormThreads) {
    const int c = g * a.cg + j;
    const float sc = rstd * load_param(a.weight, a.wdtype, c);
    coef[j] = make_float2(sc, -sc * mean + load_param(a.bias, a.wdtype, c));
  }
  __syncthreads();

  // pass 2: normalise from shared memory (or device memory past the
  // resident elements) and write once
  for (int v0 = threadIdx.x; v0 < nv; v0 += U * kNormThreads) {
    Vec r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * kNormThreads;
      if (v < nv) r[u] = v < nres ? cache[v] : __ldg(&xv[offset(p0 + v * VEC) / VEC]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * kNormThreads;
      if (v >= nv) continue;
      const int i = p0 + v * VEC;
      const long long off = offset(i);
      const int within = a.frames == 1 ? i : i - (i / a.chunk) * a.chunk;
      if constexpr (VEC == 8) {
        const float2 k = coef[within / a.hw];  // a vector lies in one channel
        float f[8];
        unpack8(r[u], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          f[j] = bf16_round(fmaf(k.x, f[j], k.y));
          if constexpr (SILU) f[j] = silu_rounded(f[j]);
        }
        yv[off / 8] = pack8(f);
      } else {
        const float2 k = coef[within / a.hw];
        float f = bf16_round(fmaf(k.x, __bfloat162float(r[u]), k.y));
        if constexpr (SILU) f = silu_rounded(f);
        yv[off] = __float2bfloat16(f);
      }
    }
  }
}

template <int VEC, bool SILU>
cudaError_t launch_group_norm(const GroupNormArgs& a, int k, int groups, int samples,
                              size_t smem, cudaStream_t stream) {
  auto kernel = group_norm_kernel<VEC, SILU>;
  if (smem > 48 * 1024) {
    const cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, groups, samples);
  cfg.blockDim = dim3(kNormThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = k > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ------------------------------------------------------------------- N2

struct LayerNormArgs {
  const __nv_bfloat16* x;
  __nv_bfloat16* y;
  const void* weight;
  const void* bias;
  int wdtype;
  const void* pe;    // (frames, C) addend, or null
  int pe_dtype;
  int frames, positions;
  int rows, c;
  float eps;
};

constexpr int kRowsPerBlock = kNormThreads / 32;

__device__ __forceinline__ void load8_param(const void* p, int dtype, int i, float* f) {
  if (dtype == kBFloat16) {
    unpack8(*reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p) + i), f);
  } else {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    const float4 lo = q[0], hi = q[1];
    f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
    f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
  }
}

template <int NV, bool PE>
__global__ void __launch_bounds__(kNormThreads) layer_norm_kernel(const LayerNormArgs a) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (row >= a.rows) return;
  const int nvec = a.c / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(a.x + row * a.c);
  uint4* yr = reinterpret_cast<uint4*>(a.y + row * a.c);
  float f[NV][8];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lane + 32 * j;
    if (v < nvec) {
      unpack8(__ldg(&xr[v]), f[j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[j][e];
    }
  }
  const float mean = warp_sum(s) / a.c;
  float m2 = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (lane + 32 * j < nvec) {
#pragma unroll
      for (int e = 0; e < 8; ++e) m2 += (f[j][e] - mean) * (f[j][e] - mean);
    }
  }
  const float rstd = rsqrtf(warp_sum(m2) / a.c + a.eps);
  const int frame = PE ? static_cast<int>((row / a.positions) % a.frames) : 0;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lane + 32 * j;
    if (v >= nvec) continue;
    float w[8], b[8], p[8];
    load8_param(a.weight, a.wdtype, v * 8, w);
    load8_param(a.bias, a.wdtype, v * 8, b);
    if constexpr (PE) load8_param(a.pe, a.pe_dtype, frame * a.c + v * 8, p);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float n = rstd * (f[j][e] - mean);
      float o = bf16_round(fmaf(w[e], n, b[e]));
      if constexpr (PE) o = o + bf16_round(p[e]);
      f[j][e] = o;
    }
    yr[v] = pack8(f[j]);
  }
}

// any C, any alignment: the row read three times
template <bool PE>
__global__ void __launch_bounds__(kNormThreads) layer_norm_scalar_kernel(const LayerNormArgs a) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (row >= a.rows) return;
  const __nv_bfloat16* xr = a.x + row * a.c;
  __nv_bfloat16* yr = a.y + row * a.c;
  float s = 0.f;
  for (int i = lane; i < a.c; i += 32) s += __bfloat162float(xr[i]);
  const float mean = warp_sum(s) / a.c;
  float m2 = 0.f;
  for (int i = lane; i < a.c; i += 32) {
    const float d = __bfloat162float(xr[i]) - mean;
    m2 += d * d;
  }
  const float rstd = rsqrtf(warp_sum(m2) / a.c + a.eps);
  const int frame = PE ? static_cast<int>((row / a.positions) % a.frames) : 0;
  for (int i = lane; i < a.c; i += 32) {
    const float n = rstd * (__bfloat162float(xr[i]) - mean);
    float o = bf16_round(fmaf(load_param(a.weight, a.wdtype, i), n, load_param(a.bias, a.wdtype, i)));
    if constexpr (PE) o = o + bf16_round(load_param(a.pe, a.pe_dtype, frame * a.c + i));
    yr[i] = __float2bfloat16(o);
  }
}

template <int NV>
cudaError_t launch_layer_norm(const LayerNormArgs& a, cudaStream_t stream) {
  const dim3 grid((a.rows + kRowsPerBlock - 1) / kRowsPerBlock);
  if (a.pe) layer_norm_kernel<NV, true><<<grid, kNormThreads, 0, stream>>>(a);
  else layer_norm_kernel<NV, false><<<grid, kNormThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace aniportrait

// N1: x, y (samples * frames, channels, hw) bf16; weight, bias of `wdtype`
// (kFloat32 or kBFloat16); statistics per (sample, group) over
// `frames` consecutive rows; silu: apply the rounded SiLU after the norm.
extern "C" int aniportrait_group_norm_fwd(const void* x, void* y, const void* weight,
                                          const void* bias, int wdtype, int samples,
                                          int frames, int channels, int groups, int hw,
                                          float eps, int silu, void* stream) {
  using namespace aniportrait;
  if (samples < 1 || samples > 65535 || groups < 1 || groups > 65535 || channels % groups ||
      frames < 1 || hw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cg = channels / groups;
  const long long chunk = static_cast<long long>(cg) * hw;
  const long long slab = chunk * frames;
  if (slab >= (1LL << 31) - 8) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = hw % 8 == 0 && aligned16(x) && aligned16(y);
  const int unit = vec ? 8 : 1;
  int k = static_cast<int>((slab + kResident - 1) / kResident);
  k = k < 1 ? 1 : (k > kMaxCluster ? kMaxCluster : k);
  long long part = (slab + k - 1) / k;
  part = (part + unit - 1) / unit * unit;
  GroupNormArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
                  weight, bias, wdtype, cg, hw, static_cast<int>(chunk), frames,
                  static_cast<long long>(channels) * hw, static_cast<int>(slab),
                  static_cast<int>(part), 0, eps};
  a.resident = static_cast<int>(part < kResident ? part : kResident);
  const size_t smem = coef_offset(a.resident) + static_cast<size_t>(cg) * 8;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (vec) {
    return static_cast<int>(silu ? launch_group_norm<8, true>(a, k, groups, samples, smem, st)
                                 : launch_group_norm<8, false>(a, k, groups, samples, smem, st));
  }
  return static_cast<int>(silu ? launch_group_norm<1, true>(a, k, groups, samples, smem, st)
                               : launch_group_norm<1, false>(a, k, groups, samples, smem, st));
}

// N2: x, y (rows, c) bf16; weight, bias of `wdtype`; pe: null
// or (frames, c) of `pe_dtype`, added to row r's output at frame
// (r / positions) % frames.
extern "C" int aniportrait_layer_norm_fwd(const void* x, void* y, const void* weight,
                                          const void* bias, int wdtype, int rows, int c,
                                          float eps, const void* pe, int pe_dtype, int frames,
                                          int positions, void* stream) {
  using namespace aniportrait;
  if (rows < 0 || c < 1 || (pe && (frames < 1 || positions < 1)) ||
      rows > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LayerNormArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
                  weight, bias, wdtype, pe, pe_dtype, frames, positions, rows, c, eps};
  const bool vec = c % 8 == 0 && c <= 8 * 32 * 8 && aligned16(x) && aligned16(y) &&
                   aligned16(weight) && aligned16(bias) &&
                   (!pe || aligned16(pe));
  if (vec) {
    switch ((c / 8 + 31) / 32) {
      case 1: return static_cast<int>(launch_layer_norm<1>(a, st));
      case 2: return static_cast<int>(launch_layer_norm<2>(a, st));
      case 3: return static_cast<int>(launch_layer_norm<3>(a, st));
      case 4: return static_cast<int>(launch_layer_norm<4>(a, st));
      case 5: return static_cast<int>(launch_layer_norm<5>(a, st));
      case 6: return static_cast<int>(launch_layer_norm<6>(a, st));
      case 7: return static_cast<int>(launch_layer_norm<7>(a, st));
      case 8: return static_cast<int>(launch_layer_norm<8>(a, st));
      default: break;
    }
  }
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  if (pe) layer_norm_scalar_kernel<true><<<grid, kNormThreads, 0, st>>>(a);
  else layer_norm_scalar_kernel<false><<<grid, kNormThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
