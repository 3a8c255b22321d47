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
// slabs with all heads in the lane axis):
//   * one block = one clip row, a run of n consecutive positions and a
//     group of hg heads, all f frames: each frame's slice of the block is one
//     contiguous span (hg = heads, or n = 1), copied with 16-byte cp.async
//     into shared memory, so every input byte is read once and each warp's
//     requests cover whole 32-byte sectors.  The entry point picks n (and,
//     where one position of all heads does not fit, hg) so that q, k and v
//     take at most ~72 KB and several blocks share an SM.
//   * frame rows sit an odd number of 16-byte units apart in shared memory,
//     so ldmatrix's eight row addresses hit eight different bank groups.
//   * one warp per (position, head) sequence; QK^T and PV on the tensor
//     cores with mma.sync m16n8k16 bf16 (m16n8k8 for a head dim's last 8
//     columns), operands by ldmatrix (.trans for V); f padded to a multiple
//     of 16 (rows and columns past f masked; their addresses clamped to frame
//     f - 1, so nothing uninitialised is read).  Softmax in registers: a row
//     lives in the 4 lanes of a quad.
//   * the output overwrites the sequence's own q in shared memory and leaves
//     with 16-byte coalesced stores.
#include "sm90.cuh"

namespace aniportrait {
namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct TemporalMmaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int frames, s, heads, d;
  int n;       // positions per block
  int hg;      // heads per block
  int stride;  // elements between frame rows in shared memory
  float scale;  // base-2 softmax scale (log2(e) / sqrt(d)), rounded to bf16
};

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// D(16 x 8, float32) += A(16 x 16) B(16 x 8), bf16
__device__ __forceinline__ void mma16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D(16 x 8, float32) += A(16 x 8) B(8 x 8), bf16
__device__ __forceinline__ void mma8(float* c, const uint32_t* a, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// each bf16 of the pair x scale, rounded to bf16 (exact product, one rounding)
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float scale) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  return pack_bf16(__low2float(v) * scale, __high2float(v) * scale);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// FT = ceil(f / 16) tiles of 16 frames
template <int FT>
__global__ void __launch_bounds__(THREADS, 1) temporal_kernel_mma(const TemporalMmaArgs a) {
  constexpr int NT = 2 * FT;  // logit column tiles of 8 frames
  extern __shared__ __align__(16) bf16 tsm[];
  const int f = a.frames, d = a.d, c = a.heads * d;
  const int groups = a.heads / a.hg;
  const int run = blockIdx.x / groups;
  const int h0 = (blockIdx.x - run * groups) * a.hg;
  const int p0 = run * a.n;
  const int b = blockIdx.y;
  const int n_eff = min(a.n, a.s - p0);
  const int width = a.hg * d;           // one position's channels in the block
  const int vecs = n_eff * width / 8;   // 16-byte vectors per frame
  bf16* sq = tsm;
  bf16* sk = sq + f * a.stride;
  bf16* sv = sk + f * a.stride;

  // ---- load: every frame's span, 16 bytes a thread, coalesced
  auto gofs = [&](int fi, int vi) {
    const int pi = vi / (width / 8);
    const int cc = (vi - pi * (width / 8)) * 8;
    return (static_cast<size_t>(b * f + fi) * a.s + p0 + pi) * c + h0 * d + cc;
  };
  for (int i = threadIdx.x; i < f * vecs; i += THREADS) {
    const int fi = i / vecs;
    const int vi = i - fi * vecs;
    const size_t g = gofs(fi, vi);
    const int sofs = fi * a.stride + vi * 8;
    cp_async16(sq + sofs, a.q + g);
    cp_async16(sk + sofs, a.k + g);
    cp_async16(sv + sofs, a.v + g);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // ---- one warp per (position, head) sequence
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int l8 = lane & 7;
  const int m1 = (lane >> 3) & 1;  // ldmatrix: matrix 1 or 3 of the four
  const int m2 = lane >> 4;        // matrix 2 or 3
  const float qscale = a.scale;
  auto frame = [&](int r) { return r < f ? r : f - 1; };
  for (int seq = warp; seq < n_eff * a.hg; seq += WARPS) {
    const int col0 = (seq / a.hg) * width + (seq % a.hg) * d;
#pragma unroll 1
    for (int mt = 0; mt < FT; ++mt) {
      // ---- logits (base 2): 16 query frames x FT * 16 key frames
      float sc[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
      const bf16* qrow = sq + frame(16 * mt + l8 + 8 * m1) * a.stride + col0;
      int k0 = 0;
      for (; k0 + 16 <= d; k0 += 16) {
        uint32_t qa[4];
        ldsm_x4(qa, qrow + k0 + 8 * m2);
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = scale_pair(qa[r], qscale);
#pragma unroll
        for (int np = 0; np < FT; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, sk + frame(16 * np + l8 + 8 * m2) * a.stride + col0 + k0 + 8 * m1);
          mma16(sc[2 * np], qa, kb[0], kb[1]);
          mma16(sc[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
      if (k0 < d) {  // the last 8 columns (d % 16 == 8)
        uint32_t qa[2];
        ldsm_x2(qa, qrow + k0);
        qa[0] = scale_pair(qa[0], qscale);
        qa[1] = scale_pair(qa[1], qscale);
#pragma unroll
        for (int np = 0; np < FT; ++np) {
          uint32_t kb[2];
          ldsm_x2(kb, sk + frame(16 * np + l8 + 8 * m1) * a.stride + col0 + k0);
          mma8(sc[2 * np], qa, kb[0]);
          mma8(sc[2 * np + 1], qa, kb[1]);
        }
      }

      // ---- softmax; sc[t][2i + j] holds query row 16 mt + lane / 4 + 8i,
      // key frame 8t + 2 quad + j
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (8 * t + 2 * quad + (e & 1) >= f) sc[t][e] = neg_inf();
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[t][e]);
        }
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[t][e] - mx[e >> 1]);
          sc[t][e] = p;
          l[e >> 1] += p;  // the unrounded p
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      }
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
      // p rounded to bf16 as the PV A fragments, k-step kc = key frames
      // [16 kc, 16 kc + 16)
      uint32_t pa[FT][4];
#pragma unroll
      for (int kc = 0; kc < FT; ++kc) {
        pa[kc][0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
        pa[kc][1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
        pa[kc][2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
        pa[kc][3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
      }

      // ---- O = P V in chunks of 32 columns, x 1 / sum(p), into sq
      __syncwarp();
      const int r0 = 16 * mt + lane / 4;
      for (int c0 = 0; c0 < d; c0 += 32) {
        const int nd = min(4, (d - c0) / 8);  // column tiles of 8 in the chunk
        float o[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < FT; ++kc) {
          const bf16* vrow = sv + frame(16 * kc + l8 + 8 * m1) * a.stride + col0 + c0;
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {
            if (2 * pr + 1 < nd) {
              uint32_t vb[4];
              ldsm_x4_t(vb, vrow + 16 * pr + 8 * m2);
              mma16(o[2 * pr], pa[kc], vb[0], vb[1]);
              mma16(o[2 * pr + 1], pa[kc], vb[2], vb[3]);
            } else if (2 * pr < nd) {
              uint32_t vb[2];
              ldsm_x2_t(vb, vrow + 16 * pr);
              mma16(o[2 * pr], pa[kc], vb[0], vb[1]);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (t >= nd) continue;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = r0 + 8 * i;
            if (r >= f) continue;
            *reinterpret_cast<uint32_t*>(sq + r * a.stride + col0 + c0 + 8 * t + 2 * quad) =
                pack_bf16(o[t][2 * i] * inv[i], o[t][2 * i + 1] * inv[i]);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- store: 16 bytes a thread, coalesced
  for (int i = threadIdx.x; i < f * vecs; i += THREADS) {
    const int fi = i / vecs;
    const int vi = i - fi * vecs;
    *reinterpret_cast<uint4*>(a.o + gofs(fi, vi)) =
        *reinterpret_cast<const uint4*>(sq + fi * a.stride + vi * 8);
  }
}

template <int FT>
cudaError_t launch_ft(const TemporalMmaArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = size_t(3) * a.frames * a.stride * sizeof(bf16);
  cudaError_t err = set_smem(temporal_kernel_mma<FT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((a.s + a.n - 1) / a.n) * (a.heads / a.hg), batch);
  temporal_kernel_mma<FT><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Shared memory a block aims at: q, k and v of the block in at most this
// many bytes, so three blocks share an SM's 227 KB.
constexpr size_t kTemporalBlockBytes = 72 * 1024;

cudaError_t temporal_fwd_mma(const void* q, const void* k, const void* v, void* o, int batch,
                             int frames, int s, int heads, int d, float scale2,
                             cudaStream_t stream) {
  if (d % 8 != 0 || frames < 1 || frames > 64 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(o))
    return cudaErrorInvalidValue;
  // positions per block, or, where one position of all heads is too large,
  // the largest group of heads (a divisor of heads) that fits
  const size_t per_head = size_t(3) * frames * d * sizeof(bf16);
  const size_t per_pos = per_head * heads;
  int n = 1, hg = heads;
  if (per_pos <= kTemporalBlockBytes) {
    n = static_cast<int>(kTemporalBlockBytes / per_pos);
    n = n > 8 ? 8 : n;
    n = n > s ? s : n;
  } else {
    hg = 1;
    for (int g = heads; g >= 1; --g)
      if (heads % g == 0 && per_head * g <= kTemporalBlockBytes) {
        hg = g;
        break;
      }
  }
  int units = n * hg * d / 8;  // 16-byte units of one frame's span
  units |= 1;                  // an odd count: conflict-free ldmatrix rows
  TemporalMmaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<bf16*>(o), frames, s, heads, d,
                    n, hg, units * 8,
                    __bfloat162float(__float2bfloat16(scale2))};
  switch ((frames + 15) / 16) {
    case 1: return launch_ft<1>(a, batch, stream);
    case 2: return launch_ft<2>(a, batch, stream);
    case 3: return launch_ft<3>(a, batch, stream);
    default: return launch_ft<4>(a, batch, stream);
  }
}

}  // namespace aniportrait
