// Short-sequence attention on Hopper's tensor cores, shared by the temporal
// kernel K3 (temporal_attn_sm90.cu) and the short-sequence kernels K6 and K9
// (small_seq_attn_sm90.cu):
//   * attend_warp: one warp attends one sequence of at most 16 FT rows held
//     in shared memory.  QK^T and PV by mma.sync m16n8k16 bf16 (m16n8k8 for
//     a head dim's last 8 columns), operands by ldmatrix (.trans for V); the
//     rows are padded to a multiple of 16, rows and columns past the
//     sequence masked and their addresses clamped to its last row, so
//     nothing uninitialised is read.  Softmax in registers: a row lives in
//     the 4 lanes of a quad.  The output overwrites the sequence's own q.
//   * strided_block: the block of K3 and K6, one batch row, a run of n
//     sequences and a group of hg heads, all f rows of each.  One row of the
//     block's sequences is n contiguous spans of hg * d channels (one span
//     where hg = heads), copied with 16-byte cp.async into shared memory, so
//     every input byte is read once and each warp's requests cover whole
//     32-byte sectors; the output leaves the same way.  K3 and K6 differ only
//     in the strides: K3's rows are frames (s * c apart) and its sequences
//     positions (c apart); K6's rows are a sequence's contiguous rows (C
//     apart) and its sequences those runs (seq * C apart).
//   * rows sit an odd number of 16-byte units apart in shared memory, so
//     ldmatrix's eight row addresses hit eight different bank groups.
// Nothing crosses blocks and nothing is added atomically: results repeat
// bit for bit.
#pragma once

#include "sm90.cuh"

namespace aniportrait {

constexpr int kSeqThreads = 256;
constexpr int kSeqWarps = kSeqThreads / 32;
// Shared memory a block aims at: its q, k and v in at most this many bytes,
// so three blocks share an SM's 227 KB.
constexpr size_t kSeqBlockBytes = 72 * 1024;

// One sequence as its warp sees it: row r of q, k, v at q / k / v +
// r * stride, d columns (d % 8 == 0), f rows.  Rows from `live` on are dead
// padding (K9's n_valid_rows): a live row attends columns < live, a dead row
// all f columns.  live = f (every row live) for K3 and K6.
struct SeqTile {
  bf16* q;
  const bf16* k;
  const bf16* v;
  int stride, f, d, live;
};

// The two rounding contracts:
//   BASE_E = false, K3 and K6 (_nat_kernel, _ctg_kernel): q x qscale rounded
//     to bf16 (qscale = log2(e) / sqrt(d), itself rounded to bf16), logits
//     summed in float32, p = exp2(logit - row max), p rounded to bf16 for
//     PV, the float32 PV sum x 1 / sum(unrounded p).
//   BASE_E = true, K9 (_small_seq_kernel): q arrives pre-scaled (qscale
//     unused), p = exp(logit - row max) with masked p exactly 0, and
//     p / sum(p) rounded to bf16 for PV.
template <int FT, bool BASE_E>
__device__ __forceinline__ void attend_warp(const SeqTile& s, float qscale) {
  constexpr int NT = 2 * FT;  // logit column tiles of 8 rows
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;
  const int l8 = lane & 7;
  const int m1 = (lane >> 3) & 1;  // ldmatrix: matrix 1 or 3 of the four
  const int m2 = lane >> 4;        // matrix 2 or 3
  const int f = s.f, d = s.d;
  auto row = [&](int r) { return (r < f ? r : f - 1) * s.stride; };
  const int mts = (f + 15) / 16;
#pragma unroll 1
  for (int mt = 0; mt < mts; ++mt) {
    // ---- logits: 16 query rows x FT * 16 key rows
    float sc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
    const bf16* qrow = s.q + row(16 * mt + l8 + 8 * m1);
    int k0 = 0;
    for (; k0 + 16 <= d; k0 += 16) {
      uint32_t qa[4];
      ldsm_x4(qa, qrow + k0 + 8 * m2);
      if (!BASE_E) {
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = scale_pair(qa[r], qscale);
      }
#pragma unroll
      for (int np = 0; np < FT; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, s.k + row(16 * np + l8 + 8 * m2) + k0 + 8 * m1);
        mma16(sc[2 * np], qa, kb[0], kb[1]);
        mma16(sc[2 * np + 1], qa, kb[2], kb[3]);
      }
    }
    if (k0 < d) {  // the last 8 columns (d % 16 == 8)
      uint32_t qa[2];
      ldsm_x2(qa, qrow + k0);
      if (!BASE_E) {
        qa[0] = scale_pair(qa[0], qscale);
        qa[1] = scale_pair(qa[1], qscale);
      }
#pragma unroll
      for (int np = 0; np < FT; ++np) {
        uint32_t kb[2];
        ldsm_x2(kb, s.k + row(16 * np + l8 + 8 * m1) + k0);
        mma8(sc[2 * np], qa, kb[0]);
        mma8(sc[2 * np + 1], qa, kb[1]);
      }
    }

    // ---- softmax; sc[t][2i + j] holds query row 16 mt + lane / 4 + 8i,
    // key row 8t + 2 quad + j
    const int r0 = 16 * mt + lane / 4;
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * t + 2 * quad + (e & 1);
        bool masked = col >= f;
        if (BASE_E) masked |= r0 + 8 * (e >> 1) < s.live && col >= s.live;
        if (masked) sc[t][e] = neg_inf();
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
        const float p = BASE_E ? expf(sc[t][e] - mx[e >> 1]) : exp2f(sc[t][e] - mx[e >> 1]);
        sc[t][e] = p;
        l[e >> 1] += p;  // the unrounded p
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    float inv[2] = {1.f / l[0], 1.f / l[1]};
    if (BASE_E) {  // normalised before the rounding; the PV sum stands as it is
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[t][e] = sc[t][e] / l[e >> 1];
      inv[0] = inv[1] = 1.f;
    }
    // p rounded to bf16 as the PV A fragments, k-step kc = key rows
    // [16 kc, 16 kc + 16)
    uint32_t pa[FT][4];
#pragma unroll
    for (int kc = 0; kc < FT; ++kc) {
      pa[kc][0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
      pa[kc][1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
      pa[kc][2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
      pa[kc][3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
    }

    // ---- O = P V in chunks of 32 columns, x inv, over this m-tile's q rows
    // (every lane has read them by now)
    __syncwarp();
    for (int c0 = 0; c0 < d; c0 += 32) {
      const int nd = min(4, (d - c0) / 8);  // column tiles of 8 in the chunk
      float o[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < FT; ++kc) {
        const bf16* vrow = s.v + row(16 * kc + l8 + 8 * m1) + c0;
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
          *reinterpret_cast<uint32_t*>(s.q + r * s.stride + c0 + 8 * t + 2 * quad) =
              pack_bf16(o[t][2 * i] * inv[i], o[t][2 * i + 1] * inv[i]);
        }
      }
    }
  }
}

// The block of K3 and K6 (see the note at the top).  Row fi of sequence p,
// head h of batch row b starts at global element
// (b * f + fi) * frame_stride + p * pos_stride + h * d.
struct StridedArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int frames;  // rows of a sequence, 1 ... 64
  int s;       // sequences of a batch row
  int heads, d;
  long long frame_stride, pos_stride;  // elements
  int n;       // sequences per block
  int hg;      // heads per block
  int stride;  // elements between rows in shared memory
  float scale;  // base-2 softmax scale (log2(e) / sqrt(d)), rounded to bf16
};

// grid (ceil(s / n) * heads / hg, batch); smem holds q, k, v of the block
template <int FT>
__device__ __forceinline__ void strided_block(const StridedArgs& a, bf16* smem) {
  const int f = a.frames, d = a.d;
  const int groups = a.heads / a.hg;
  const int run = blockIdx.x / groups;
  const int h0 = (blockIdx.x - run * groups) * a.hg;
  const int p0 = run * a.n;
  const int b = blockIdx.y;
  const int n_eff = min(a.n, a.s - p0);
  const int width = a.hg * d;          // one sequence's channels in the block
  const int vecs = n_eff * width / 8;  // 16-byte vectors per row
  bf16* sq = smem;
  bf16* sk = sq + f * a.stride;
  bf16* sv = sk + f * a.stride;

  // ---- load: every row's spans, 16 bytes a thread, coalesced
  auto gofs = [&](int fi, int vi) {
    const int pi = vi / (width / 8);
    const int cc = (vi - pi * (width / 8)) * 8;
    return static_cast<size_t>(b * f + fi) * a.frame_stride +
           static_cast<size_t>(p0 + pi) * a.pos_stride + h0 * d + cc;
  };
  for (int i = threadIdx.x; i < f * vecs; i += kSeqThreads) {
    const int fi = i / vecs;
    const int vi = i - fi * vecs;
    const size_t g = gofs(fi, vi);
    const int sofs = fi * a.stride + vi * 8;
    cp_async16(sq + sofs, a.q + g);
    cp_async16(sk + sofs, a.k + g);
    cp_async16(sv + sofs, a.v + g);
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- one warp per (sequence, head)
  for (int seq = threadIdx.x / 32; seq < n_eff * a.hg; seq += kSeqWarps) {
    const int col0 = (seq / a.hg) * width + (seq % a.hg) * d;
    attend_warp<FT, false>(SeqTile{sq + col0, sk + col0, sv + col0, a.stride, f, d, f},
                           a.scale);
  }
  __syncthreads();

  // ---- store: 16 bytes a thread, coalesced
  for (int i = threadIdx.x; i < f * vecs; i += kSeqThreads) {
    const int fi = i / vecs;
    const int vi = i - fi * vecs;
    *reinterpret_cast<uint4*>(a.o + gofs(fi, vi)) =
        *reinterpret_cast<const uint4*>(sq + fi * a.stride + vi * 8);
  }
}

// The block shape for strided_block: a run of n sequences (at most 8) when
// all heads of one fit the budget, else the largest group of heads (a
// divisor of heads) that fits; rows an odd number of 16-byte units apart.
inline StridedArgs strided_layout(const void* q, const void* k, const void* v, void* o,
                                  int frames, int s, int heads, int d, long long frame_stride,
                                  long long pos_stride, float scale2) {
  const size_t per_head = size_t(3) * frames * d * sizeof(bf16);
  const size_t per_pos = per_head * heads;
  int n = 1, hg = heads;
  if (per_pos <= kSeqBlockBytes) {
    n = static_cast<int>(kSeqBlockBytes / per_pos);
    n = n > 8 ? 8 : n;
    n = n > s ? s : n;
  } else {
    hg = 1;
    for (int g = heads; g >= 1; --g)
      if (heads % g == 0 && per_head * g <= kSeqBlockBytes) {
        hg = g;
        break;
      }
  }
  const int units = (n * hg * d / 8) | 1;  // an odd count: conflict-free ldmatrix rows
  return StridedArgs{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<bf16*>(o), frames, s, heads, d,
                     frame_stride, pos_stride, n, hg, units * 8,
                     __bfloat162float(__float2bfloat16(scale2))};
}

}  // namespace aniportrait
