// Flash-attention forward, bf16 form, on Hopper's tensor cores (sm_90a):
// wgmma for both products, TMA tile loads into a two-stage shared-memory
// ring fed by a producer warp.  The C entry points of flash_attn.cu send
// every bf16 call here (float32 runs flash_attn.cu's FMA kernel), so this
// kernel replaces the same Pallas TPU kernels of
// aniportrait_tpu/ops/pallas_attention.py in every softmax mode:
//   K1  _tok_flash_banked_impl (two KV segments: own keys, then the bank at
//       row b / rep), K2 flash_attention_tokens_unshifted in its running-max
//       form, K4 _flash_nopad (rows in drop_tail stop at kv_split), K5a
//       _flash_fwd_impl with want_lse (float32 LSE, 0 for a fully masked
//       row), and the fixed-shift modes K7 (NOSHIFT_E), K8 (BOUNDED_2) and
//       K2u (UNSHIFTED_2) with their guards and the predicated running-max
//       fallback launch (see flash_attn.cu for the contracts).
//
// Arithmetic, in the order of the Pallas body (pallas_attention.py:79-97):
// logits = (q . k, bf16 products summed in float32) x scale, the scale on
// the float32 accumulator (base 2: scale * log2(e), exp2); running max and
// sum in float32; l sums the unrounded p; p rounded to bf16 for PV, as the
// TPU kernels round it.  The fixed-shift modes keep flash_attn.cu's
// contracts (K7 sums the rounded p; K2u rounds q x its rounded multiplier at
// the load).
//
// What bounds it on an H100: at the main path's shapes the work is
// 4*Sq*Skv*d FLOPs per head against (Sq + 2 Skv) * d loaded elements, far
// above the card's ~295 FLOP/byte ridge: the tensor cores (989 TFLOP/s bf16)
// bound it.  The design:
//   * one block = 128 query rows of one (batch row, head): two consumer
//     warpgroups of 64 rows and one producer warp (288 threads).  ptxas
//     gives such a block 168 registers a thread (it counts whole
//     warpgroups).  The KV loop runs inside the block over the two segments'
//     tiles of BKV keys (128 for head tiles up to 128, else 64: O, S and P
//     take 176 registers a thread at DP = 256, so DP >= 224 spills).
//   * loads: the producer's lane 0 issues TMA copies from 4-D tensor maps
//     (d, heads, S, B) -- the bank's with (d, heads, S_bank, B / rep) -- into
//     a ring of two K/V stages, completion on mbarriers (K and V apart, so
//     QK^T starts before V lands); consumers free a stage with one arrival
//     per warp.  Each box is 8 columns (16 bytes) x the tile's rows, which
//     lays a tile out as wgmma's unswizzled core matrices (8 rows x 16
//     bytes, contiguous); the tensor map's end zero-fills the ragged last
//     tile, and the head tile's pad columns (DP = round_up(d, 16) > d) are
//     zeroed once in shared memory and never loaded.  Head dims that are not
//     a multiple of 8 (or unaligned bases) cannot be TMA'd: the producer warp
//     then copies the same layout with scalar loads (no real model has them).
//   * QK^T: wgmma m64 n BKV k16, Q and K both K-major from shared memory,
//     float32 accumulators in registers.  Masks go by column index (kv_split
//     inside segment 0, the segment's end), never by the zero fill.
//   * softmax in registers: a row lives in the 4 lanes of a quad, so the max
//     reduces with two shuffles; l stays a per-lane partial sum, reduced once
//     at the end.
//   * PV: P converted in registers into bf16 A fragments (the accumulator's
//     layout is the A operand's), V as an MN-major B operand (transpose bit),
//     O += P V with wgmma m64 n{64,48,32,16} k16 over DP.
//   * epilogue: divide by l, the LSE, the guard (per-warp vote, one atomicOr
//     per warp), bf16 stores.
#include "flash_fwd.cuh"
#include "sm90.cuh"

namespace aniportrait {
namespace {

constexpr int BQ = 128;        // query rows per block
constexpr int WG_ROWS = 64;    // query rows per consumer warpgroup
constexpr int CONSUMERS = 256; // two warpgroups
constexpr int THREADS = CONSUMERS + 32;
constexpr int STAGES = 2;

template <int DP>
struct Tile {
  static constexpr int BKV = DP <= 128 ? 128 : 64;
  static constexpr int NCH = DP / 8;  // 16-byte column chunks of a row
  static constexpr size_t Q_BYTES = size_t(BQ) * DP * 2;
  static constexpr size_t KV_BYTES = size_t(BKV) * DP * 2;
  static constexpr size_t BAR_BYTES = 128;  // 7 mbarriers, padded
  static constexpr size_t SMEM = BAR_BYTES + Q_BYTES + 2 * STAGES * KV_BYTES;
};

struct alignas(64) Sm90Params {
  CUtensorMap tq, tk, tv, tkb, tvb;
  FlashArgs a;
  int tma;  // 1: TMA loads; 0: the producer warp's scalar loads
};

// ------------------------------------------------------------------ kernel
template <int DP, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ Sm90Params p) {
  using TL = Tile<DP>;
  constexpr int BKV = TL::BKV;
  constexpr int NCH = TL::NCH;
  const FlashArgs& a = p.a;
  if (MODE == RUNMAX && a.pred != nullptr && *a.pred == 0) return;

  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // q, kfull[2], vfull[2], empty[2]
  bf16* sQ = reinterpret_cast<bf16*>(smem + TL::BAR_BYTES);
  bf16* sK = reinterpret_cast<bf16*>(smem + TL::BAR_BYTES + TL::Q_BYTES);
  bf16* sV = sK + STAGES * BKV * DP;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_kfull = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto bar_vfull = [&](int s) { return smem_u32(&bars[3 + s]); };
  auto bar_empty = [&](int s) { return smem_u32(&bars[5 + s]); };

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d = a.d;
  const int ld = a.heads * d;
  const int nchl = (d + 7) / 8;  // chunks holding data; the rest stay zero

  // tiles: segment 0 (own keys, kv_split for dropped rows), then the bank
  const int len0 = (a.drop != nullptr && a.drop[b] != 0) ? a.kv_split : a.skv;
  const int n0 = (len0 + BKV - 1) / BKV;
  const int n_tiles = n0 + (a.kb != nullptr ? (a.sbank + BKV - 1) / BKV : 0);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_kfull(s), 1);
      mbar_init(bar_vfull(s), 1);
      mbar_init(bar_empty(s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the pad chunks [nchl, NCH) of Q and of every K / V stage: zero, once
  if (nchl < NCH) {
    const int pad = NCH - nchl;
    for (int i = tid; i < pad * BQ; i += THREADS)
      reinterpret_cast<uint4*>(sQ)[nchl * BQ + i] = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < 2 * STAGES * pad * BKV; i += THREADS) {
      const int t = i / (pad * BKV);
      reinterpret_cast<uint4*>(sK + t * BKV * DP)[nchl * BKV + i - t * pad * BKV] =
          make_uint4(0, 0, 0, 0);
    }
    fence_async_smem();
  }
  __syncthreads();

  const bf16* gq = static_cast<const bf16*>(a.q) + static_cast<size_t>(b) * a.sq * ld + h * d;
  if (tid >= CONSUMERS) {
    // ======================================================== producer warp
    const int lane = tid & 31;
    const int bb = b / a.rep;
    if (p.tma) {
      if (lane == 0) {
        mbar_expect_tx(bar_q, nchl * BQ * 16);
        for (int c = 0; c < nchl; ++c)
          tma_load_4d(smem_u32(sQ + c * BQ * 8), &p.tq, bar_q, c * 8, h, q0, b);
      }
    } else {
      copy_tile<NCH>(sQ, gq, ld, q0, BQ, a.sq, d);
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_q);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(bar_empty(s), ((t / STAGES) & 1) ^ 1);
      const bool bank = t >= n0;
      const int k0 = (bank ? t - n0 : t) * BKV;
      bf16* dk = sK + s * BKV * DP;
      bf16* dv = sV + s * BKV * DP;
      if (p.tma) {
        if (lane == 0) {
          const CUtensorMap* mk = bank ? &p.tkb : &p.tk;
          const CUtensorMap* mv = bank ? &p.tvb : &p.tv;
          const int row_b = bank ? bb : b;
          mbar_expect_tx(bar_kfull(s), nchl * BKV * 16);
          for (int c = 0; c < nchl; ++c)
            tma_load_4d(smem_u32(dk + c * BKV * 8), mk, bar_kfull(s), c * 8, h, k0, row_b);
          mbar_expect_tx(bar_vfull(s), nchl * BKV * 16);
          for (int c = 0; c < nchl; ++c)
            tma_load_4d(smem_u32(dv + c * BKV * 8), mv, bar_vfull(s), c * 8, h, k0, row_b);
        }
      } else {
        const size_t rows = bank ? a.sbank : a.skv;
        const size_t off = static_cast<size_t>(bank ? bb : b) * rows * ld + h * d;
        const bf16* gk = static_cast<const bf16*>(bank ? a.kb : a.k) + off;
        const bf16* gv = static_cast<const bf16*>(bank ? a.vb : a.v) + off;
        const int len = bank ? a.sbank : len0;
        copy_tile<NCH>(dk, gk, ld, k0, BKV, len, d);
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_kfull(s));
        copy_tile<NCH>(dv, gv, ld, k0, BKV, len, d);
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_vfull(s));
      }
    }
  } else {
    // ================================================ consumer warpgroups
    const int wg = tid / 128;
    const int warp = (tid & 127) / 32;
    const int lane = tid & 31;
    const int quad = lane & 3;
    const int r0 = q0 + wg * WG_ROWS + warp * 16 + lane / 4;  // and r0 + 8

    mbar_wait(bar_q, 0);
    if (MODE == UNSHIFTED_2) {
      // q x its dtype-rounded multiplier, rounded to bf16: this warpgroup's
      // 64 rows, in place (pad columns stay 0)
      const float qm = round_as<bf16>(a.scale_log2);
      for (int i = tid & 127; i < WG_ROWS * DP; i += 128) {
        const int c = i / (WG_ROWS * 8);
        const int rem = i - c * WG_ROWS * 8;
        bf16* x = sQ + c * BQ * 8 + wg * WG_ROWS * 8 + rem;
        *x = __float2bfloat16(__bfloat162float(*x) * qm);
      }
      fence_async_smem();
      warpgroup_sync(wg);
    }
    const float mult = a.scale_log2;  // RUNMAX: the logits' multiplier
    float bnd[2] = {0.f, 0.f};
    if (MODE == BOUNDED_2) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (r0 + 8 * i < a.sq)
          bnd[i] = a.bound[(static_cast<size_t>(b) * a.sq + r0 + 8 * i) * a.heads + h];
    }

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {neg_inf(), neg_inf()};
    float l[2] = {0.f, 0.f};  // per-lane partial sums; reduced at the end

    const uint32_t q_base = smem_u32(sQ) + wg * WG_ROWS * 16;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const bool bank = t >= n0;
      const int k0 = (bank ? t - n0 : t) * BKV;
      const int len = bank ? a.sbank : len0;
      const uint32_t k_base = smem_u32(sK + s * BKV * DP);
      const uint32_t v_base = smem_u32(sV + s * BKV * DP);

      // ---- S = Q K^T
      float sc[BKV / 2];
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
      mbar_wait(bar_kfull(s), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss<BKV>(sc, make_desc(q_base + kk * 2 * BQ * 16, BQ * 16, 128),
                      make_desc(k_base + kk * 2 * BKV * 16, BKV * 16, 128), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BKV / 2>(sc);

      // ---- softmax; register 4g + 2i + j holds row r0 + 8i, column
      // 8g + 2 quad + j of the tile
      // (RUNMAX: the max of the unscaled logits, scale > 0; m is scaled)
      const bool ragged = k0 + BKV > len;
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int g = 0; g < BKV / 8; ++g)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float x = sc[4 * g + 2 * i + j];
            if (ragged && k0 + 8 * g + 2 * quad + j >= len) x = neg_inf();
            sc[4 * g + 2 * i + j] = x;
            if (MODE == RUNMAX) mx[i] = fmaxf(mx[i], x);
          }
      float alpha[2] = {1.f, 1.f};
      if (MODE == RUNMAX) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m[i], mx[i] * mult);  // finite: column k0 is valid
          alpha[i] = ex2(m[i] - m_new);
          m[i] = m_new;
          l[i] *= alpha[i];
        }
      }
#pragma unroll
      for (int g = 0; g < BKV / 8; ++g)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float x = sc[4 * g + 2 * i + j];
            float pr;
            if (MODE == RUNMAX) {
              pr = ex2(fmaf(x, mult, -m[i]));
              l[i] += pr;  // the unrounded p
            } else if (MODE == NOSHIFT_E) {
              pr = round_as<bf16>(ex2(x * kLog2e));  // expf's long sequence spills
              l[i] += pr;  // the rounded p
            } else {
              pr = ex2(MODE == BOUNDED_2 ? x - bnd[i] : x);
              l[i] += pr;  // the unrounded p
            }
            sc[4 * g + 2 * i + j] = pr;
          }
      if (MODE == RUNMAX) {
#pragma unroll
        for (int g = 0; g < DP / 8; ++g)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            o[4 * g + 2 * i] *= alpha[i];
            o[4 * g + 2 * i + 1] *= alpha[i];
          }
      }
      // P (bf16) as wgmma A fragments, k-step kk = keys [16 kk, 16 kk + 16)
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // ---- O += P V
      mbar_wait(bar_vfull(s), parity);
      fence_regs<DP / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < DP / 64; ++n)
          wgmma_rs<64>(o + 32 * n, pa[kk],
                       make_desc(v_base + kk * 256 + n * 8 * BKV * 16, 128, BKV * 16));
        if constexpr (DP % 64 != 0)
          wgmma_rs<DP % 64>(
              o + 32 * (DP / 64), pa[kk],
              make_desc(v_base + kk * 256 + (DP / 64) * 8 * BKV * 16, 128, BKV * 16));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<DP / 2>(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty(s));
    }

    // ---- epilogue
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    bf16* go = static_cast<bf16*>(a.o) + static_cast<size_t>(b) * a.sq * ld + h * d;
    bool bad = false;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= a.sq) continue;
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // RUNMAX
      const float safe = l[i] == 0.f ? 1.f : l[i];      // the fixed shifts
      if (MODE == RUNMAX) {
        if (a.lse != nullptr && quad == 0)
          a.lse[(static_cast<size_t>(b) * a.heads + h) * a.sq + r] =
              l[i] > 0.f ? kLn2 * (m[i] + log2f(l[i])) : 0.f;
      } else {
        // the guard of the Pallas caller; !(l > 1e-30) also catches NaN
        bad |= !(l[i] > 1e-30f);
        if (MODE != BOUNDED_2) bad |= !isfinite(l[i]);
      }
#pragma unroll
      for (int g = 0; g < DP / 8; ++g)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * g + 2 * quad + j;
          if (col >= d) continue;
          const float acc = o[4 * g + 2 * i + j];
          const float x = MODE == RUNMAX ? acc * inv : acc / safe;
          // K7 tests the stored output, K2u the float32 one before the store
          if (MODE == NOSHIFT_E) bad |= !isfinite(round_as<bf16>(x));
          if (MODE == UNSHIFTED_2) bad |= !isfinite(x);
          go[static_cast<size_t>(r) * ld + col] = __float2bfloat16(x);
        }
    }
    if (MODE != RUNMAX) {
      if (__any_sync(0xffffffffu, bad) && lane == 0) atomicOr(a.guard, 1);
    }
  }
}

// ------------------------------------------------------------------- host
template <int DP, int MODE>
cudaError_t launch(Sm90Params& p, cudaStream_t stream) {
  using TL = Tile<DP>;
  const FlashArgs& a = p.a;
  if (p.tma) {
    const bool ok =
        encode_map(&p.tq, a.q, a.batch, a.sq, a.heads, a.d, BQ) &&
        encode_map(&p.tk, a.k, a.batch, a.skv, a.heads, a.d, TL::BKV) &&
        encode_map(&p.tv, a.v, a.batch, a.skv, a.heads, a.d, TL::BKV) &&
        (a.kb == nullptr ||
         (encode_map(&p.tkb, a.kb, a.batch / a.rep, a.sbank, a.heads, a.d, TL::BKV) &&
          encode_map(&p.tvb, a.vb, a.batch / a.rep, a.sbank, a.heads, a.d, TL::BKV)));
    if (!ok) return cudaErrorInvalidValue;
  }
  cudaError_t err = set_smem(flash_fwd_sm90_kernel<DP, MODE>, TL::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.heads, a.batch);
  flash_fwd_sm90_kernel<DP, MODE><<<grid, THREADS, TL::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_mode(Sm90Params& p, int mode, cudaStream_t stream) {
  switch (mode) {
    case RUNMAX: return launch<DP, RUNMAX>(p, stream);
    case NOSHIFT_E: return launch<DP, NOSHIFT_E>(p, stream);
    case BOUNDED_2: return launch<DP, BOUNDED_2>(p, stream);
    case UNSHIFTED_2: return launch<DP, UNSHIFTED_2>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t flash_fwd_sm90(const FlashArgs& a, int mode, cudaStream_t stream) {
  Sm90Params p = {};
  p.a = a;
  // TMA needs 16-byte strides and bases: the head slice (d * 2 bytes) and
  // every row (heads * d * 2 bytes) start on 16 bytes only if d % 8 == 0
  p.tma = a.d % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
          (a.kb == nullptr || (aligned16(a.kb) && aligned16(a.vb)));
  if (p.tma && encode_tiled() == nullptr) return cudaErrorNotSupported;
#define ANIPORTRAIT_CASE(DP) return launch_mode<DP>(p, mode, stream);
  ANIPORTRAIT_HEAD_DIM_SWITCH(a.d, ANIPORTRAIT_CASE)
#undef ANIPORTRAIT_CASE
}

}  // namespace aniportrait
