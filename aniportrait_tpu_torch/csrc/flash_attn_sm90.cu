// Flash-attention forward, bf16 form, on Hopper's tensor cores (sm_90a):
// wgmma for both products, TMA tile loads into a shared-memory ring fed by
// a producer warp, and the two consumer warpgroups on FlashAttention-3's
// schedule (Shah et al., 2024).  The C entry points of flash_attn.cu send
// every bf16 call here (float32 runs the 3xTF32 or FMA kernels), so this
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
// the load).  flash.plain_attention_tiled with flash.wgmma_block_kv(d) keys
// a step is this arithmetic in torch.
//
// What bounds it on an H100: every logit costs one exp2 on the MUFU (16 a
// clock an SM) against 4 d matrix FLOPs on the tensor cores (~4,100 a clock
// an SM in bf16), so at d = 40 (K1, K2 at 64x64: DP = 48) the exp units
// need more time than the products, ~1.3x, and at d = 80 the tensor cores
// lead.  Done one after the other, as a warpgroup's own data dependences
// order them (S = QK^T, softmax, O += PV), the two add up; the design keeps
// both busy at once:
//   * one block = 128 query rows of one (batch row, head): two consumer
//     warpgroups of 64 rows and one producer warp (288 threads; ptxas gives
//     such a block 168 registers a thread, counting whole warpgroups).  The
//     KV loop runs inside the block over the two segments' tiles.
//   * ping-pong: the warpgroups take turns to issue their products, on two
//     named barriers (bar.sync on its own, bar.arrive on the other's after
//     issuing), so one warpgroup's products run on the tensor cores while
//     the other computes its softmax.
//   * inside a warpgroup, at every head tile: at key tile t it issues S_t =
//     Q K_t^T and O += P_{t-1} V_{t-1} together, on one turn, waits for S_t
//     alone (wgmma.wait_group 1), computes tile t's softmax, then waits for
//     the PV product, rescales O and packs P_t.  Two tiles live in registers
//     at once (S_t in float32, P_{t-1} in bf16), so the tile takes BKV_WIDE
//     keys up to WIDE_MAX_DP and BKV_NARROW above; from DP = 160 (no cell
//     runs bf16 above 128) O alone is 80-128 registers and ptxas spills 8
//     to 1040 bytes.  ptxas (CUDA 12, sm_90a) schedules the PV wait ahead of the softmax's
//     exponentials, so the product overlaps only the masking and part of
//     the row max; a form that keeps the wait behind them (waited for in
//     the next iteration's basic block) measured slower at d = 40 (K1 2.52
//     against 2.32 ms) and equal at d = 80, and is not used.
//   * loads: the producer's lane 0 issues each Q, K or V tile as one TMA box
//     of a 5-D map (8, S, d / 8, heads, B) -- the bank's with B / rep rows --
//     which lands in wgmma's unswizzled core-matrix layout (8 rows x 16
//     bytes, contiguous) with the head tile's pad columns (DP = round_up(d,
//     16) > d) and a ragged last tile zero-filled by the copy itself.  The
//     ring has as many K/V stages as 227 KB hold (up to MAX_STAGES); K and V
//     complete on mbarriers apart, so QK^T starts before V lands; consumers
//     free a stage with one arrival per warp once its PV product is done.
//     Head dims that are not a multiple of 8 (or unaligned bases) cannot be
//     TMA'd: the producer warp then copies the same layout with scalar
//     loads (no real model has them).
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
//     per warp), bf16 stores (two columns a store).
// The roofline share at d = 40 that counts matrix FLOPs and bytes alone
// cannot pass ~65 %: the exp2 count holds the kernel above that.
#include "flash_fwd.cuh"
#include "sm90.cuh"

namespace aniportrait {
namespace {

constexpr int BQ = 128;        // query rows per block
constexpr int WG_ROWS = 64;    // query rows per consumer warpgroup
constexpr int CONSUMERS = 256; // two warpgroups
constexpr int THREADS = CONSUMERS + 32;
constexpr int PING_BAR = 3;    // named barrier 3 + wg: warpgroup wg's turn (1 + wg: its own sync)

// The tile table (aniportrait_flash_sm90_shape reports the block it gives;
// ops/kernels/flash.py:wgmma_block_kv repeats BKV for the plain version).
constexpr int BKV_WIDE = 128;         // keys a tile up to WIDE_MAX_DP
constexpr int BKV_NARROW = 64;        // keys a tile above it
constexpr int WIDE_MAX_DP = 80;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;    // 227 KB, a block's most on sm_90
constexpr int BAR_BYTES = 256;        // 1 + 3 x MAX_STAGES mbarriers, padded

template <int DP>
struct Tile {
  static constexpr int BKV = DP <= WIDE_MAX_DP ? BKV_WIDE : BKV_NARROW;
  static constexpr int NCH = DP / 8;  // 16-byte column chunks of a row
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BKV * DP * 2;
  static constexpr int FIT = (SMEM_LIMIT - BAR_BYTES - Q_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = BAR_BYTES + Q_BYTES + 2 * STAGES * KV_BYTES;
  static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "the ring needs two stages");
};

struct alignas(64) Sm90Params {
  CUtensorMap tq, tk, tv, tkb, tvb;
  FlashArgs a;
  int tma;  // 1: TMA loads; 0: the producer warp's scalar loads
};

// S = Q K^T for one key tile, issued (not waited for) and committed
template <int DP, int BKV>
__device__ __forceinline__ void issue_qk(float (&sc)[BKV / 2], uint32_t q_base,
                                         uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss<BKV>(sc, make_desc(q_base + kk * 2 * BQ * 16, BQ * 16, 128),
                  make_desc(k_base + kk * 2 * BKV * 16, BKV * 16, 128), kk > 0);
  wgmma_commit();
}

// O += P V for one key tile, issued (not waited for) and committed
template <int DP, int BKV>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2], const uint32_t (&pa)[BKV / 16][4],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
    for (int n = 0; n < DP / 64; ++n)
      wgmma_rs<64>(o + 32 * n, pa[kk],
                   make_desc(v_base + kk * 256 + n * 8 * BKV * 16, 128, BKV * 16));
    if constexpr (DP % 64 != 0)
      wgmma_rs<DP % 64>(o + 32 * (DP / 64), pa[kk],
                        make_desc(v_base + kk * 256 + (DP / 64) * 8 * BKV * 16, 128, BKV * 16));
  }
  wgmma_commit();
}

// One tile's softmax in place: S (float32 logits) -> p, with the running max
// m and the partial sums l updated and alpha the factor O takes (RUNMAX; 1
// in the fixed shifts).  Register 4g + 2i + j holds row r0 + 8i, column
// 8g + 2 quad + j of the tile; columns at or past `len` are masked.
template <int BKV, int MODE>
__device__ __forceinline__ void softmax_tile(float (&sc)[BKV / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int len, int quad,
                                             float mult, const float (&bnd)[2]) {
  if (k0 + BKV > len) {
#pragma unroll
    for (int g = 0; g < BKV / 8; ++g)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (k0 + 8 * g + 2 * quad + j >= len) sc[4 * g + 2 * i + j] = neg_inf();
  }
  alpha[0] = alpha[1] = 1.f;
  if (MODE == RUNMAX) {
    // the max of the unscaled logits (scale > 0); m is scaled
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int g = 0; g < BKV / 8; ++g)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mx[i] = fmaxf(mx[i], fmaxf(sc[4 * g + 2 * i], sc[4 * g + 2 * i + 1]));
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
}

// O x alpha (RUNMAX), then P (bf16) as wgmma A fragments: k-step kk = keys
// [16 kk, 16 kk + 16)
template <int DP, int BKV, int MODE>
__device__ __forceinline__ void rescale_pack(float (&o)[DP / 2], uint32_t (&pa)[BKV / 16][4],
                                             const float (&sc)[BKV / 2], const float (&alpha)[2]) {
  if (MODE == RUNMAX) {
#pragma unroll
    for (int g = 0; g < DP / 8; ++g)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * g + 2 * i] *= alpha[i];
        o[4 * g + 2 * i + 1] *= alpha[i];
      }
  }
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// ------------------------------------------------------------------ kernel
template <int DP, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ Sm90Params p) {
  using TL = Tile<DP>;
  constexpr int BKV = TL::BKV;
  constexpr int NCH = TL::NCH;
  constexpr int STAGES = TL::STAGES;
  const FlashArgs& a = p.a;
  if (MODE == RUNMAX && a.pred != nullptr && *a.pred == 0) return;

  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // q, kfull[], vfull[], empty[]
  bf16* sQ = reinterpret_cast<bf16*>(smem + BAR_BYTES);
  bf16* sK = reinterpret_cast<bf16*>(smem + BAR_BYTES + TL::Q_BYTES);
  bf16* sV = sK + STAGES * BKV * DP;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_kfull = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto bar_vfull = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };
  auto bar_empty = [&](int s) { return smem_u32(&bars[1 + 2 * STAGES + s]); };

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d = a.d;
  const int ld = a.heads * d;

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
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ======================================================== producer warp
    const int lane = tid & 31;
    const int bb = b / a.rep;
    if (p.tma) {
      if (lane == 0) {
        mbar_expect_tx(bar_q, TL::Q_BYTES);
        tma_load_5d(smem_u32(sQ), &p.tq, bar_q, 0, q0, 0, h, b);
      }
    } else {
      const bf16* gq = static_cast<const bf16*>(a.q) + static_cast<size_t>(b) * a.sq * ld + h * d;
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
          const int row_b = bank ? bb : b;
          mbar_expect_tx(bar_kfull(s), TL::KV_BYTES);
          tma_load_5d(smem_u32(dk), bank ? &p.tkb : &p.tk, bar_kfull(s), 0, k0, 0, h, row_b);
          mbar_expect_tx(bar_vfull(s), TL::KV_BYTES);
          tma_load_5d(smem_u32(dv), bank ? &p.tvb : &p.tv, bar_vfull(s), 0, k0, 0, h, row_b);
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
      named_sync(1 + wg, 128);
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
    float alpha[2];
    float sc[BKV / 2];
    uint32_t pa[BKV / 16][4];

    const uint32_t q_base = smem_u32(sQ) + wg * WG_ROWS * 16;
    auto k_base = [&](int s) { return smem_u32(sK + s * BKV * DP); };
    auto v_base = [&](int s) { return smem_u32(sV + s * BKV * DP); };
    auto tile_k0 = [&](int t) { return (t >= n0 ? t - n0 : t) * BKV; };
    auto tile_len = [&](int t) { return t >= n0 ? a.sbank : len0; };
    // ping-pong: issue products on this warpgroup's turn, then hand it on
    const int my_turn = PING_BAR + wg, other_turn = PING_BAR + 1 - wg;

    // Phase t issues S_t = Q K_t^T (t < n) and O += P_{t-1} V_{t-1} (t > 0):
    // n + 1 phases, each taken on this warpgroup's turn.  Warpgroup 0 goes
    // first; warpgroup 1 hands the turn back after each phase but its last,
    // so every arrival meets a sync.
    if (n_tiles > 0) {
      if (wg == 1) named_arrive(PING_BAR, 2 * 128);

      // phase 0: S_0 and its softmax
      mbar_wait(bar_kfull(0), 0);
      named_sync(my_turn, 2 * 128);
      wgmma_fence();
      issue_qk<DP, BKV>(sc, q_base, k_base(0));
      named_arrive(other_turn, 2 * 128);
      wgmma_wait<0>();
      fence_regs<BKV / 2>(sc);
      softmax_tile<BKV, MODE>(sc, m, l, alpha, tile_k0(0), tile_len(0), quad, mult, bnd);
      rescale_pack<DP, BKV, MODE>(o, pa, sc, alpha);

      for (int t = 1; t < n_tiles; ++t) {
        const int s = t % STAGES, sp = (t - 1) % STAGES;
        mbar_wait(bar_kfull(s), (t / STAGES) & 1);
        mbar_wait(bar_vfull(sp), ((t - 1) / STAGES) & 1);
        named_sync(my_turn, 2 * 128);
        fence_regs<DP / 2>(o);
        wgmma_fence();
        issue_qk<DP, BKV>(sc, q_base, k_base(s));
        issue_pv<DP, BKV>(o, pa, v_base(sp));
        named_arrive(other_turn, 2 * 128);
        wgmma_wait<1>();  // S_t alone (ptxas places the PV wait early: see above)
        fence_regs<BKV / 2>(sc);
        softmax_tile<BKV, MODE>(sc, m, l, alpha, tile_k0(t), tile_len(t), quad, mult, bnd);
        wgmma_wait<0>();
        fence_regs<DP / 2>(o);
        fence_regs<BKV / 4>(&pa[0][0]);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty(sp));
        rescale_pack<DP, BKV, MODE>(o, pa, sc, alpha);
      }

      // phase n: the last PV product
      const int sl = (n_tiles - 1) % STAGES;
      mbar_wait(bar_vfull(sl), ((n_tiles - 1) / STAGES) & 1);
      named_sync(my_turn, 2 * 128);
      fence_regs<DP / 2>(o);
      wgmma_fence();
      issue_pv<DP, BKV>(o, pa, v_base(sl));
      if (wg == 0) named_arrive(other_turn, 2 * 128);
      wgmma_wait<0>();
      fence_regs<DP / 2>(o);
    }

    // ---- epilogue
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    bf16* go = static_cast<bf16*>(a.o) + static_cast<size_t>(b) * a.sq * ld + h * d;
    // two columns a store where d is even (rows and the head slice then
    // start on 4 bytes)
    const bool pairs = (d % 2 == 0) && (reinterpret_cast<uintptr_t>(a.o) & 3) == 0;
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
      for (int g = 0; g < DP / 8; ++g) {
        const int col = 8 * g + 2 * quad;
        if (col >= d) continue;
        float x[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float acc = o[4 * g + 2 * i + j];
          x[j] = MODE == RUNMAX ? acc * inv : acc / safe;
          if (col + j >= d) continue;
          // K7 tests the stored output, K2u the float32 one before the store
          if (MODE == NOSHIFT_E) bad |= !isfinite(round_as<bf16>(x[j]));
          if (MODE == UNSHIFTED_2) bad |= !isfinite(x[j]);
        }
        bf16* dst = go + static_cast<size_t>(r) * ld + col;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x[0], x[1]);
        } else {
          dst[0] = __float2bfloat16(x[0]);
          if (col + 1 < d) dst[1] = __float2bfloat16(x[1]);
        }
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
    const int n = TL::NCH, bkv = TL::BKV;
    const bool ok =
        encode_chunk_map(&p.tq, a.q, a.batch, a.sq, a.heads, a.d, BQ, n) &&
        encode_chunk_map(&p.tk, a.k, a.batch, a.skv, a.heads, a.d, bkv, n) &&
        encode_chunk_map(&p.tv, a.v, a.batch, a.skv, a.heads, a.d, bkv, n) &&
        (a.kb == nullptr ||
         (encode_chunk_map(&p.tkb, a.kb, a.batch / a.rep, a.sbank, a.heads, a.d, bkv, n) &&
          encode_chunk_map(&p.tvb, a.vb, a.batch / a.rep, a.sbank, a.heads, a.d, bkv, n)));
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

// The block at head tile DP, as the launch takes it: {DP, BKV, stages,
// dynamic shared memory, threads, blocks an SM (the occupancy API)}.
template <int DP>
cudaError_t shape_of(int* shape) {
  using TL = Tile<DP>;
  cudaError_t err = set_smem(flash_fwd_sm90_kernel<DP, RUNMAX>, TL::SMEM);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flash_fwd_sm90_kernel<DP, RUNMAX>, THREADS, TL::SMEM);
  const int out[6] = {DP, TL::BKV, TL::STAGES, TL::SMEM, THREADS, blocks};
  for (int i = 0; i < 6; ++i) shape[i] = out[i];
  return err;
}

}  // namespace

cudaError_t flash_fwd_sm90(const FlashArgs& a, int mode, cudaStream_t stream) {
  Sm90Params p = {};
  p.a = a;
  // TMA needs 16-byte strides and bases: the head slice (d * 2 bytes) and
  // every row (heads * d * 2 bytes) start on 16 bytes only if d % 8 == 0;
  // and a map of no rows is refused (no keys: every row fully masked)
  p.tma = a.d % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
          a.sq > 0 && a.skv > 0 &&
          (a.kb == nullptr || (aligned16(a.kb) && aligned16(a.vb) && a.sbank > 0));
  if (p.tma && encode_tiled() == nullptr) return cudaErrorNotSupported;
#define ANIPORTRAIT_CASE(DP) return launch_mode<DP>(p, mode, stream);
  ANIPORTRAIT_HEAD_DIM_SWITCH(a.d, ANIPORTRAIT_CASE)
#undef ANIPORTRAIT_CASE
}

}  // namespace aniportrait

// The bf16 forward's block at head dim d (no launch): int[6] as shape_of
// fills it.  Returns a cudaError_t code.
extern "C" int aniportrait_flash_sm90_shape(int d, int* shape) {
  using namespace aniportrait;
#define ANIPORTRAIT_CASE(DP) return static_cast<int>(shape_of<DP>(shape));
  ANIPORTRAIT_HEAD_DIM_SWITCH(d, ANIPORTRAIT_CASE)
#undef ANIPORTRAIT_CASE
}
