// Flash-attention backward, bf16 form, on Hopper's tensor cores (sm_90a):
// one kernel in FlashAttention-2's order plus a conversion of the dq
// workspace.  The C entry point of flash_bwd.cu sends every bf16 call with
// d <= 128 here (float32, and bf16 above 128, keep the FMA kernels of
// flash_bwd.cu).
//
// Replaces K5b of aniportrait_tpu/ops/pallas_attention.py, the Pallas
// kernels of _flash_bwd_kernels (_dq_kernel and _dkv_kernel), with their
// function and rounding contract: p = exp(s * scale - lse) from the
// forward's float32 LSE, delta = rowsum(do * o) from the wrapper (a torch
// reduction, as on the TPU where XLA computes it outside the kernels),
// ds = p (dp - delta) scale; p and ds rounded to bf16 before the products
// that take them (pallas_attention.py:148, :191, :199); masks by index:
// drop_tail rows ignore keys >= kv_split, rows past Sq and keys past the
// row's length never count (the JAX need_qmask, :184-188), whatever the
// tensor map's zero fill puts in the tile.
//
// What bounds it on an H100: five products of 2 * Sq * Skv * d FLOPs per
// (batch row, head) -- S^T and dP^T recomputed, then dV, dK and dQ -- 2.5x
// the forward's 4 * Sq * Skv * d; at the training shapes (B = 2, 4096
// queries over 8192 keys, d = 40 padded to 48) that is far above the card's
// ~295 FLOP/byte ridge, so the tensor cores bound it (989 TFLOP/s bf16).
// The design:
//   * one block = 64 key rows of one (batch row, head): one consumer
//     warpgroup and one producer warp (160 threads).  dK and dV live in the
//     warpgroup's float32 registers for the whole block; the block walks
//     the query tiles of 64 rows.  A key tile that lies wholly past a
//     dropped row's kv_split does no work and writes its zero dK, dV.
//   * loads: the producer's lane 0 issues TMA copies (flash_attn_sm90.cu's
//     (d, heads, S, B) tensor maps, 8-column boxes that land as wgmma's
//     unswizzled core matrices): K and V once, Q and dO through a ring of
//     two stages on mbarriers; the producer's 32 lanes write the tile's
//     lse * log2(e) and delta beside them before lane 0 arms the stage.
//     Head dims that are not a multiple of 8 take the scalar loader.
//   * per query tile, with wgmma (m64, k16):
//       S^T  = K Q^T            (K, Q K-major from shared memory, n64)
//       dP^T = V dO^T           (n64)
//       P^T  = exp2(S^T scale log2e - lse log2e), masked; dS^T = P^T (dP^T -
//              delta) scale; both rounded to bf16 A fragments in registers
//              (the accumulator's layout is the A operand's)
//       dV  += P^T dO           (dO MN-major through the transpose bit)
//       dK  += dS^T Q           (Q MN-major)
//       dQ_partial = dS K       (dS^T stored to shared memory as an
//              MN-major A operand, K MN-major: both transpose bits), in
//              64-column chunks to bound the registers.
//     The logits are scaled on the float32 accumulator: q is not pre-scaled
//     (in bf16 that would round it).
//   * dQ: each block stages its partial for the query tile in shared memory
//     (float32, DP to a row) and one thread adds it to a zeroed float32
//     workspace (B, heads, Sq, DP) with one bulk reduction
//     (cp.reduce.async.bulk .add.f32: the tile's rows are contiguous there),
//     which the L2 carries out; the conversion kernel then writes dq in
//     bf16.  Per-element atomics (RED) in its place made the training
//     shape 2.1x slower (2.28 against 1.08 ms on an H100).  The
//     float32 sums take the blocks in whatever order they run, so dq's low
//     bits vary from run to run (within a bf16 step of its largest value);
//     dK and dV are summed in registers in a fixed order and do not vary.
#include "flash_bwd.cuh"
#include "sm90.cuh"

namespace aniportrait {
namespace {

constexpr int BKV = 64;         // key rows per block (one warpgroup's M)
constexpr int BQ = 64;          // query rows per step
constexpr int CONSUMERS = 128;  // one warpgroup
constexpr int THREADS = CONSUMERS + 32;
constexpr int STAGES = 2;

template <int DP>
struct BwdTile {
  static constexpr int NCH = DP / 8;  // 16-byte column chunks of a row
  static constexpr size_t BAR_BYTES = 128;  // 5 mbarriers, padded
  static constexpr size_t KV_BYTES = size_t(BKV) * DP * 2;
  static constexpr size_t Q_BYTES = size_t(BQ) * DP * 2;
  static constexpr size_t DS_BYTES = size_t(BQ) * BKV * 2;
  static constexpr size_t STAT_BYTES = size_t(STAGES) * BQ * 4;
  static constexpr size_t DQ_BYTES = size_t(BQ) * DP * 4;
  static constexpr size_t SMEM =
      BAR_BYTES + 2 * KV_BYTES + 2 * STAGES * Q_BYTES + DS_BYTES + 2 * STAT_BYTES + DQ_BYTES;
};

struct alignas(64) BwdSm90Params {
  CUtensorMap tq, tk, tv, tdo;
  BwdArgs a;
  int tma;  // 1: TMA loads; 0: the producer warp's scalar loads
};

// Stores a 64 x N accumulator chunk into the row-major dQ tile (DP floats a
// row) at column n0: register 4g + 2i + j holds row warp * 16 + lane / 4 +
// 8i, column 8g + 2 quad + j.
template <int DP, int N>
__device__ __forceinline__ void stage_dq(float* sdq, const float* acc, int n0, int warp,
                                         int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int g = 0; g < N / 8; ++g)
      *reinterpret_cast<float2*>(sdq + (warp * 16 + lane / 4 + 8 * i) * DP + n0 + 8 * g +
                                 2 * (lane & 3)) =
          make_float2(acc[4 * g + 2 * i], acc[4 * g + 2 * i + 1]);
}

// global[0, bytes) += shared[0, bytes), float32, carried out by the L2
__device__ __forceinline__ void bulk_reduce_add(float* dst, const float* src, uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// the issuing thread's bulk reductions have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ BwdSm90Params p) {
  using TL = BwdTile<DP>;
  constexpr int NCH = TL::NCH;
  const BwdArgs& a = p.a;

  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // kv, full[2], empty[2]
  bf16* sK = reinterpret_cast<bf16*>(smem + TL::BAR_BYTES);
  bf16* sV = sK + BKV * DP;
  bf16* sQ = sV + BKV * DP;             // [STAGES][BQ * DP]
  bf16* sDO = sQ + STAGES * BQ * DP;    // [STAGES][BQ * DP]
  bf16* sDS = sDO + STAGES * BQ * DP;   // dS^T as an MN-major A operand
  float* sL = reinterpret_cast<float*>(sDS + BQ * BKV);  // [STAGES][BQ] lse log2e
  float* sDl = sL + STAGES * BQ;                         // [STAGES][BQ] delta
  float* sDQ = sDl + STAGES * BQ;                        // [BQ][DP] dQ partial
  const uint32_t bar_kv = smem_u32(&bars[0]);
  auto bar_full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto bar_empty = [&](int s) { return smem_u32(&bars[3 + s]); };

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d = a.d;
  const int ld = a.heads * d;
  const int nchl = (d + 7) / 8;  // chunks holding data; the rest stay zero
  const int len = kv_len(a, b);
  const int n_q = k0 < len ? (a.sq + BQ - 1) / BQ : 0;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the pad chunks [nchl, NCH) of K, V and every Q / dO stage (all tiles of
  // 64 rows, contiguous from sK): zero, once
  if (nchl < NCH) {
    const int pad = NCH - nchl;
    constexpr int TILES = 2 + 2 * STAGES;
    for (int i = tid; i < TILES * pad * 64; i += THREADS) {
      const int t = i / (pad * 64);
      reinterpret_cast<uint4*>(sK + t * 64 * DP)[nchl * 64 + i - t * pad * 64] =
          make_uint4(0, 0, 0, 0);
    }
    fence_async_smem();
  }
  __syncthreads();

  const size_t stat = (static_cast<size_t>(b) * a.heads + h) * a.sq;
  if (tid >= CONSUMERS) {
    // ======================================================== producer warp
    const int lane = tid & 31;
    if (n_q == 0) return;
    const size_t koff = static_cast<size_t>(b) * a.skv * ld + h * d;
    const size_t qoff = static_cast<size_t>(b) * a.sq * ld + h * d;
    if (p.tma) {
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * nchl * BKV * 16);
        for (int c = 0; c < nchl; ++c) {
          tma_load_4d(smem_u32(sK + c * BKV * 8), &p.tk, bar_kv, c * 8, h, k0, b);
          tma_load_4d(smem_u32(sV + c * BKV * 8), &p.tv, bar_kv, c * 8, h, k0, b);
        }
      }
    } else {
      copy_tile<NCH>(sK, static_cast<const bf16*>(a.k) + koff, ld, k0, BKV, a.skv, d);
      copy_tile<NCH>(sV, static_cast<const bf16*>(a.v) + koff, ld, k0, BKV, a.skv, d);
      fence_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_kv);
    }
    for (int t = 0; t < n_q; ++t) {
      const int s = t % STAGES;
      const int q0 = t * BQ;
      if (t >= STAGES) mbar_wait(bar_empty(s), ((t / STAGES) & 1) ^ 1);
      for (int r = lane; r < BQ; r += 32) {
        const bool in = q0 + r < a.sq;
        sL[s * BQ + r] = in ? a.lse[stat + q0 + r] * kLog2e : 0.f;
        sDl[s * BQ + r] = in ? a.delta[stat + q0 + r] : 0.f;
      }
      bf16* dq_tile = sQ + s * BQ * DP;
      bf16* do_tile = sDO + s * BQ * DP;
      if (p.tma) {
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(bar_full(s), 2 * nchl * BQ * 16);
          for (int c = 0; c < nchl; ++c) {
            tma_load_4d(smem_u32(dq_tile + c * BQ * 8), &p.tq, bar_full(s), c * 8, h, q0, b);
            tma_load_4d(smem_u32(do_tile + c * BQ * 8), &p.tdo, bar_full(s), c * 8, h, q0, b);
          }
        }
      } else {
        copy_tile<NCH>(dq_tile, static_cast<const bf16*>(a.q) + qoff, ld, q0, BQ, a.sq, d);
        copy_tile<NCH>(do_tile, static_cast<const bf16*>(a.dout) + qoff, ld, q0, BQ, a.sq, d);
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_full(s));
      }
    }
    return;
  }

  // ==================================================== consumer warpgroup
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int rk = warp * 16 + lane / 4;  // this lane's key rows rk and rk + 8
  const float scale_log2 = a.scale * kLog2e;
  bool kvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kvalid[i] = k0 + rk + 8 * i < len;

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

  const uint32_t k_base = smem_u32(sK);
  const uint32_t v_base = smem_u32(sV);
  const uint32_t ds_base = smem_u32(sDS);
  if (n_q > 0) mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_q; ++t) {
    const int s = t % STAGES;
    const int q0 = t * BQ;
    const uint32_t q_base = smem_u32(sQ + s * BQ * DP);
    const uint32_t do_base = smem_u32(sDO + s * BQ * DP);
    mbar_wait(bar_full(s), (t / STAGES) & 1);

    // ---- S^T = K Q^T and dP^T = V dO^T; register 4g + 2i + j holds key
    // row rk + 8i, query column 8g + 2 quad + j of the tile
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<BQ>(st, make_desc(k_base + kk * 2 * BKV * 16, BKV * 16, 128),
                   make_desc(q_base + kk * 2 * BQ * 16, BQ * 16, 128), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<BQ>(dpt, make_desc(v_base + kk * 2 * BKV * 16, BKV * 16, 128),
                   make_desc(do_base + kk * 2 * BQ * 16, BQ * 16, 128), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BQ / 2>(st);
    fence_regs<BQ / 2>(dpt);

    // ---- P^T and dS^T (float32), masked by index
    const float* L = sL + s * BQ;
    const float* Dl = sDl + s * BQ;
#pragma unroll
    for (int g = 0; g < BQ / 8; ++g)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * g + 2 * quad + j;
        const bool qok = q0 + col < a.sq;
        const float lse2 = L[col];
        const float dl = Dl[col];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 4 * g + 2 * i + j;
          const float pr = qok && kvalid[i] ? ex2(fmaf(st[r], scale_log2, -lse2)) : 0.f;
          st[r] = pr;
          dpt[r] = pr * (dpt[r] - dl) * a.scale;
        }
      }
    // bf16 A fragments, k-step kk = queries [16 kk, 16 kk + 16)
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        dsa[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }

    // ---- dS^T to shared memory, MN-major for dQ's A operand: element
    // (query q, key k) at ((q / 8) * BKV + k) * 8 + q % 8.  The previous
    // tile's dQ products are done reading it (every thread waited on them).
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
#pragma unroll
    for (int g = 0; g < BQ / 8; ++g)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(sDS + (g * BKV + rk + 8 * i) * 8 + 2 * quad) =
            pack_bf16(dpt[4 * g + 2 * i], dpt[4 * g + 2 * i + 1]);
    fence_async_smem();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");

    // ---- dV += P^T dO, dK += dS^T Q, and the first dQ chunk
    constexpr int N0 = DP < 64 ? DP : 64;
    float dq[N0 / 2];
#pragma unroll
    for (int i = 0; i < N0 / 2; ++i) dq[i] = 0.f;
    fence_regs<DP / 2>(dv);
    fence_regs<DP / 2>(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < DP / 64; ++n) {
        wgmma_rs<64>(dv + 32 * n, pa[kk],
                     make_desc(do_base + kk * 256 + n * 8 * BQ * 16, 128, BQ * 16));
        wgmma_rs<64>(dk + 32 * n, dsa[kk],
                     make_desc(q_base + kk * 256 + n * 8 * BQ * 16, 128, BQ * 16));
      }
      if constexpr (DP % 64 != 0) {
        wgmma_rs<DP % 64>(dv + 32 * (DP / 64), pa[kk],
                          make_desc(do_base + kk * 256 + (DP / 64) * 8 * BQ * 16, 128, BQ * 16));
        wgmma_rs<DP % 64>(dk + 32 * (DP / 64), dsa[kk],
                          make_desc(q_base + kk * 256 + (DP / 64) * 8 * BQ * 16, 128, BQ * 16));
      }
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_ss_tt<N0>(dq, make_desc(ds_base + kk * 256, 128, BKV * 16),
                      make_desc(k_base + kk * 256, 128, BKV * 16), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(dv);
    fence_regs<DP / 2>(dk);
    fence_regs<N0 / 2>(dq);
    // Q and dO of this stage are read: hand it back to the producer
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(s));

    // ---- dQ: the partial through shared memory, one bulk reduction into
    // the workspace rows [q0, q0 + rows) of (b, h)
    if (tid == 0) bulk_wait_read();  // the previous tile's reduction read sDQ
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    stage_dq<DP, N0>(sDQ, dq, 0, warp, lane);
    if constexpr (DP > 64) {
      constexpr int N1 = DP - 64;
      float dq1[N1 / 2];
#pragma unroll
      for (int i = 0; i < N1 / 2; ++i) dq1[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_ss_tt<N1>(dq1, make_desc(ds_base + kk * 256, 128, BKV * 16),
                        make_desc(k_base + kk * 256 + 8 * BKV * 16, 128, BKV * 16), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<N1 / 2>(dq1);
      stage_dq<DP, N1>(sDQ, dq1, 64, warp, lane);
    }
    fence_async_smem();
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (tid == 0) {
      const int rows = a.sq - q0 < BQ ? a.sq - q0 : BQ;
      bulk_reduce_add(a.dq_ws + (stat + q0) * DP, sDQ, static_cast<uint32_t>(rows) * DP * 4);
    }
  }
  // shared memory must outlive the last reduction's reads
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  // ---- epilogue: dK, dV in bf16 (zero for keys the row never sees)
  const size_t koff = static_cast<size_t>(b) * a.skv * ld + h * d;
  bf16* gdk = static_cast<bf16*>(a.dk) + koff;
  bf16* gdv = static_cast<bf16*>(a.dv) + koff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = k0 + rk + 8 * i;
    if (r >= a.skv) continue;
#pragma unroll
    for (int g = 0; g < DP / 8; ++g)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * g + 2 * quad + j;
        if (col >= d) continue;
        gdk[static_cast<size_t>(r) * ld + col] = __float2bfloat16(dk[4 * g + 2 * i + j]);
        gdv[static_cast<size_t>(r) * ld + col] = __float2bfloat16(dv[4 * g + 2 * i + j]);
      }
  }
}

// dq (B, sq, heads, d) in bf16 from the float32 workspace (B, heads, sq, dp)
__global__ void flash_bwd_dq_convert_kernel(const float* ws, bf16* dq, int batch, int sq,
                                            int heads, int d, int dp) {
  const size_t n = static_cast<size_t>(batch) * sq * heads * d;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t r = i / d;  // (b * sq + s) * heads + h
    const size_t h = r % heads;
    const size_t bs = r / heads;
    const size_t b = bs / sq;
    dq[i] = __float2bfloat16(ws[((b * heads + h) * sq + bs - b * sq) * dp + (i - r * d)]);
  }
}

// ------------------------------------------------------------------- host
template <int DP>
cudaError_t launch(BwdSm90Params& p, cudaStream_t stream) {
  using TL = BwdTile<DP>;
  static_assert(TL::SMEM <= 232448, "backward tiles exceed the shared memory of a block");
  const BwdArgs& a = p.a;
  if (p.tma) {
    const bool ok = encode_map(&p.tq, a.q, a.batch, a.sq, a.heads, a.d, BQ) &&
                    encode_map(&p.tdo, a.dout, a.batch, a.sq, a.heads, a.d, BQ) &&
                    encode_map(&p.tk, a.k, a.batch, a.skv, a.heads, a.d, BKV) &&
                    encode_map(&p.tv, a.v, a.batch, a.skv, a.heads, a.d, BKV);
    if (!ok) return cudaErrorInvalidValue;
  }
  cudaError_t err = set_smem(flash_bwd_sm90_kernel<DP>, TL::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.skv + BKV - 1) / BKV, a.heads, a.batch);
  flash_bwd_sm90_kernel<DP><<<grid, THREADS, TL::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t blocks = (static_cast<size_t>(a.batch) * a.sq * a.heads * a.d + 255) / 256;
  flash_bwd_dq_convert_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0,
                                stream>>>(a.dq_ws, static_cast<bf16*>(a.dq), a.batch, a.sq,
                                          a.heads, a.d, DP);
  return cudaGetLastError();
}

}  // namespace

cudaError_t flash_bwd_sm90(const BwdArgs& a, cudaStream_t stream) {
  BwdSm90Params p = {};
  p.a = a;
  // TMA needs 16-byte strides and bases (see flash_attn_sm90.cu)
  p.tma = a.d % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
          aligned16(a.dout);
  if (p.tma && encode_tiled() == nullptr) return cudaErrorNotSupported;
  switch ((a.d + 15) / 16) {
    case 1: return launch<16>(p, stream);
    case 2: return launch<32>(p, stream);
    case 3: return launch<48>(p, stream);
    case 4: return launch<64>(p, stream);
    case 5: return launch<80>(p, stream);
    case 6: return launch<96>(p, stream);
    case 7: return launch<112>(p, stream);
    case 8: return launch<128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace aniportrait
