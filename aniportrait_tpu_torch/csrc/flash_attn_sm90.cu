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
#include <cuda.h>

#include "flash_fwd.cuh"

namespace aniportrait {
namespace {

using bf16 = __nv_bfloat16;

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

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait for the completion of the barrier's phase of this parity; a wait of
// more than 10 s can only be a fault (a tile lands in microseconds), so it
// traps: the launch fails with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - start > 10000000000ull) __trap();
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// generic-proxy shared-memory writes made visible to wgmma / TMA (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier 1 + wg over the 128 threads of consumer warpgroup wg
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// wgmma shared-memory descriptor, no swizzle: core matrices of 8 rows x 16
// bytes; lbo = bytes between core matrices along K, sbo = along M / N
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across a wgmma
// fence or wait
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ANIPORTRAIT_F8(d, i)                                                          \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),    \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ANIPORTRAIT_F32(d, i)                           \
  ANIPORTRAIT_F8(d, i), ANIPORTRAIT_F8(d, i + 8),       \
      ANIPORTRAIT_F8(d, i + 16), ANIPORTRAIT_F8(d, i + 24)

// D(64 x N, float32) (+)= A(64 x 16, smem) B(16 x N, smem), both K-major;
// acc = 0 overwrites D
template <int N>
__device__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ANIPORTRAIT_F32(d, 0)
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ANIPORTRAIT_F32(d, 0), ANIPORTRAIT_F32(d, 32)
      : "l"(da), "l"(db), "r"(acc));
}

// D(64 x N, float32) += A(64 x 16, bf16 registers) B(16 x N, smem, MN-major)
template <int N>
__device__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ANIPORTRAIT_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ANIPORTRAIT_F8(d, 0), ANIPORTRAIT_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : ANIPORTRAIT_F8(d, 0), ANIPORTRAIT_F8(d, 8), ANIPORTRAIT_F8(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ANIPORTRAIT_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ANIPORTRAIT_F32
#undef ANIPORTRAIT_F8

// 2^x on the SFU alone (exp2f adds denormal handling around it); results
// below 2^-126 flush to 0, far under any row sum's last bit
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The producer warp's scalar path: rows [row0, row0 + rows) of one (batch
// row, head) slice into the core-matrix layout (chunk c of 8 columns at
// c * rows * 8 elements, row r at r * 8), zero past `limit` rows and d
// columns.  All 32 lanes take part.
template <int NCH>
__device__ void copy_tile(bf16* dst, const bf16* src, int ld, int row0, int rows, int limit,
                          int d) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < rows * NCH; i += 32) {
    const int c = i / rows;
    const int r = i - c * rows;
    const bool row_ok = row0 + r < limit;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c * 8 + 2 * e;
      const bf16* p = src + static_cast<size_t>(row0 + r) * ld + col;
      const float lo = row_ok && col < d ? __bfloat162float(p[0]) : 0.f;
      const float hi = row_ok && col + 1 < d ? __bfloat162float(p[1]) : 0.f;
      w[e] = pack_bf16(lo, hi);
    }
    *reinterpret_cast<uint4*>(dst + (static_cast<size_t>(c) * rows + r) * 8) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

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
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library does not link libcuda itself
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// a (batch, rows, heads, d) bf16 tensor as the 4-D map (d, heads, rows,
// batch) with boxes of 8 columns x box_rows rows of one head and batch row
bool encode_map(CUtensorMap* map, const void* base, int batch, int rows, int heads, int d,
                int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(heads) * d * 2,
                                 static_cast<cuuint64_t>(rows) * heads * d * 2};
  const cuuint32_t box[4] = {8, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

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
