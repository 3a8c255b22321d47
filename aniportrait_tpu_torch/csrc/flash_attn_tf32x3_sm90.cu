// Flash-attention forward, float32 form for head dims up to 128: the
// function of flash_attn.cu's FMA kernel (the same FlashArgs, all four
// softmax modes with their guards and the predicated RUNMAX fallback, the
// bank segment, drop_tail / kv_split, ragged S, q pre-multiplied by
// scale * log2(e) and exp2), computed on Hopper's tensor cores in 3xTF32.
// The C entry points of flash_attn.cu send every float32 call with d <= 128
// here; the FMA kernel keeps float32 above 128, which no path of the port
// takes.
//
// Replaces, in float32, the Pallas TPU kernels of
// aniportrait_tpu/ops/pallas_attention.py that the flash forward serves:
// K4 _flash_nopad / _fwd_kernel_nopad (:318; wav2vec2's self-attention on
// the audio path), K5a _flash_fwd_impl (:388), K2 / K2b (:1098 / :759), K1
// _tok_flash_banked_impl (:1556), K7 (:896), K8 (:1287) and K2's TPU form.
//
// Accuracy.  A float32 operand x is split as x = big + small, big =
// tf32(x) rounded to nearest with ties away from zero (cvt.rna.tf32.f32's
// rounding, done by an integer add: see split_tf32), small = x - big (exact
// in float32) truncated to tf32 by the tensor cores themselves, so |x - big
// - small| < 2^-21 |x|.  Each product sums small*big + big*small, then
// big*big (mma.sync m16n8k8 tf32: a product of two 11-bit significands is
// exact); only small*small (< 2^-22 |xy|) and the split's residuals are
// dropped, so ~20-21 bits of each product survive against float32's 24,
// where one TF32 product keeps ~11.  The tensor cores' float32 sums
// truncate, and a sum over all keys loses a bit or more per thousand terms,
// so each tile's P V goes into fresh accumulators and is added to the
// running output on the FMA units (round to nearest); the logits are fresh
// per tile anyway.
// ops/kernels/flash.py:plain_attention_tf32x3 is this arithmetic in torch
// (tests/test_torch_flash_tf32x3.py holds it to the exact softmax and JAX).
//
// What bounds it on an H100: at wav2vec2's shapes (B=1, 12 heads, d=64,
// S = 1024 ... 1800) the work is 4 S^2 d FLOPs a head against 4 S d inputs,
// compute bound.  Three TF32 products per float32 product put the tensor
// cores' ceiling at 495 / 3 = 165 TFLOP/s (the FMA units: 67), a rate only
// wgmma reaches; mma.sync issues from each warp, and every product brings
// its operand loads and splits, so the kernel is bound by instruction issue
// and the HMMA pipe together (PERF.md has the times).
//
// Design:
//   * one block = 64 query rows of one (batch row, head): 4 row groups of 16
//     rows, and for d <= 64 two warps a row group, each taking half of
//     every KV tile's keys (8 warps; above 64, one warp, 4 warps a block),
//     so twice the warps hide each other's latency at B=1's small grids.
//     A row's online softmax state lives in the 4 lanes of a quad (m in
//     each, l as per-lane partial sums); at the end the second warp's m, l
//     and o go through shared memory to the first, lane for lane, which
//     merges them (RUNMAX rescales both by their maxima) and stores.
//   * q (times the mode's multiplier) is split once into shared memory,
//     big and small apart; each k-step reads a warp's A fragments from it.
//   * K and V tiles (64 keys; 32 above d = 64, to bound registers) pass
//     through a two-stage ring filled by cp.async (16-byte copies when d % 4
//     == 0 and the operands are 16-byte aligned, else 4-byte ones; rows past
//     the segment and columns past d zero filled), so one tile's loads
//     overlap the previous tile's products; one __syncthreads a tile.  The
//     bank segment (K1) continues the same ring after the row's own keys.
//     K and V fragments are split in registers as they are read.
//   * no shuffles move P from the accumulator layout (row g: columns 2t,
//     2t+1 of each 8) to the A layout (columns t, t+4), and no shared tile
//     either: a product's contraction order is free, so each k-step's 8
//     keys are permuted, A column t <-> key 2t, column t+4 <-> key 2t+1.
//     P's accumulators then are its A fragments as they stand, and V's B
//     fragment reads rows 2t and 2t+1.  QK^T permutes the head dim the same
//     way, so a K (and q) fragment is one 8-byte load (columns 2t, 2t+1).
//   * shared-memory strides: K and q rows DP | 8 apart (8-byte loads of a
//     half warp on 32 distinct banks), V rows DP + 4 apart (rows 2t, 2t + 1
//     of the 4 quads on distinct banks).
//   * why not wgmma: wgmma in tf32 takes B only K-major from shared memory
//     and reads raw float32 bits there, so V needs a transposed copy and K
//     and V each a second "small" copy in shared memory; mma.sync splits
//     its fragments in registers and needs neither.  It is the next step
//     (ROADMAP 2b).
//   * occupancy at d = 64: two stages of 8,960 floats and q's 9,216, 108.5
//     KB a block, and 128 registers a thread (ptxas caps it there), so 2
//     blocks (16 warps) an SM.  S = 1024 gives 16 x 12 = 192 blocks on 132
//     SMs (60 carry two); S = 1800 29 x 12 = 348, in 1.3 waves.
#include "flash_fwd.cuh"
#include "sm90.cuh"

namespace aniportrait {
namespace {

constexpr int kRowGroups = 4;         // 16-row groups a block
constexpr int kBQ = 16 * kRowGroups;  // query rows a block
constexpr int kStages = 2;

// The block's shape at head tile DP (aniportrait_flash_tf32x3_shape reports
// it; ops/kernels/flash.py:tf32x3_block_kv repeats BKV for the plain
// version, and tests/test_torch_cuda.py holds the two together).
template <int DP>
struct Tf32Tile {
  static constexpr int BKV = DP <= 64 ? 64 : 32;  // keys a tile
  // warps sharing a row group, each taking a slice of every tile's keys
  static constexpr int KVW = DP <= 64 ? 2 : 1;
  static constexpr int KEYS = BKV / KVW;  // keys a warp takes of a tile
  static constexpr int THREADS = 32 * kRowGroups * KVW;
  static constexpr int MIN_BLOCKS = DP <= 64 ? 65536 / (THREADS * 128) : 1;
  static constexpr int LDK = DP % 16 == 0 ? DP + 8 : DP;  // K and q rows (floats), = 8 mod 16
  static constexpr int LDV = DP + 4;                       // V rows, = 4 mod 8
  static constexpr int STAGE = BKV * (LDK + LDV);          // floats a stage
  static constexpr int QSPLIT = 2 * kBQ * LDK;             // q's big and small parts
  static constexpr size_t SMEM = sizeof(float) * (kStages * STAGE + QSPLIT);
};

// x = big + small as tf32 operands: big = tf32(x) rounded to nearest with
// ties away from zero (cvt.rna.tf32.f32's rounding), small = x - big.  A
// tf32 operand is the top 19 bits of its register; the tensor cores ignore
// the low 13.  So one integer add of half the dropped field's weight
// (0x1000) to the bit pattern rounds big's magnitude, with the carry into
// the exponent, and its low bits need no clearing; big's value (the bits
// cleared) is subtracted exactly in float32, and small goes in as it stands,
// truncated by the tensor cores (< 2^-21 |x| against rounding's 2^-22, and
// no instruction).  cvt.rna itself has no single instruction on sm_90a: it
// compiles to a compare-and-select sequence.  Inf and NaN: x - big is NaN,
// the card's 0x7fffffff, which small keeps, so every product with such an
// operand is NaN whatever big became (the add carries that same NaN's bit
// pattern into the sign bit: -0 as a tf32 operand).  Rounding small by the
// add as well would lose the NaN the same way.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// D(16 x 8, float32) += A(16 x 8) B(8 x 8), tf32
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c (+)= a * b in 3xTF32: the two small products first, then big * big
__device__ __forceinline__ void mma_3x(float* c, const uint32_t* ab, const uint32_t* as,
                                       const uint32_t* bb, const uint32_t* bs) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// 16-byte (4-byte) copy into shared memory; src_bytes = 0 zero fills
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The KV tiles of a block, the row's own keys and then the bank's, as one
// sequence: tile j's source rows and the segment's length.
struct KvTiles {
  const float *k0, *v0, *k1, *v1;
  int len0, len1;
  int n0;     // tiles of the first segment
  int total;  // tiles of both
};

template <int DP>
__device__ __forceinline__ void load_tile(const KvTiles& kv, int j, float* stage, int ld, int d,
                                          bool vec16) {
  using TL = Tf32Tile<DP>;
  const bool bank = j >= kv.n0;
  const int k0 = (bank ? j - kv.n0 : j) * TL::BKV;
  const float* kp = bank ? kv.k1 : kv.k0;
  const float* vp = bank ? kv.v1 : kv.v0;
  const int len = bank ? kv.len1 : kv.len0;
  float* sK = stage;
  float* sV = stage + TL::BKV * TL::LDK;
  if (vec16) {
    constexpr int NV = DP / 4;
    for (int i = threadIdx.x; i < TL::BKV * NV; i += TL::THREADS) {
      const int r = i / NV;
      const int c = (i - r * NV) * 4;
      const bool ok = k0 + r < len && c < d;  // d % 4 == 0: the vector is whole
      const size_t off = ok ? static_cast<size_t>(k0 + r) * ld + c : 0;
      cp_async16_zfill(sK + r * TL::LDK + c, kp + off, ok ? 16 : 0);
      cp_async16_zfill(sV + r * TL::LDV + c, vp + off, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < TL::BKV * DP; i += TL::THREADS) {
      const int r = i / DP;
      const int c = i - r * DP;
      const bool ok = k0 + r < len && c < d;
      const size_t off = ok ? static_cast<size_t>(k0 + r) * ld + c : 0;
      cp_async4_zfill(sK + r * TL::LDK + c, kp + off, ok ? 4 : 0);
      cp_async4_zfill(sV + r * TL::LDV + c, vp + off, ok ? 4 : 0);
    }
  }
}

template <int DP, int MODE, bool LSE>
__global__ void __launch_bounds__(Tf32Tile<DP>::THREADS, Tf32Tile<DP>::MIN_BLOCKS)
    flash_fwd_tf32x3_kernel(const FlashArgs a, const bool vec16) {
  static_assert(MODE == RUNMAX || !LSE, "the LSE is a RUNMAX output");
  using TL = Tf32Tile<DP>;
  constexpr int KS = DP / 8;        // k-steps of QK^T, n-tiles of PV
  constexpr int NT = TL::KEYS / 8;  // n-tiles of QK^T, k-steps of PV a warp takes
  if (MODE == RUNMAX && a.pred != nullptr && *a.pred == 0) return;
  extern __shared__ __align__(16) float smem[];
  float* sQb = smem + kStages * TL::STAGE;  // q's big parts, [kBQ][LDK]
  float* sQs = sQb + kBQ * TL::LDK;         // and small parts

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = warp % kRowGroups;  // row group: rows 16 rg ... 16 rg + 15 of the block
  const int kh = warp / kRowGroups;  // key slice: keys [kh KEYS, (kh + 1) KEYS) of each tile
  const int g = lane >> 2;           // fragment row (and B column)
  const int t = lane & 3;            // quad lane
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int d = a.d;
  const int ld = a.heads * d;
  const int q0 = blockIdx.x * kBQ;
  const int row0 = q0 + rg * 16 + g;  // this lane's rows: row0 and row0 + 8

  KvTiles kv;
  kv.k0 = static_cast<const float*>(a.k) + (size_t)b * a.skv * ld + h * d;
  kv.v0 = static_cast<const float*>(a.v) + (size_t)b * a.skv * ld + h * d;
  kv.len0 = (a.drop != nullptr && a.drop[b] != 0) ? a.kv_split : a.skv;
  kv.n0 = (kv.len0 + TL::BKV - 1) / TL::BKV;
  kv.k1 = kv.k0;
  kv.v1 = kv.v0;
  kv.len1 = 0;
  if (a.kb != nullptr) {
    const int bb = b / a.rep;
    kv.k1 = static_cast<const float*>(a.kb) + (size_t)bb * a.sbank * ld + h * d;
    kv.v1 = static_cast<const float*>(a.vb) + (size_t)bb * a.sbank * ld + h * d;
    kv.len1 = a.sbank;
  }
  kv.total = kv.n0 + (kv.len1 + TL::BKV - 1) / TL::BKV;

  // the first tiles' loads go out before q's
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < kv.total) load_tile<DP>(kv, j, smem + j * TL::STAGE, ld, d, vec16);
    cp_async_commit();
  }

  // q times the mode's multiplier, split once into shared memory (rows past
  // sq and columns past d zero); the first tile's barrier publishes it
  {
    const float* q = static_cast<const float*>(a.q) + (size_t)b * a.sq * ld + h * d;
    // NOSHIFT_E's base e as 2^(logit log2 e): log2(e) goes into q (expf
    // per logit would cost registers that the 128-register cap lacks)
    const float q_mult = MODE == NOSHIFT_E ? kLog2e
                         : (MODE == RUNMAX || MODE == UNSHIFTED_2) ? a.scale_log2 : 1.f;
    for (int i = threadIdx.x; i < kBQ * DP; i += TL::THREADS) {
      const int r = i / DP;
      const int c = i - r * DP;
      const float x = (q0 + r < a.sq && c < d) ? q[(size_t)(q0 + r) * ld + c] * q_mult : 0.f;
      uint32_t big, small;
      split_tf32(x, big, small);
      sQb[r * TL::LDK + c] = __uint_as_float(big);
      sQs[r * TL::LDK + c] = __uint_as_float(small);
    }
  }

  float m[2], l[2], bnd[2];
  float o[KS][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;  // this lane's part of the row sum
    bnd[i] = 0.f;
    const int r = row0 + 8 * i;
    if (MODE == BOUNDED_2 && r < a.sq) bnd[i] = a.bound[((size_t)b * a.sq + r) * a.heads + h];
  }
#pragma unroll
  for (int nd = 0; nd < KS; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  // q fragments: rows (g, g + 8) of the row group, the head dim permuted
  // within each k-step, A column t <-> 2t and t + 4 <-> 2t + 1
  const float* qb_row = sQb + (rg * 16 + g) * TL::LDK + 2 * t;
  const float* qs_row = sQs + (rg * 16 + g) * TL::LDK + 2 * t;

  for (int j = 0; j < kv.total; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j landed for every thread; tile j - 1's readers are done
    {
      const int jn = j + kStages - 1;
      if (jn < kv.total) load_tile<DP>(kv, jn, smem + (jn % kStages) * TL::STAGE, ld, d, vec16);
      cp_async_commit();
    }
    // this warp's slice of the tile; a ragged last tile may leave it empty
    const int nvalid = (j < kv.n0 ? kv.len0 - j * TL::BKV : kv.len1 - (j - kv.n0) * TL::BKV) -
                       kh * TL::KEYS;
    if (nvalid <= 0) continue;
    const float* sK = smem + (j % kStages) * TL::STAGE + kh * TL::KEYS * TL::LDK;
    const float* sV = smem + (j % kStages) * TL::STAGE + TL::BKV * TL::LDK +
                      kh * TL::KEYS * TL::LDV;

    // ---- logits: s[nt] = row (row0, row0 + 8) x key (8nt + 2t, 8nt + 2t + 1)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2 b0 = *reinterpret_cast<const float2*>(qb_row + 8 * ks);
      const float2 b8 = *reinterpret_cast<const float2*>(qb_row + 8 * TL::LDK + 8 * ks);
      const float2 s0 = *reinterpret_cast<const float2*>(qs_row + 8 * ks);
      const float2 s8 = *reinterpret_cast<const float2*>(qs_row + 8 * TL::LDK + 8 * ks);
      const uint32_t qb[4] = {__float_as_uint(b0.x), __float_as_uint(b8.x),
                              __float_as_uint(b0.y), __float_as_uint(b8.y)};
      const uint32_t qs[4] = {__float_as_uint(s0.x), __float_as_uint(s8.x),
                              __float_as_uint(s0.y), __float_as_uint(s8.y)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 kk =
            *reinterpret_cast<const float2*>(sK + (8 * nt + g) * TL::LDK + 8 * ks + 2 * t);
        uint32_t kb[2], ksm[2];
        split_tf32(kk.x, kb[0], ksm[0]);
        split_tf32(kk.y, kb[1], ksm[1]);
        mma_3x(s[nt], qb, qs, kb, ksm);
      }
    }
    if (nvalid < TL::KEYS) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * nt + 2 * t + (e & 1) >= nvalid) s[nt][e] = neg_inf();
    }

    // ---- softmax
    float alpha[2] = {1.f, 1.f};
    if (MODE == RUNMAX) {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = ex2(m[i] - mx[i]);  // 0 on the first tile (m = -inf)
        m[i] = mx[i];                    // finite: the slice's key 0 is valid
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[nt][e] - m[e >> 1]);
          s[nt][e] = p;
          l[e >> 1] += p;
        }
    } else {
      // a fixed shift: p depends on this tile alone; masked columns give 0
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = MODE == BOUNDED_2 ? s[nt][e] - bnd[e >> 1] : s[nt][e];
          const float p = ex2(x);
          s[nt][e] = p;
          l[e >> 1] += p;
        }
    }

    // ---- this tile's P V, 8 output columns at a time, in fresh accumulators
    // (a tensor-core sum of a few k-steps) added to o on the FMA units: o
    // accumulates across tiles in float32 with rounding to nearest.  k-step
    // kc's A column t is key 8kc + 2t, column t + 4 key 8kc + 2t + 1, so P's
    // accumulators are its A fragments as they stand.
    uint32_t pb[NT][4], ps[NT][4];
#pragma unroll
    for (int kc = 0; kc < NT; ++kc) {
      const float pa[4] = {s[kc][0], s[kc][2], s[kc][1], s[kc][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(pa[e], pb[kc][e], ps[kc][e]);
    }
    const float* v0 = sV + 2 * t * TL::LDV + g;
#pragma unroll
    for (int nd = 0; nd < KS; ++nd) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < NT; ++kc) {
        uint32_t vb[2], vs[2];
        split_tf32(v0[8 * kc * TL::LDV + 8 * nd], vb[0], vs[0]);
        split_tf32(v0[(8 * kc + 1) * TL::LDV + 8 * nd], vb[1], vs[1]);
        mma_3x(acc, pb[kc], ps[kc], vb, vs);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = fmaf(o[nd][e], alpha[e >> 1], acc[e]);
    }
  }
  cp_async_wait<0>();

  // ---- the key slices' partial results meet in the first slice's warps
  // (lane for lane: both hold the same rows and columns)
  if (TL::KVW > 1) {
    constexpr int STRIDE = kRowGroups * 32;
    float* buf = smem + rg * 32 + lane;  // value i at buf[i * STRIDE]
    __syncthreads();  // the ring's last readers are done
    if (kh == 1) {
      buf[0] = m[0];
      buf[STRIDE] = m[1];
      buf[2 * STRIDE] = l[0];
      buf[3 * STRIDE] = l[1];
#pragma unroll
      for (int nd = 0; nd < KS; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) buf[(4 + 4 * nd + e) * STRIDE] = o[nd][e];
    }
    __syncthreads();
    if (kh == 0) {
      float a1[2] = {1.f, 1.f}, a2[2] = {1.f, 1.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (MODE == RUNMAX) {
          const float m2 = buf[i * STRIDE];  // -inf where that slice saw no key
          const float mn = fmaxf(m[i], m2);
          a1[i] = ex2(m[i] - mn);
          a2[i] = ex2(m2 - mn);
          m[i] = mn;
        }
        l[i] = l[i] * a1[i] + buf[(2 + i) * STRIDE] * a2[i];
      }
#pragma unroll
      for (int nd = 0; nd < KS; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[nd][e] = o[nd][e] * a1[e >> 1] + buf[(4 + 4 * nd + e) * STRIDE] * a2[e >> 1];
    }
  }

  // ---- epilogue: o[nd] = row (row0, row0 + 8) x column (8nd + 2t, 8nd + 2t + 1)
  bool bad = false;
  if (kh == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    float* out = static_cast<float*>(a.o) + (size_t)b * a.sq * ld + h * d;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (r >= a.sq) continue;
      // RUNMAX: o x 1 / l (0 for a fully masked row); the fixed shifts: o / l
      // (l = 0 read as 1), as flash_attn.cu divides
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      const float safe = l[i] == 0.f ? 1.f : l[i];
      if (MODE != RUNMAX) {
        // the guard of the Pallas caller; !(l > 1e-30) also catches NaN
        bad |= !(l[i] > 1e-30f);
        if (MODE != BOUNDED_2) bad |= !isfinite(l[i]);
      } else if (LSE && t == 0) {
        // m is in base-2 units (q carries log2(e)): lse = ln 2 * (m + log2 l)
        a.lse[((size_t)b * a.heads + h) * a.sq + r] =
            l[i] > 0.f ? kLn2 * (m[i] + log2f(l[i])) : 0.f;
      }
#pragma unroll
      for (int nd = 0; nd < KS; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * nd + 2 * t + e;
          if (col >= d) continue;
          const float x = MODE == RUNMAX ? o[nd][2 * i + e] * inv : o[nd][2 * i + e] / safe;
          // K7 and K2u test the output (stored as computed in float32)
          if (MODE == NOSHIFT_E || MODE == UNSHIFTED_2) bad |= !isfinite(x);
          out[(size_t)r * ld + col] = x;
        }
    }
  }
  if (MODE != RUNMAX) {
    if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(a.guard, 1);
  }
}

// Launches the instantiation, or with `shape` set only writes its block's
// shape there: head tile, keys a tile, threads, dynamic shared memory bytes
// and the blocks an SM holds (the occupancy API, registers included).
template <int DP, int MODE, bool LSE>
cudaError_t launch(const FlashArgs& a, bool vec16, cudaStream_t stream, int* shape) {
  using TL = Tf32Tile<DP>;
  const auto kernel = flash_fwd_tf32x3_kernel<DP, MODE, LSE>;
  cudaError_t err = set_smem(kernel, TL::SMEM);
  if (err != cudaSuccess) return err;
  if (shape != nullptr) {
    shape[0] = DP;
    shape[1] = TL::BKV;
    shape[2] = TL::THREADS;
    shape[3] = static_cast<int>(TL::SMEM);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(shape + 4, kernel, TL::THREADS,
                                                         TL::SMEM);
  }
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.heads, a.batch);
  kernel<<<grid, TL::THREADS, TL::SMEM, stream>>>(a, vec16);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_mode(const FlashArgs& a, int mode, bool vec16, cudaStream_t stream,
                        int* shape) {
  switch (mode) {
    case RUNMAX:
      return a.lse != nullptr ? launch<DP, RUNMAX, true>(a, vec16, stream, shape)
                              : launch<DP, RUNMAX, false>(a, vec16, stream, shape);
    case NOSHIFT_E: return launch<DP, NOSHIFT_E, false>(a, vec16, stream, shape);
    case BOUNDED_2: return launch<DP, BOUNDED_2, false>(a, vec16, stream, shape);
    case UNSHIFTED_2: return launch<DP, UNSHIFTED_2, false>(a, vec16, stream, shape);
    default: return cudaErrorInvalidValue;
  }
}

// the instantiation of (a.d, mode, a.lse): launched, or its shape written
cudaError_t dispatch(const FlashArgs& a, int mode, cudaStream_t stream, int* shape) {
  // 16-byte copies need whole vectors of 4 columns on 16-byte addresses
  const bool vec16 = a.d % 4 == 0 && aligned16(a.k) && aligned16(a.v) &&
                     (a.kb == nullptr || (aligned16(a.kb) && aligned16(a.vb)));
  // the head tile DP = round_up(d, 8): 8 ... 128, but d = 49 ... 56 takes
  // the 64-column tile (at 56, ptxas spills under the 128-register cap)
  switch ((a.d + 7) / 8) {
#define ANIPORTRAIT_CASE(n) \
  case n: return launch_mode<8 * n>(a, mode, vec16, stream, shape);
    ANIPORTRAIT_CASE(1)
    ANIPORTRAIT_CASE(2)
    ANIPORTRAIT_CASE(3)
    ANIPORTRAIT_CASE(4)
    ANIPORTRAIT_CASE(5)
    ANIPORTRAIT_CASE(6)
    case 7:
    ANIPORTRAIT_CASE(8)
    ANIPORTRAIT_CASE(9)
    ANIPORTRAIT_CASE(10)
    ANIPORTRAIT_CASE(11)
    ANIPORTRAIT_CASE(12)
    ANIPORTRAIT_CASE(13)
    ANIPORTRAIT_CASE(14)
    ANIPORTRAIT_CASE(15)
    ANIPORTRAIT_CASE(16)
#undef ANIPORTRAIT_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t flash_fwd_tf32x3(const FlashArgs& a, int mode, cudaStream_t stream) {
  return dispatch(a, mode, stream, nullptr);
}

}  // namespace aniportrait

// The block of the instantiation a call at head dim d in `mode` (with the
// LSE where lse != 0) launches: shape[0 ... 4] = head tile, keys a tile,
// threads, dynamic shared memory bytes, blocks an SM.  Nothing is launched.
extern "C" int aniportrait_flash_tf32x3_shape(int d, int mode, int lse, int* shape) {
  aniportrait::FlashArgs a{};
  float lse_slot = 0.f;  // selects the LSE instantiation; never written
  a.d = d;
  a.lse = lse != 0 ? &lse_slot : nullptr;
  return static_cast<int>(aniportrait::dispatch(a, mode, nullptr, shape));
}
