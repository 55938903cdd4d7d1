// Blocked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention: _kernel), which every prefill of every attention
// layer reaches through ops.attention.  For each query row it computes
// softmax(q k^T * dh^-0.5) v over the keys the row may see: causal mask,
// sliding window, tanh logit soft-cap, a scalar q_offset (absolute
// position of query row 0), and GQA (kv head = h / (H / KV)).  Like the
// TPU kernel it keeps the running max, the running denominator and the
// output accumulator in float32, and gives a row with no visible key an
// output of 0.
//
// Layout: the model's, q/o (B, Sq, H, dh) and k/v (B, Skv, KV, dh),
// contiguous; the kernel indexes heads by stride (or by a tensor map's
// head coordinate), so no transpose is made.  Inputs are float32 or
// bfloat16 (o has q's type); dh is 32, 64, 80 (stablelm-3b: 2560 / 32
// heads), 128 or 256 (recurrentgemma's local attention: 2560 / 10 heads).
//
// What bounds it on the H100: at the phi4-mini prefill (b = 8, S = 512,
// H = 24, KV = 8, dh = 128, bf16) the inputs and output are 67 MB, 0.020
// ms at 3.35 TB/s, and the causal products 12.9 GFLOP, 0.013 ms at the
// 989 TFLOP/s of the bf16 tensor cores: bytes, barely.  At recurrentgemma's
// prefill (b = 4, S = 1024, H = 10, KV = 1, dh = 256) the products, 21.5
// GFLOP, bound it (0.022 ms), as they do at long sequences (gemma2's 6144
// positions, window 4096).  At stablelm-3b's prefill (b = 4, S = 1024,
// H = KV = 32, dh = 80) the inputs and output are 84 MB, 0.025 ms, and
// the causal products 21.5 GFLOP, 0.022 ms: bytes, barely, as at phi4.
// Reaching either needs the tensor cores at Hopper's own rate (wgmma,
// operands from shared memory) and tile loads that never leave the
// cores waiting on device memory.
//
// Design.  One CTA per (64-row q tile, head, batch row); it loops over
// the 64-key tiles IN ORDER, which replaces the TPU grid's sequential kv
// axis that carried the scratch.  Every accumulator stays in registers.
// Ragged edges are masked, not padded: query rows past Sq are loaded as
// zeros and never stored, keys past Skv are masked.  Key tiles wholly
// past the tile's causal horizon or wholly before its window are
// skipped: in the TPU kernel they add exactly nothing (alpha = 1, p =
// 0).  There are no atomics: every sum has one fixed order, so the
// output is identical run to run.  Two paths, chosen by the launcher
// (kernels/flash_attention.py: plan); the TMA, mbarrier and wgmma
// helpers are in hopper.cuh, shared with the backward:
//
//  - bfloat16, every dh: a consumer warpgroup of 64 query rows and one
//    producer warp a CTA.  The producer's one thread brings Q, K and V
//    tiles by TMA through 4-d tensor maps over the (B, S, heads, dh)
//    layout (box {<= 64 columns, 1 head, 64 rows, 1}: rows past S are
//    zero-filled and a box never crosses into the next batch row),
//    swizzled by 128 bytes (64 at dh 32, 32 at dh 80; a 256-wide row is
//    four boxes), into a ring of 2 K/V stages; each copy completes on a
//    "full" mbarrier, and a stage's K (V) is refilled as soon as every consumer
//    thread has arrived on its "read" mbarrier, so the next tiles' copies
//    are in flight while the current tile is consumed.  S = Q K^T is
//    wgmma m64n64k16 with both operands read from shared memory through
//    descriptors whose swizzle matches the TMA's; O += P V is wgmma
//    m64n{dh}k16 with P, S's accumulator rounded to bf16 in registers
//    (as the reference's xla path rounds p to v's type), as the A
//    operand, and V read in its natural (keys, dh) layout through
//    wgmma's transpose bit.  At dh <= 128 two CTAs share an SM (83 KB of
//    shared memory each at dh 128).  At dh 80 a 160-byte row is tiled by
//    no 64- or 128-byte swizzle, so each tile is five boxes of 16 columns
//    x 64 rows with the 32-byte swizzle (2 KB a box, a 10 KB tile, read
//    in place: the row stride H x 160 bytes and the head stride 160 meet
//    TMA's 16-byte rule): Q K^T's k-step kk is box kk, and P V is one
//    m64n80k16 a 16-key step, V's five boxes one leading-byte-offset
//    apart.  That is the true dh-80 work, with no pad to 128 and no
//    slice of the output; a consumer thread holds 40 O accumulators,
//    and a CTA's 52,296 bytes let three share an SM (the launch bounds
//    ask for it) to hide the serial Q K^T -> softmax -> P V chain of its
//    one warpgroup.  At dh 256 a consumer thread holds
//    128 O accumulators beside S's 32 and P's 16 (about 206 registers),
//    and the CTA (Q 32 KB + 2 x (K 32 KB + V 32 KB)) has an SM to
//    itself; two consumer warpgroups sharing each K/V tile (FA3's
//    layout) get too few registers a thread and spill.  The softmax is
//    what the CUDA cores spend their time on, so it is held to one FMA
//    and one ex2 a score: the max runs on raw scores, the scale folds
//    into the exponent's FMA, the mask is evaluated only on tiles that
//    cross Skv, the causal diagonal or the window's edge, and the
//    soft-cap's tanh takes one ex2 and one reciprocal.  The last q
//    tiles, which see the most keys under a causal mask, are started
//    first.
//  - float32: split TF32 on the tensor cores (mma.sync m16n8k8), the
//    library's own method for float32 attention: each float32 operand
//    x is big = tf32(x) plus small = tf32(x - big), and each product
//    adds small·big + big·small + big·big in float32 (hopper.cuh:
//    mma_split), about 2^-22 relative a term, so the output holds the
//    float32 bar at 495 / 3 TFLOP/s, where the CUDA cores' FMAs give
//    67.
//    Four warps of 16 query rows a CTA; Q and a 2-stage ring of K and V
//    tiles (64 keys, 32 above dh 64) in shared memory, staged by
//    cp.async so that the next tile lands while this one is read, in a
//    layout of whole 128-byte rows whose 16-byte chunks are XOR-swizzled
//    (hopper.cuh: F32Tile) so that both reads below are 16-byte loads
//    free of bank conflicts.  S's k order is permuted within each
//    16-column step (lane t's k slots are four adjacent columns), and
//    P·V's within each 8-key step (slots t and t + 4 are keys 2t and 2t
//    + 1), so that S's accumulator is P's A fragment as it stands: the
//    online softmax runs in the accumulators' registers and no value
//    crosses lanes.  V's columns are read a 16-byte chunk a lane (n-tile
//    4c + i, column g is dh column 32c + 4g + i), and the output goes
//    back in order by 16-byte stores.  P stays float32, as in the TPU
//    kernel; the soft-cap's tanh is the float32 tanhf.  Shared memory:
//    40 KB at dh 32, 80 KB at 64, 72 KB at 80 (rows of 96 floats), 96 KB
//    at 128 (two CTAs an SM), 192 KB at 256 (one).  What bounds it: 3
//    TF32 products a float32 one, 3 x 4·B·H·pairs·dh operations at 495
//    TFLOP/s, or the bytes.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // keys per tile

// The key tiles [start, end) of `keys` keys that query rows [q0, q0 +
// rows) can see.
__device__ __forceinline__ void key_tiles(int q0, int rows, int Sq, int Skv,
                                          int q_offset, int causal,
                                          int window, int* start, int* end,
                                          int keys = BK) {
  const int qlo = q_offset + q0;
  const int qhi = q_offset + min(q0 + rows, Sq) - 1;
  *end = (Skv + keys - 1) / keys;
  if (causal) *end = min(*end, qhi < 0 ? 0 : qhi / keys + 1);
  *start = 0;
  if (window > 0 && qlo - window + 1 > 0)
    *start = (qlo - window + 1) / keys;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Skv,
                                        int causal, int window) {
  bool ok = kpos < Skv;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

__device__ __forceinline__ float lanes_max(float x, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float lanes_sum(float x, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// bfloat16: TMA loads, wgmma on the tensor cores
// ---------------------------------------------------------------------------
constexpr int WG_THREADS = 128 + 32;  // a consumer warpgroup + a producer warp
constexpr int STAGES = 2;             // the K / V ring

// The wgmma path's CTAs an SM, for its launch bounds: three at dh 80 (3 x
// 52 KB of shared memory, at most 136 registers a thread).  Its shared
// memory (the plan's): Q, STAGES x (K, V), the barriers (Q; K and V
// full, K and V free, a stage each), and slack to align the tiles to
// 1024 bytes.
template <int DH>
struct Wg : Tile<DH> {
  static constexpr int CTAS = DH == 80 ? 3 : 1;
};

template <int DH>
__global__ void __launch_bounds__(WG_THREADS, Wg<DH>::CTAS)
    flash_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o, int Sq, int Skv,
                          int H, int KV, float scale, int causal, int window,
                          float softcap, int q_offset,
                          float* __restrict__ lse) {
  using W = Wg<DH>;
  constexpr int KS = DH / 16;  // k-steps of Q K^T
  constexpr int NT = BK / 8;   // 8-key n-tiles of S
  constexpr int DT = DH / 8;   // 8-wide n-tiles of O
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  // the swizzle pattern repeats every 1024 bytes: align every tile to it
  const uint32_t raw = smem_u32(smem_wg);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sK = sQ + W::TILE;               // STAGES K tiles
  const uint32_t sV = sK + STAGES * W::TILE;      // STAGES V tiles
  const uint32_t bQ = sV + STAGES * W::TILE;      // the Q barrier
  const uint32_t bK = bQ + 8;                     // K landed, a stage
  const uint32_t bV = bK + 8 * STAGES;            // V landed, a stage
  const uint32_t bEK = bV + 8 * STAGES;           // K read, a stage
  const uint32_t bEV = bEK + 8 * STAGES;          // V read, a stage

  // the last q tiles see the most keys under a causal mask: start them
  // first, so the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  int kt_start, kt_end;
  key_tiles(q0, BQ, Sq, Skv, q_offset, causal, window, &kt_start, &kt_end);
  const int n_tiles = kt_end - kt_start;

  if (threadIdx.x == 0) {
    mbar_init(bQ, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bK + 8 * s, 1);
      mbar_init(bV + 8 * s, 1);
      mbar_init(bEK + 8 * s, 128);
      mbar_init(bEV + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the roles part here and never meet again

  if (threadIdx.x >= 128) {
    // The producer: one thread keeps the ring full.  Key tile j's K (V)
    // lands in stage j % STAGES once every consumer thread has released
    // the K (V) that stage held; rows past S are zero-filled by TMA.
    if (threadIdx.x == 128) {
      mbar_expect_tx(bQ, W::TILE);
#pragma unroll
      for (int c = 0; c < W::NBOX; ++c)
        tma_load(sQ + c * W::BOX, &tq, bQ, c * W::COLS, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int stage = j % STAGES;
        const uint32_t reuse = (j / STAGES - 1) & 1;
        const int kpos = (kt_start + j) * BK;
        if (j >= STAGES) mbar_wait(bEK + 8 * stage, reuse);
        mbar_expect_tx(bK + 8 * stage, W::TILE);
#pragma unroll
        for (int c = 0; c < W::NBOX; ++c)
          tma_load(sK + stage * W::TILE + c * W::BOX, &tk, bK + 8 * stage,
                   c * W::COLS, kvh, kpos, b);
        if (j >= STAGES) mbar_wait(bEV + 8 * stage, reuse);
        mbar_expect_tx(bV + 8 * stage, W::TILE);
#pragma unroll
        for (int c = 0; c < W::NBOX; ++c)
          tma_load(sV + stage * W::TILE + c * W::BOX, &tv, bV + 8 * stage,
                   c * W::COLS, kvh, kpos, b);
      }
    }
    return;
  }

  // The consumer warpgroup: the tile's 64 query rows
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int r0 = (tid >> 5) * 16;         // the warp's first row

  // rows r0 + g (half 0: accumulator slots 4j, 4j + 1) and r0 + g + 8
  // (half 1: slots 4j + 2, 4j + 3)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  // p = 2^(v c - m c): v the score (soft-capped when asked), c its
  // factor into base 2, m the running max of v
  const bool capped = softcap > 0.f;
  const float c2 = capped ? LOG2E : scale * LOG2E;
  const float cap_in = capped ? 2.f * LOG2E * scale / softcap : 0.f;
  const int qlo = q_offset + q0;           // first and last query
  const int qhi = qlo + BQ - 1;            // positions of the tile

  mbar_wait(bQ, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (kt_start + i) * BK;
    const int stage = i % STAGES;
    const uint32_t parity = (i / STAGES) & 1;

    // S = Q K_i^T: both K-major; k-step kk is 32 bytes into its box row
    // (at dh 80, where a box is 32 bytes wide, box kk itself)
    float sc[NT * 4];
#pragma unroll
    for (int e = 0; e < NT * 4; ++e) sc[e] = 0.f;
    const uint32_t tK = sK + stage * W::TILE;
    mbar_wait(bK + 8 * stage, parity);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk * 16 / W::COLS) * W::BOX +
                           (kk * 16 % W::COLS) * 2;
      wgmma_ss_n64(sc, sdesc(sQ + off, 16, 8 * W::SW, W::LAYOUT),
                   sdesc(tK + off, 16, 8 * W::SW, W::LAYOUT));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    mbar_arrive(bEK + 8 * stage);  // this thread is done with K_i

    // the mask binds only on tiles that cross Skv, the causal diagonal
    // or the window's edge
    const bool masked = k0 + BK > Skv || (causal && k0 + BK - 1 > qlo) ||
                        (window > 0 && k0 <= qhi - window);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = qlo + r0 + g + 8 * half;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = sc[4 * j + 2 * half + e];
          if (capped)  // softcap tanh(v scale / softcap), tanh(y) as
            v = softcap * tanh_ex2(v * cap_in);  // 1 - 2 / (1 + 2^y')
          if (masked && !visible(qpos, k0 + 8 * j + 2 * t + e, Skv, causal,
                                 window))
            v = NEG_INF;
          sc[4 * j + 2 * half + e] = v;
          mx = fmaxf(mx, v);
        }
      mx = lanes_max(mx, 4);  // the quad that shares the row
      const float m_new = fmaxf(m[half], mx);
      // a row that has seen no visible key yet keeps m == NEG_INF and
      // exponent base 0, so its masked keys give exactly 0
      const float mc = (m_new == NEG_INF ? 0.f : m_new) * c2;
      const float alpha = ex2(fmaf(m[half], c2, -mc));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT * 2; ++j) {
        const int e = 4 * (j / 2) + 2 * half + j % 2;
        sc[e] = ex2(fmaf(sc[e], c2, -mc));
        rs += sc[e];
      }
      rs = lanes_sum(rs, 4);
      l[half] = l[half] * alpha + rs;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[4 * d + 2 * half] *= alpha;
        acc[4 * d + 2 * half + 1] *= alpha;
      }
      m[half] = m_new;
    }

    // O += P V: S's accumulators of n-tiles 2kk, 2kk + 1 are P's
    // A-fragment (P rounded to bf16, as the reference rounds p to v's
    // type); V is read in its (keys, dh) layout, N-major, 16 keys a step
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    const uint32_t tV = sV + stage * W::TILE;
    mbar_wait(bV + 8 * stage, parity);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<DH>(acc, pa[kk],
                   sdesc(tV + kk * 16 * W::SW, W::BOX, 8 * W::SW, W::LAYOUT));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bEV + 8 * stage);  // this thread is done with V_i
  }

  const size_t q_step = (size_t)H * DH;
  __nv_bfloat16* ob = o + (size_t)b * Sq * q_step + (size_t)h * DH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = q0 + r0 + g + 8 * half;
    if (s < Sq) {
      // the row's natural-log LSE of its scaled, soft-capped, masked
      // scores (m is in score units: c2 / LOG2E is the scale, or 1
      // under the cap); +inf for a row that sees no key, so that the
      // backward's exp(s - lse) is 0 there
      if (lse != nullptr && t == 0)
        lse[((size_t)b * H + h) * Sq + s] =
            l[half] == 0.f ? __int_as_float(0x7f800000)
                           : m[half] * (capped ? 1.f : scale) + logf(l[half]);
      const float li = l[half] == 0.f ? 1.f : l[half];
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)s * q_step + 8 * d +
                                           2 * t) =
            __floats2bfloat162_rn(acc[4 * d + 2 * half] / li,
                                  acc[4 * d + 2 * half + 1] / li);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: split TF32 on the tensor cores (mma.sync m16n8k8)
// ---------------------------------------------------------------------------
constexpr int F32_THREADS = 128;  // four warps of 16 query rows

// Keys a tile at head dim DH (kernels/flash_attention.py: plan owns it
// and passes it; the launcher refuses another): 64, or 32 above dh 64,
// so that Q and a 2-stage K/V ring fit three CTAs an SM at 80, two at
// 128 and one at 256
template <int DH>
__host__ __device__ constexpr int f32_keys() {
  return DH > 64 ? 32 : 64;
}

template <int DH>
__global__ void __launch_bounds__(F32_THREADS)
    flash_attention_tf32(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int Sq, int Skv, int H, int KV, float scale,
                         int causal, int window, float softcap, int q_offset,
                         float* __restrict__ lse) {
  constexpr int BKT = f32_keys<DH>();
  constexpr int NT = BKT / 8;   // 8-key n-tiles of S
  constexpr int DT = DH / 8;    // 8-wide n-tiles of O
  constexpr int P = F32Tile<DH>::PITCH;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) float smem_tf[];
  float* sQ = smem_tf;           // BQ rows
  float* sK = sQ + BQ * P;       // 2 stages of BKT rows
  float* sV = sK + 2 * BKT * P;  // 2 stages of BKT rows

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_step = (size_t)H * DH, kv_step = (size_t)KV * DH;
  const float* kb = k + (size_t)b * Skv * kv_step + (size_t)kvh * DH;
  const float* vb = v + (size_t)b * Skv * kv_step + (size_t)kvh * DH;
  const int qlo = q_offset + q0, qhi = qlo + BQ - 1;
  int kt0, kt1;
  key_tiles(q0, BQ, Sq, Skv, q_offset, causal, window, &kt0, &kt1, BKT);
  const int n_tiles = max(kt1 - kt0, 0);
  auto stage_kv = [&](int i) {
    const int slot = i & 1;
    stage_f32<DH, BKT, F32_THREADS>(sK + slot * BKT * P, kb, (kt0 + i) * BKT,
                                    Skv, kv_step);
    stage_f32<DH, BKT, F32_THREADS>(sV + slot * BKT * P, vb, (kt0 + i) * BKT,
                                    Skv, kv_step);
  };
  stage_f32<DH, BQ, F32_THREADS>(
      sQ, q + (size_t)b * Sq * q_step + (size_t)h * DH, q0, Sq, q_step);
  if (n_tiles > 0) stage_kv(0);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's first row
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  const bool capped = softcap > 0.f;
  // p = 2^(v c2 - m c2): v the raw score, or the soft-capped one
  const float c2 = capped ? LOG2E : scale * LOG2E;
  const float cap_in = capped ? scale / softcap : 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    // the next tile lands in the other slot while this one is read
    if (i + 1 < n_tiles) stage_kv(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* tK = sK + (i & 1) * BKT * P;
    const float* tV = sV + (i & 1) * BKT * P;
    const int k0 = (kt0 + i) * BKT;

    // S = Q K_i^T
    float sc[NT * 4];
    row_mma<DH, NT>(sc, sQ, r0, tK, g, t);

    // the online softmax, as the wgmma path's (float32 tanh under the
    // cap)
    const bool masked = k0 + BKT > Skv || (causal && k0 + BKT - 1 > qlo) ||
                        (window > 0 && k0 <= qhi - window);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = qlo + r0 + g + 8 * half;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * j + 2 * half + e];
          if (capped) x = softcap * tanhf(x * cap_in);
          if (masked && !visible(qpos, k0 + 8 * j + 2 * t + e, Skv, causal,
                                 window))
            x = NEG_INF;
          sc[4 * j + 2 * half + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = lanes_max(mx, 4);
      const float m_new = fmaxf(m[half], mx);
      const float mc = (m_new == NEG_INF ? 0.f : m_new) * c2;
      const float alpha = ex2(fmaf(m[half], c2, -mc));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT * 2; ++j) {
        const int e = 4 * (j / 2) + 2 * half + j % 2;
        sc[e] = ex2(fmaf(sc[e], c2, -mc));
        rs += sc[e];
      }
      rs = lanes_sum(rs, 4);
      l[half] = l[half] * alpha + rs;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[4 * d + 2 * half] *= alpha;
        acc[4 * d + 2 * half + 1] *= alpha;
      }
      m[half] = m_new;
    }

    // O += P V_i: S's accumulator of n-tile j is P's A fragment of
    // k-step j (P stays float32, as in the TPU kernel)
    col_mma<DH, DH, NT>(acc, tV, 0, g, t, sc);
    __syncthreads();  // every warp is done with the slot before its refill
  }
  cp_async_wait<0>();

  const size_t ob = (size_t)b * Sq * q_step + (size_t)h * DH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = q0 + r0 + g + 8 * half;
    if (s < Sq) {
      if (lse != nullptr && t == 0)  // as the wgmma path's
        lse[((size_t)b * H + h) * Sq + s] =
            l[half] == 0.f ? __int_as_float(0x7f800000)
                           : m[half] * (capped ? 1.f : scale) + logf(l[half]);
      const float li = l[half] == 0.f ? 1.f : l[half];
      col_store<DH>(o + ob + (size_t)s * q_step, acc, half, t, 1.f / li);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
// The wrapper's plan (kernels/flash_attention.py: plan) owns the launch
// geometry: each launcher refuses threads or keys a tile it was not
// built for, and asks for the plan's shared memory as it is.
template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Skv, int H, int KV, float scale,
               int causal, int window, float softcap, int q_offset,
               int threads, int keys, size_t smem, cudaStream_t stream) {
  if (threads != F32_THREADS || keys != f32_keys<DH>())
    return (int)cudaErrorInvalidValue;
  // above 48 KB of shared memory only after opting in (per device)
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tf32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_tf32<DH><<<grid, F32_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Skv,
      H, KV, scale, causal, window, softcap, q_offset, lse);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Skv, int H, int KV,
                 float scale, int causal, int window, float softcap,
                 int q_offset, int threads, int keys, size_t smem,
                 cudaStream_t stream) {
  using W = Wg<DH>;
  if (threads != WG_THREADS || keys != BK) return (int)cudaErrorInvalidValue;
  bind_context();
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, Sq, H, DH, W::COLS, W::SW) ||
      !tensor_map(&tk, k, B, Skv, KV, DH, W::COLS, W::SW) ||
      !tensor_map(&tv, v, B, Skv, KV, DH, W::COLS, W::SW))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_wgmma<DH><<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, Sq, Skv, H, KV, scale, causal, window,
      softcap, q_offset, lse);
  return (int)cudaGetLastError();
}

// The two paths: bfloat16 on wgmma, float32 in split TF32 on mma.sync.
// A refused launch returns its error; no path stands in for another.
template <int DH>
int launch_dh(int bf16, const void* q, const void* k, const void* v,
              void* o, float* lse, int B, int Sq, int Skv, int H, int KV,
              float scale, int causal, int window, float softcap,
              int q_offset, int threads, int keys, size_t smem,
              cudaStream_t s) {
  if (bf16)
    return launch_wgmma<DH>(q, k, v, o, lse, B, Sq, Skv, H, KV, scale,
                            causal, window, softcap, q_offset, threads, keys,
                            smem, s);
  return launch_f32<DH>(q, k, v, o, lse, B, Sq, Skv, H, KV, scale, causal,
                        window, softcap, q_offset, threads, keys, smem, s);
}

}  // namespace

// q, o (B, Sq, H, dh); k, v (B, Skv, KV, dh); contiguous, all float32
// (bf16 = 0) or all bfloat16 (bf16 = 1), 16-byte aligned.  lse, when not
// null, is a float32 (B, H, Sq) buffer that receives each row's
// natural-log sum of exp of its scaled, soft-capped, masked scores (the
// backward's input; +inf for a row that sees no key).  scale is
// dh^-0.5 rounded to float32.  threads, keys (a tile) and smem are the
// launch plan's (kernels/flash_attention.py: plan).  Launches on
// `stream`; returns cudaGetLastError() (or the error of the
// shared-memory opt-in, or cudaErrorInvalidValue where the plan's
// threads or keys are not the kernel's or a tensor map cannot be made).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int Sq,
                                      int Skv, int H, int KV, int dh,
                                      int bf16, int causal, int window,
                                      float softcap, float scale,
                                      int q_offset, int threads, int keys,
                                      int smem, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (Skv == 0 && lse != nullptr) return (int)cudaErrorInvalidValue;
  if (Skv == 0)  // no key at all: every row is 0
    return (int)cudaMemsetAsync(o, 0, (size_t)B * Sq * H * dh *
                                          (bf16 ? 2 : 4), s);
  const size_t bytes = (size_t)smem;
  switch (dh) {
    case 32:
      return launch_dh<32>(bf16, q, k, v, o, (float*)lse, B, Sq, Skv,
                           H, KV, scale, causal, window, softcap,
                           q_offset, threads, keys, bytes, s);
    case 64:
      return launch_dh<64>(bf16, q, k, v, o, (float*)lse, B, Sq, Skv,
                           H, KV, scale, causal, window, softcap,
                           q_offset, threads, keys, bytes, s);
    case 80:
      return launch_dh<80>(bf16, q, k, v, o, (float*)lse, B, Sq, Skv,
                           H, KV, scale, causal, window, softcap,
                           q_offset, threads, keys, bytes, s);
    case 128:
      return launch_dh<128>(bf16, q, k, v, o, (float*)lse, B, Sq, Skv,
                            H, KV, scale, causal, window, softcap,
                            q_offset, threads, keys, bytes, s);
    case 256:
      return launch_dh<256>(bf16, q, k, v, o, (float*)lse, B, Sq, Skv,
                            H, KV, scale, causal, window, softcap,
                            q_offset, threads, keys, bytes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
