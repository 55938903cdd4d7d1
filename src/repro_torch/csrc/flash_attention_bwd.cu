// The backward pass of flash attention (dQ, dK, dV) for Hopper (sm_90a).
//
// No TPU kernel to replace: the reference has no backward Pallas kernel
// and trains, off the TPU, through autodiff of its xla attention
// (src/repro/kernels/ops.py: _attention_xla, under jax.checkpoint).  This
// is the gradient of the forward kernel csrc/flash_attention.cu (which
// replaces src/repro/kernels/flash_attention.py: flash_attention), so
// training on the card runs attention through hand-written kernels both
// ways.  It takes what the forward saved: q, k, v, its output o, and the
// row log-sum-exp lse of the scaled, soft-capped, masked scores, plus the
// output's gradient dO.  With s the score of a (row, key) pair after the
// scale dh^-0.5 and the soft-cap c·tanh(z / c):
//
//   P  = exp(s - lse)              (0 where the mask hides the key)
//   D  = rowsum(dO ∘ O)
//   dV = P^T dO,   dP = dO V^T,   dS = P ∘ (dP - D) ∘ (1 - (s / c)^2)
//   dQ = dS K · scale,   dK = dS^T Q · scale
//
// with the group's q heads summed into their kv head (GQA).  Masks: the
// causal one, a sliding window, keys past Skv; q_offset is 0.  q, o, dO,
// lse and D have Sq rows, k, v, dK and dV Skv rows: Sq = Skv for
// self-attention (training), and Sq != Skv for an encoder-decoder's cross
// attention, which is non-causal (a causal mask between two sequences
// would need an offset, and the reference gives it none).  A row that
// sees no key has lse = +inf from the forward, so its P is 0 and its dQ
// is 0, consistent with the forward's 0 output.
//
// What bounds it on the H100: at phi4-mini's training shape (B 4, S 512,
// H 24, KV 8, dh 128, bf16, causal) the inputs and outputs are about 67
// MB (0.020 ms at 3.35 TB/s) and the five products 10·B·H·pairs·dh = 16
// GFLOP (0.016 ms on the bf16 tensor cores): bytes and operations nearly
// balance.  At whisper's encoder (B 8, 1500 x 1500, 6 heads of 64,
// non-causal) the products bound it (69 GFLOP, 0.070 ms).  Reaching
// either needs the tensor cores at Hopper's own rate (wgmma, operands
// from shared memory) and tiles that land while the last ones are
// consumed.  With every sum owned by one CTA (none shared across CTAs),
// S and dP are made in both passes: seven products, not five.  The
// exponentials (4096 a tile pair in each pass, 16 a clock on an SM's
// special-function units) and the wgmma chain's latency within one
// warpgroup are what keep it above that bound (PERF.md has the measured
// times).  In float32 the products are three TF32 products each (split
// TF32, below): 3 x 16 GFLOP at phi4's shape, 0.098 ms at 495 TFLOP/s,
// so the operations bound it.
//
// Design: three launches, no sum shared between CTAs or threads, every
// sum in one fixed order, so the gradients are identical run to run.
// Each output tile has one owner CTA.
//  1. D (bytes-bound): in bfloat16 bwd_dot_rows, DH / 8 lanes a (b, s,
//     h) row, a 16-byte load of o and of dO each, so that a warp's
//     loads are one contiguous run of rows; in float32 bwd_dot, a warp
//     a row.
//  2. dK and dV: one CTA owns one 64-key tile of one kv head of one batch
//     row and walks every q head of its group (or of its split of the
//     group, below), then every 64-row query tile the mask lets see its
//     keys, in that order.  Where the tiles alone leave the card short
//     (MQA: granite-20b's 48:1 at B 4 x S 512 is 32 tiles for 132 SMs,
//     tile 0 walking 48 x 8 (head, query tile) pairs under the causal
//     mask), the group's q heads are split over `splits` CTAs a tile
//     (kernels/flash_attention.py: bwd_head_splits; 5 there, 160 CTAs,
//     at most 80 pairs a CTA); each split writes float32 partial dK and
//     dV to a workspace (2 x splits x B x Skv x KV x dh floats: 10.5 MB
//     at granite's shape), and the dQ launch's CTAs past its tiles
//     (merge_dkdv) add them in split order, scale dK and round both
//     once.  The dK/dV launch has ended before the dQ launch starts (one
//     stream), so the merge needs no flag and no atomic; at one split
//     the dK/dV kernel writes dK and dV itself.
//  3. dQ: one CTA owns one 64-row query tile of one q head and walks the
//     key tiles the mask lets through, in order.
// Both grids are flat, the tile index slowest, so the CTAs with the most
// work under a causal mask (key tile 0; the last query tile) start first
// and the short ones fill the tail.
//
// bfloat16 (every training call on the card), two kernels on TMA and
// wgmma, K3's forward (flash_attention.cu) applied to the five products,
// with its two wgmma shapes (hopper.cuh): SS m64n64k16 for scores and
// RS m64n{dh}k16 with B read N-major through the transpose bit.  A CTA
// is one consumer warpgroup and one producer warp; the producer brings
// 64-row tiles by TMA through 4-d tensor maps over the (B, S, heads, dh)
// layout, 128-byte swizzled (64 at dh 32, 32 at dh 80), rows past S
// zero-filled, into a ring of 2 stages, each on a "full" mbarrier,
// refilled once every consumer thread has arrived on its "free" one.
//  - bwd_dkdv_wgmma: K and V land once; the producer streams (Q, dO)
//    pairs with the 64 rows' lse (in base 2) and D beside them (rows past
//    Sq: lse +inf, so P is 0, and D 0).  The consumer's 64 accumulator
//    rows are keys and its columns query rows.  S^T = K Q^T and dP^T = V
//    dO^T (SS) are issued together; P^T is made from S^T, rounded to bf16
//    and packed into A fragments as K3 packs P; dV += P^T dO (RS, dO in
//    V's place) runs on the tensor cores while dS^T = P^T ∘ (dP^T - D) ∘
//    (1 - t^2) is made in bf16 fragments from the packed P^T; then dK +=
//    dS^T Q (RS).  A thread holds dK and dV (dh / 2 floats each), S^T and
//    dP^T (32 each) and P^T's 16 packed pairs (32 under the soft-cap,
//    which keeps P^T·(1 - t^2) packed beside it): 228 registers at dh
//    128, one CTA an SM, two at dh <= 64.  The mask is read with (query =
//    column, key = row) and evaluated only on tiles that cross Skv, the
//    diagonal or the window's edge.
//  - bwd_dq_wgmma: K3's forward loop: Q and dO land once, the K and V
//    tiles stream through the ring; once both have landed S = Q K^T and
//    dP = dO V^T (SS) are issued together (a wait between the two would
//    make ptxas serialise every wgmma of the kernel), dS is made in bf16
//    fragments and dQ += dS K (RS, K in V's place).
//  At dh 256 (recurrentgemma's local attention) a thread cannot hold dK
//  and dV (128 floats each) beside S^T and dP^T, so a CTA is two
//  consumer warpgroups, one a 128-column half of the outputs (Out<DH>),
//  and no producer warp (thread 0 issues the TMA loads; with 256 threads
//  a warpgroup keeps 255 registers).  bwd_dkdv_wg2: warpgroup 0 makes S^T
//  and P^T, warpgroup 1 dP^T and dS^T, each once a pair; P^T (and P^T
//  (1 - t^2)) and dS^T cross between them as packed bf16 A fragments
//  through shared memory in fragment order (thread j's values land with
//  thread j of the other warpgroup), two named barriers a pair; then
//  each runs dV += P^T dO and dK += dS^T Q on its half (RS m64n128k16).
//  bwd_dq_wg2 the same with S and dP, P (1 - t^2) and dS crossing, dQ
//  += dS K a half each.  Four full-dh products a pair in the dK/dV pass
//  and three in the dQ pass, where two CTAs a tile, a half each, would
//  make six and five.  recurrentgemma's 10:1 MQA leaves the dK/dV grid
//  at B x 8 key tiles = 32 CTAs, so its heads split as in 2. (5 splits
//  at the train shape: 160 CTAs, at most 16 pairs a CTA).
//  At stablelm-3b's dh 80 the tiles are five 16-column boxes with the
//  32-byte swizzle (Tile<80>, as K3's forward at 80): S^T and dP^T take
//  five k-steps of 16, one a box, and dV, dK and dQ are m64n80 products
//  (wgmma_rs_n80), so no head dim is padded; at the MHA 32:32 train
//  shape the dK/dV grid is 1024 CTAs, so the walk needs no head split.
//  P and dS are rounded to bf16 before their products, as K3's forward
//  rounds P; every product accumulates in float32; outputs are bf16.
//  The soft-cap is a template argument, so uncapped calls carry no tanh
//  and no second packed copy of P.  Tried and slower at every main-path
//  shape: issuing the next tile's scores behind the current dK or dQ
//  product (ptxas then serialises the wgmmas: too few registers, or
//  accumulators defined between stages), 128-row owner tiles over two
//  consumer warpgroups sharing each streamed tile (the two lock-step on
//  the ring), three CTAs an SM at dh 64, a ring of 3.
// float32 (the card-vs-CPU parity smokes, LM FedKT rounds, any
// float32 config): two kernels in split TF32 on mma.sync m16n8k8, K3's
// float32 forward (flash_attention.cu) applied to the five products:
// each float32 operand is big + small TF32 terms, each product adds
// small·big + big·small + big·big (hopper.cuh: mma_split), so the
// gradients hold the float32 bar on the tensor cores at 495 / 3 TFLOP/s
// against 67 on the CUDA cores.  Four warps a CTA, tiles staged by
// cp.async in K3's swizzled float32 layout (F32Tile), a 2-stage ring of
// the streamed tiles.  Each product sums a short run of k-steps in fresh
// registers and adds it rounded (hopper.cuh: row_mma, col_mma: the
// tensor cores truncate as they accumulate, and a chain over a group's
// query tiles drifted to 2e-5 of the largest gradient).  bwd_dkdv_tf32
// owns a block of
// keys (warps of 16 keys), holds K and V, streams (Q, dO) pairs with
// their lse and D, and makes S^T and dP^T (Q, dO read K-major), then P^T
// and dS^T in the accumulators, which are, with the k order permuted as
// K3 permutes P·V's, the A fragments of dV += P^T dO and dK += dS^T Q
// (dO, Q read N-major): no value crosses lanes.  bwd_dq_tf32 owns a
// block of query rows and streams (K, V) tiles: S, dP, dS, then dQ +=
// dS K.  Every head dim runs natively (dh 80: rows of 96 floats; dh
// 256: a block of 32 rows, each 16-row block split over two warps a
// half of the output columns, both making its S and dP), and the
// group's q heads split over CTAs as the bf16 path's do
// (bwd_head_splits), their float32 partials merged in split order by
// merge_dkdv.
// A refused launch returns its error: no path stands in for another.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows a tile
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 256;  // bwd_dot's and bwd_dot_rows' CTA
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq,
                                        int Skv, int causal, int window) {
  bool ok = qpos < Sq && kpos < Skv;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// Whether the mask can hide a pair of query tile [q0, q0 + rows) and
// key tile [k0, k0 + keys): the tile crosses Skv, the causal diagonal or
// the window's edge (rows past Sq need no mask: their lse is +inf)
__device__ __forceinline__ bool tile_masked(int q0, int k0, int Skv,
                                            int causal, int window,
                                            int rows = BQ, int keys = BK) {
  return k0 + keys > Skv || (causal && k0 + keys - 1 > q0) ||
         (window > 0 && k0 <= q0 + rows - 1 - window);
}

// The query tiles [start, end) of `rows` rows that can see a key of tile
// [k0, k0 + keys)
__device__ __forceinline__ void query_tiles(int k0, int Sq, int Skv,
                                            int causal, int window,
                                            int* start, int* end,
                                            int keys = BK, int rows = BQ) {
  const int kmax = min(k0 + keys, Skv) - 1;
  const int q_end = window > 0 ? min(Sq, kmax + window) : Sq;
  *start = causal ? k0 / rows : 0;
  *end = (q_end + rows - 1) / rows;
}

// The key tiles [start, end) of `keys` keys that query rows [q0, q0 +
// rows) can see (the forward's key_tiles at q_offset 0)
__device__ __forceinline__ void key_tiles(int q0, int Sq, int Skv,
                                          int causal, int window,
                                          int* start, int* end,
                                          int rows = BQ, int keys = BK) {
  const int qhi = min(q0 + rows, Sq) - 1;
  *end = (Skv + keys - 1) / keys;
  if (causal) *end = min(*end, qhi / keys + 1);
  *start = window > 0 && q0 - window + 1 > 0 ? (q0 - window + 1) / keys
                                             : 0;
}

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO ∘ O), float32 (B, H, Sq)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
            float* __restrict__ Dv, int B, int S, int H, int DH) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (THREADS / 32) + warp;  // (b, s, h)
  if (row >= (long)B * S * H) return;
  const T* po = o + row * DH;
  const T* pd = dout + row * DH;
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32)
    acc = fmaf(load(po + d), load(pd + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H;
    const long bs = row / H;
    const int s = bs % S, b = bs / S;
    Dv[((long)b * H + h) * S + s] = acc;
  }
}

// D in bfloat16: L = DH / 8 lanes a row (4 to 32), a warp 32 / L
// consecutive rows at a time (at dh 80 three rows on 30 lanes), each lane
// the dot of one 16-byte vector of o and dO; a row's L partial sums are
// added in lane order by its first lane, through shared memory
__global__ void __launch_bounds__(THREADS)
    bwd_dot_rows(const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout,
                 float* __restrict__ Dv, int B, int S, int H, int DH) {
  __shared__ float part[THREADS];
  const int L = DH / 8, per = 32 / L;  // lanes a row, rows a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row =
      ((long)blockIdx.x * (THREADS / 32) + warp) * per + lane / L;
  const bool on = lane < per * L && row < (long)B * S * H;  // (b, s, h)
  float acc = 0.f;
  if (on) {
    const uint4 a =
        reinterpret_cast<const uint4*>(o + row * DH)[lane % L];
    const uint4 g =
        reinterpret_cast<const uint4*>(dout + row * DH)[lane % L];
    const uint32_t ua[4] = {a.x, a.y, a.z, a.w}, ug[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = fmaf(bf16_lo(ua[j]), bf16_lo(ug[j]), acc);
      acc = fmaf(bf16_hi(ua[j]), bf16_hi(ug[j]), acc);
    }
  }
  part[threadIdx.x] = acc;
  __syncwarp();
  if (on && lane % L == 0) {
    float sum = 0.f;
    for (int i = 0; i < L; ++i) sum += part[threadIdx.x + i];
    const int h = row % H;
    const long bs = row / H;
    const int s = bs % S, b = bs / S;
    Dv[((long)b * H + h) * S + s] = sum;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: TMA loads, wgmma on the tensor cores
// ---------------------------------------------------------------------------
constexpr int WG_THREADS = 128 + 32;  // a consumer warpgroup + a producer warp
constexpr int STAGES = 2;             // the ring

// dK/dV: K, V; STAGES x (Q, dO); STAGES x (lse, D) rows; the barriers
// (K and V; full and free a stage); slack to align the tiles to 1024
template <int DH>
struct KvSmem {
  static constexpr size_t bytes = 1024 + (size_t)Tile<DH>::TILE *
                                             (2 + 2 * STAGES) +
                                  sizeof(float) * 2 * BQ * STAGES +
                                  8 * (1 + 2 * STAGES);
};

// dQ: Q, dO; STAGES x (K, V); the barriers (Q and dO; K and V full, K
// and V free, a stage each); slack
template <int DH>
struct QSmem {
  static constexpr size_t bytes = 1024 + (size_t)Tile<DH>::TILE *
                                             (2 + 2 * STAGES) +
                                  8 * (1 + 4 * STAGES);
};

// The k-step kk's byte offset into a K-major tile (32 bytes a step into
// its box row; a new box every COLS columns)
template <int DH>
__device__ __forceinline__ uint32_t kstep(int kk) {
  using W = Tile<DH>;
  return (kk * 16 / W::COLS) * W::BOX + (kk * 16 % W::COLS) * 2;
}

// acc (64 x 64) = A B^T over DH: both tiles K-major (the scores S, S^T
// and dP, dP^T)
template <int DH>
__device__ __forceinline__ void scores_ss(float (&acc)[32], uint32_t a,
                                          uint32_t b) {
  using W = Tile<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss_n64(acc, sdesc(a + kstep<DH>(kk), 16, 8 * W::SW, W::LAYOUT),
                 sdesc(b + kstep<DH>(kk), 16, 8 * W::SW, W::LAYOUT));
}

// The output columns a consumer warpgroup owns: all of dh up to 128; at
// dh 256 a half (the two warpgroups of bwd_dkdv_wg2 and bwd_dq_wg2), so
// that dK and dV (or dQ) stay 64 floats a thread each, as at 128
template <int DH>
struct Out {
  static constexpr int N = DH > 128 ? 128 : DH;
};

// acc (64 x N) += A (64 x 64, bf16 fragments) B, B the N columns from
// column block `half` of a (64, DH) tile, read N-major: P^T dO, dS^T Q,
// dS K
template <int DH>
__device__ __forceinline__ void product_rs(float (&acc)[Out<DH>::N / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b, int half) {
  using W = Tile<DH>;
  const uint32_t cols = b + half * (Out<DH>::N / W::COLS) * W::BOX;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_pv<Out<DH>::N>(
        acc, a[kk], sdesc(cols + kk * 16 * W::SW, W::BOX, 8 * W::SW,
                          W::LAYOUT));
}

// The A fragment slot f (0-3) of k-step kk holds accumulator elements
// 4j + 2 half + {0, 1} (row g + 8 half, columns 8j + 2t + {0, 1})
__device__ __forceinline__ int frag_j(int kk, int f) {
  return 2 * kk + (f >> 1);
}
__device__ __forceinline__ int frag_half(int f) { return f & 1; }

// P = 2^(s c2 - lse2) of a raw score v (s = v, or softcap · t under the
// soft-cap, t = tanh(v · scale / softcap)), and in dcap the cap's
// derivative 1 - t^2 (1 uncapped)
template <int CAP>
__device__ __forceinline__ float prob(float v, float c2, float cap_in,
                                      float softcap, float lse2,
                                      float* dcap) {
  *dcap = 1.f;
  if (CAP) {
    const float th = tanh_ex2(v * cap_in);
    v = softcap * th;
    *dcap = 1.f - th * th;
  }
  return ex2(fmaf(v, c2, -lse2));
}

template <int DH, int CAP>
__global__ void __launch_bounds__(WG_THREADS)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ Dv,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int B, int Sq, int Skv,
                   int H, int KV, float scale, int causal, int window,
                   float softcap, int hsplit, float* __restrict__ part) {
  static_assert(DH <= 128, "dh 256 runs bwd_dkdv_wg2");
  using W = Tile<DH>;
  constexpr int NO = DH;          // the dK, dV columns
  constexpr int DT = NO / 8;      // their 8-wide n-tiles
  extern __shared__ __align__(1024) unsigned char smem_kv[];
  const uint32_t raw = smem_u32(smem_kv);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + W::TILE;
  const uint32_t sQ = sV + W::TILE;                // STAGES Q tiles
  const uint32_t sG = sQ + STAGES * W::TILE;       // STAGES dO tiles
  const uint32_t sRows = sG + STAGES * W::TILE;    // lse2, D a stage
  const uint32_t bKV = sRows + sizeof(float) * 2 * BQ * STAGES;
  const uint32_t bFull = bKV + 8;                  // Q, dO, rows landed
  const uint32_t bFree = bFull + 8 * STAGES;       // the stage read
  float* rows = reinterpret_cast<float*>(smem_kv + (sRows - raw));

  // the tile index slowest: key tile 0, which the most query tiles see
  // under a causal mask, starts first; the head split fastest
  const int sp = blockIdx.x % hsplit;
  const int cta = blockIdx.x / hsplit;
  const int kvh = cta % KV;
  const int b = (cta / KV) % B;
  const int k0 = (cta / (KV * B)) * BK;
  const int group = H / KV;
  const int h_lo = sp * group / hsplit, h_hi = (sp + 1) * group / hsplit;
  int qt_start, qt_end;
  query_tiles(k0, Sq, Skv, causal, window, &qt_start, &qt_end);
  const int per_head = max(qt_end - qt_start, 0);
  const int n_iter = (h_hi - h_lo) * per_head;

  if (threadIdx.x == 0) {
    mbar_init(bKV, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bFull + 8 * s, 32);   // the producer warp's lanes
      mbar_init(bFree + 8 * s, 128);  // the consumer threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the roles part here and never meet again

  if (threadIdx.x >= 128) {
    // The producer warp.  Lane 0 brings K and V once, then each pair's Q
    // and dO tiles; every lane stages two of the pair's 64 lse (times
    // log2 e) and D values and arrives on the stage's full barrier.
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      mbar_expect_tx(bKV, 2 * W::TILE);
#pragma unroll
      for (int c = 0; c < W::NBOX; ++c) {
        tma_load(sK + c * W::BOX, &tk, bKV, c * W::COLS, kvh, k0, b);
        tma_load(sV + c * W::BOX, &tv, bKV, c * W::COLS, kvh, k0, b);
      }
    }
    for (int i = 0; i < n_iter; ++i) {
      const int stage = i % STAGES;
      const int h = kvh * group + h_lo + i / per_head;
      const int q0 = (qt_start + i % per_head) * BQ;
      if (i >= STAGES) mbar_wait(bFree + 8 * stage, (i / STAGES - 1) & 1);
      float* lr = rows + stage * 2 * BQ;
      const size_t row0 = ((size_t)b * H + h) * Sq;
      for (int r = lane; r < BQ; r += 32) {
        const int s = q0 + r;
        lr[r] = s < Sq ? lse[row0 + s] * LOG2E : __int_as_float(0x7f800000);
        lr[BQ + r] = s < Sq ? Dv[row0 + s] : 0.f;
      }
      const uint32_t full = bFull + 8 * stage;
      if (lane == 0) {
        mbar_expect_tx(full, 2 * W::TILE);  // also lane 0's arrival
#pragma unroll
        for (int c = 0; c < W::NBOX; ++c) {
          tma_load(sQ + stage * W::TILE + c * W::BOX, &tq, full,
                   c * W::COLS, h, q0, b);
          tma_load(sG + stage * W::TILE + c * W::BOX, &tdo, full,
                   c * W::COLS, h, q0, b);
        }
      } else {
        mbar_arrive(full);
      }
    }
    return;
  }

  // The consumer warpgroup: accumulator rows are the tile's 64 keys
  // (r0 + g, half 0; r0 + g + 8, half 1), columns the pair's query rows
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16;
  float dK[NO / 2], dV[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dK[i] = dV[i] = 0.f;
  const float c2 = CAP ? LOG2E : scale * LOG2E;
  const float cap_in = CAP ? 2.f * LOG2E * scale / softcap : 0.f;

  mbar_wait(bKV, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int stage = i % STAGES;
    const int q0 = (qt_start + i % per_head) * BQ;
    const uint32_t tQ = sQ + stage * W::TILE, tG = sG + stage * W::TILE;
    const float* lr = rows + stage * 2 * BQ;
    mbar_wait(bFull + 8 * stage, (i / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T, issued together
    float st[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dp[e] = 0.f;
    fence_regs(st);
    fence_regs(dp);
    wgmma_fence();
    scores_ss<DH>(st, sK, tQ);
    scores_ss<DH>(dp, sV, tG);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dp);

    // P^T = 2^(s c2 - lse2[query]) (0 where masked), packed to bf16 A
    // fragments; under the soft-cap also P^T (1 - t^2)
    const bool masked = tile_masked(q0, k0, Skv, causal, window);
    uint32_t pa[4][4], pd[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int j = frag_j(kk, f), hf = frag_half(f);
        const int kpos = k0 + r0 + g + 8 * hf;
        float p[2], pc[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          float dcap;
          p[e] = prob<CAP>(st[4 * j + 2 * hf + e], c2, cap_in, softcap,
                           lr[col], &dcap);
          if (masked && !visible(q0 + col, kpos, Sq, Skv, causal, window))
            p[e] = 0.f;
          pc[e] = p[e] * dcap;
        }
        pa[kk][f] = pack_bf16(p[0], p[1]);
        if (CAP) pd[kk][f] = pack_bf16(pc[0], pc[1]);
      }

    // dV += P^T dO runs while dS^T = P^T (1 - t^2) (dP^T - D[query]) is
    // made in bf16 A fragments
    fence_regs(dV);
    wgmma_fence();
    product_rs<DH>(dV, pa, tG, 0);
    wgmma_commit();
    uint32_t ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int j = frag_j(kk, f), hf = frag_half(f);
        const uint32_t pp = CAP ? pd[kk][f] : pa[kk][f];
        const int col = 8 * j + 2 * t;
        const int e0 = 4 * j + 2 * hf;
        ds[kk][f] = pack_bf16(bf16_lo(pp) * (dp[e0] - lr[BQ + col]),
                              bf16_hi(pp) * (dp[e0 + 1] - lr[BQ + col + 1]));
      }

    // dK += dS^T Q
    fence_regs(dK);
    wgmma_fence();
    product_rs<DH>(dK, ds, tQ, 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dV);
    fence_regs(dK);
    mbar_arrive(bFree + 8 * stage);  // this thread is done with the stage
  }

  const size_t kv_step = (size_t)KV * DH;
  const size_t plane = (size_t)B * Skv * kv_step;
  float* pk = part != nullptr ? part + (size_t)sp * plane : nullptr;
  float* pv = part != nullptr ? pk + (size_t)hsplit * plane : nullptr;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = k0 + r0 + g + 8 * hf;
    if (s < Skv) {
      const size_t off = ((size_t)b * Skv + s) * kv_step + (size_t)kvh * DH;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int e = 4 * d + 2 * hf;
        if (part != nullptr) {  // a split's float32 partials, dK unscaled
          *reinterpret_cast<float2*>(pk + off + 8 * d + 2 * t) =
              make_float2(dK[e], dK[e + 1]);
          *reinterpret_cast<float2*>(pv + off + 8 * d + 2 * t) =
              make_float2(dV[e], dV[e + 1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * d + 2 * t) =
              __floats2bfloat162_rn(dK[e] * scale, dK[e + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * d + 2 * t) =
              __floats2bfloat162_rn(dV[e], dV[e + 1]);
        }
      }
    }
  }
}

// dh 256 with two consumer warpgroups a CTA (256 threads; thread 0
// issues the TMA loads, so that no producer warp takes from the
// consumers' registers): a pair's S^T = K Q^T (warpgroup 0) and dP^T = V
// dO^T (warpgroup 1) are made once, P^T (and P^T (1 - t^2)) and dS^T
// cross between the warpgroups as packed bf16 fragments through shared
// memory (fragment order: thread j's values land with thread j), and
// warpgroup w adds dV and dK of columns [128 w, 128 w + 128).  Four
// full-dh products a pair over the CTA where two CTAs a tile run six.
constexpr int WG2_THREADS = 256;
constexpr size_t WG2_EX = 128 * 16 * 4;  // a fragment set: 128 x 16 pairs

template <int CAP>
struct Wg2Smem {
  static constexpr size_t bytes =
      1024 + (size_t)Tile<256>::TILE * (2 + 2 * STAGES) +
      sizeof(float) * 2 * BQ * STAGES + WG2_EX * (CAP ? 3 : 2) +
      8 * (1 + STAGES);
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int CAP>
__global__ void __launch_bounds__(WG2_THREADS)
    bwd_dkdv_wg2(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ Dv,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int B, int Sq, int Skv,
                 int H, int KV, float scale, int causal, int window,
                 float softcap, int hsplit, float* __restrict__ part) {
  constexpr int DH = 256;
  using W = Tile<DH>;
  constexpr int NO = 128;     // the dK, dV columns a warpgroup owns
  constexpr int DT = NO / 8;  // their 8-wide n-tiles
  extern __shared__ __align__(1024) unsigned char smem_w2[];
  const uint32_t raw = smem_u32(smem_w2);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + W::TILE;
  const uint32_t sQ = sV + W::TILE;              // STAGES Q tiles
  const uint32_t sG = sQ + STAGES * W::TILE;     // STAGES dO tiles
  const uint32_t sRows = sG + STAGES * W::TILE;  // lse2, D a stage
  const uint32_t sEx = sRows + sizeof(float) * 2 * BQ * STAGES;
  const uint32_t bKV = sEx + WG2_EX * (CAP ? 3 : 2);
  const uint32_t bFull = bKV + 8;                // Q, dO landed, a stage
  float* rows = reinterpret_cast<float*>(smem_w2 + (sRows - raw));
  uint4* exP = reinterpret_cast<uint4*>(smem_w2 + (sEx - raw));  // P^T
  uint4* exS = exP + 4 * 128;                                    // dS^T
  uint4* exD = exS + 4 * 128;  // P^T (1 - t^2), under the soft-cap

  // the tile index slowest (key tile 0 first), the head split fastest
  const int sp = blockIdx.x % hsplit;
  const int cta = blockIdx.x / hsplit;
  const int kvh = cta % KV;
  const int b = (cta / KV) % B;
  const int k0 = (cta / (KV * B)) * BK;
  const int group = H / KV;
  const int h_lo = sp * group / hsplit, h_hi = (sp + 1) * group / hsplit;
  int qt_start, qt_end;
  query_tiles(k0, Sq, Skv, causal, window, &qt_start, &qt_end);
  const int per_head = max(qt_end - qt_start, 0);
  const int n_iter = (h_hi - h_lo) * per_head;

  const int tid = threadIdx.x, wg = tid >> 7, ltid = tid & 127;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (ltid >> 5) * 16;
  auto pair_h = [&](int i) { return kvh * group + h_lo + i / per_head; };
  auto pair_q0 = [&](int i) { return (qt_start + i % per_head) * BQ; };
  // thread 0: pair i's Q and dO tiles into stage i % STAGES
  auto issue = [&](int i) {
    const int stage = i % STAGES, h = pair_h(i), q0 = pair_q0(i);
    const uint32_t full = bFull + 8 * stage;
    mbar_expect_tx(full, 2 * W::TILE);
#pragma unroll
    for (int c = 0; c < W::NBOX; ++c) {
      tma_load(sQ + stage * W::TILE + c * W::BOX, &tq, full, c * W::COLS, h,
               q0, b);
      tma_load(sG + stage * W::TILE + c * W::BOX, &tdo, full, c * W::COLS, h,
               q0, b);
    }
  };
  // warpgroup 1, thread ltid: pair i's row value, lse times log2 e for
  // ltid < 64, D above (rows past Sq: +inf and 0), and its slot
  auto row_val = [&](int i) {
    const int s = pair_q0(i) + (ltid & 63);
    const size_t row0 = ((size_t)b * H + pair_h(i)) * Sq;
    if (ltid < BQ) return s < Sq ? lse[row0 + s] * LOG2E
                                 : __int_as_float(0x7f800000);
    return s < Sq ? Dv[row0 + s] : 0.f;
  };
  const int slot = (ltid < BQ ? 0 : BQ) + (ltid & 63);

  if (tid == 0) {
    mbar_init(bKV, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bFull + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_iter > 0) {
    mbar_expect_tx(bKV, 2 * W::TILE);
#pragma unroll
    for (int c = 0; c < W::NBOX; ++c) {
      tma_load(sK + c * W::BOX, &tk, bKV, c * W::COLS, kvh, k0, b);
      tma_load(sV + c * W::BOX, &tv, bKV, c * W::COLS, kvh, k0, b);
    }
    for (int i = 0; i < min(STAGES, n_iter); ++i) issue(i);
  }
  float pre = 0.f;  // the next pair's row value, loaded a pair ahead
  if (wg == 1 && n_iter > 0) {
    rows[slot] = row_val(0);
    if (n_iter > 1) pre = row_val(1);
  }
  __syncthreads();

  float dK[NO / 2], dV[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dK[i] = dV[i] = 0.f;
  const float c2 = CAP ? LOG2E : scale * LOG2E;
  const float cap_in = CAP ? 2.f * LOG2E * scale / softcap : 0.f;

  if (n_iter > 0) mbar_wait(bKV, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int stage = i % STAGES;
    const int q0 = pair_q0(i);
    const uint32_t tQ = sQ + stage * W::TILE, tG = sG + stage * W::TILE;
    const float* lr = rows + stage * 2 * BQ;
    mbar_wait(bFull + 8 * stage, (i / STAGES) & 1);

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    fence_regs(sc);
    wgmma_fence();
    scores_ss<DH>(sc, wg ? sV : sK, wg ? tG : tQ);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    uint32_t pa[4][4], pd[4][4], ds[4][4];
    if (wg == 0) {
      // P^T = 2^(s c2 - lse2[query]) (0 where masked), packed to bf16 A
      // fragments, under the soft-cap also P^T (1 - t^2); to the exchange
      const bool masked = tile_masked(q0, k0, Skv, causal, window);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int j = frag_j(kk, f), hf = frag_half(f);
          const int kpos = k0 + r0 + g + 8 * hf;
          float p[2], pc[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            float dcap;
            p[e] = prob<CAP>(sc[4 * j + 2 * hf + e], c2, cap_in, softcap,
                             lr[col], &dcap);
            if (masked && !visible(q0 + col, kpos, Sq, Skv, causal, window))
              p[e] = 0.f;
            pc[e] = p[e] * dcap;
          }
          pa[kk][f] = pack_bf16(p[0], p[1]);
          if (CAP) pd[kk][f] = pack_bf16(pc[0], pc[1]);
        }
        exP[kk * 128 + ltid] =
            make_uint4(pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]);
        if (CAP)
          exD[kk * 128 + ltid] =
              make_uint4(pd[kk][0], pd[kk][1], pd[kk][2], pd[kk][3]);
      }
      // dV (columns 0-127) += P^T dO while warpgroup 1 makes dS^T
      fence_regs(dV);
      wgmma_fence();
      product_rs<DH>(dV, pa, tG, 0);
      wgmma_commit();
    }
    named_sync(1, WG2_THREADS);
    if (wg == 1) {
      // dS^T = P^T (1 - t^2) (dP^T - D[query]) in bf16 A fragments, to
      // the exchange; dV (columns 128-255) += P^T dO
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 x = exP[kk * 128 + ltid];
        pa[kk][0] = x.x, pa[kk][1] = x.y, pa[kk][2] = x.z, pa[kk][3] = x.w;
        if (CAP) {
          const uint4 y = exD[kk * 128 + ltid];
          pd[kk][0] = y.x, pd[kk][1] = y.y, pd[kk][2] = y.z, pd[kk][3] = y.w;
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int j = frag_j(kk, f), hf = frag_half(f);
          const uint32_t pp = CAP ? pd[kk][f] : pa[kk][f];
          const int col = 8 * j + 2 * t;
          const int e0 = 4 * j + 2 * hf;
          ds[kk][f] = pack_bf16(bf16_lo(pp) * (sc[e0] - lr[BQ + col]),
                                bf16_hi(pp) * (sc[e0 + 1] - lr[BQ + col + 1]));
        }
        exS[kk * 128 + ltid] =
            make_uint4(ds[kk][0], ds[kk][1], ds[kk][2], ds[kk][3]);
      }
      fence_regs(dV);
      wgmma_fence();
      product_rs<DH>(dV, pa, tG, 1);
      wgmma_commit();
    }
    named_sync(2, WG2_THREADS);
    if (wg == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 x = exS[kk * 128 + ltid];
        ds[kk][0] = x.x, ds[kk][1] = x.y, ds[kk][2] = x.z, ds[kk][3] = x.w;
      }
    }
    // dK (the warpgroup's columns) += dS^T Q
    fence_regs(dK);
    wgmma_fence();
    product_rs<DH>(dK, ds, tQ, wg);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dV);
    fence_regs(dK);

    // pair i + 1's rows in; then, the stage read by both warpgroups,
    // pair i + STAGES's tiles and pair i + 2's rows on their way
    if (wg == 1 && i + 1 < n_iter)
      rows[((i + 1) % STAGES) * 2 * BQ + slot] = pre;
    __syncthreads();
    if (tid == 0 && i + STAGES < n_iter) issue(i + STAGES);
    if (wg == 1 && i + 2 < n_iter) pre = row_val(i + 2);
  }

  const size_t kv_step = (size_t)KV * DH;
  const size_t plane = (size_t)B * Skv * kv_step;
  float* pk = part != nullptr ? part + (size_t)sp * plane : nullptr;
  float* pv = part != nullptr ? pk + (size_t)hsplit * plane : nullptr;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = k0 + r0 + g + 8 * hf;
    if (s < Skv) {
      const size_t off = ((size_t)b * Skv + s) * kv_step +
                         (size_t)kvh * DH + wg * NO;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int e = 4 * d + 2 * hf;
        if (part != nullptr) {  // a split's float32 partials, dK unscaled
          *reinterpret_cast<float2*>(pk + off + 8 * d + 2 * t) =
              make_float2(dK[e], dK[e + 1]);
          *reinterpret_cast<float2*>(pv + off + 8 * d + 2 * t) =
              make_float2(dV[e], dV[e + 1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * d + 2 * t) =
              __floats2bfloat162_rn(dK[e] * scale, dK[e + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * d + 2 * t) =
              __floats2bfloat162_rn(dV[e], dV[e + 1]);
        }
      }
    }
  }
}

// Rows of dK and dV a merge CTA sums: MERGE_ROWS (b, s, kv head) rows
// of DH columns, a float4 of each at a time
constexpr int MERGE_ROWS = 16;

__device__ __forceinline__ void put4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(p);
  d[0] = __floats2bfloat162_rn(x.x, x.y);
  d[1] = __floats2bfloat162_rn(x.z, x.w);
}
__device__ __forceinline__ void put4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// dK = scale x (the splits' partials summed in split order), dV the
// same unscaled, both rounded to the output type T (bf16 or float32)
// once: rows [MERGE_ROWS m, MERGE_ROWS (m + 1)) of the `rows` (b, s, kv
// head) rows.  Every element is summed by one thread in one order:
// identical run to run.
template <int DH, typename T>
__device__ __forceinline__ void merge_dkdv(const float* __restrict__ part,
                                           T* __restrict__ dk,
                                           T* __restrict__ dv, int m,
                                           int rows, int hsplit,
                                           float scale) {
  const size_t plane = (size_t)rows * DH;
  for (int e = threadIdx.x; e < MERGE_ROWS * DH / 4; e += blockDim.x) {
    const int row = m * MERGE_ROWS + e / (DH / 4);
    if (row >= rows) break;
    const size_t off = (size_t)row * DH + 4 * (e % (DH / 4));
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* src = part + which * hsplit * plane + off;
      float4 x = *reinterpret_cast<const float4*>(src);
      for (int sp = 1; sp < hsplit; ++sp) {
        const float4 y = *reinterpret_cast<const float4*>(src + sp * plane);
        x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
      }
      const float f = which == 0 ? scale : 1.f;
      put4((which == 0 ? dk : dv) + off,
           make_float4(x.x * f, x.y * f, x.z * f, x.w * f));
    }
  }
}

template <int DH, int CAP>
__global__ void __launch_bounds__(WG_THREADS)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ Dv,
                 __nv_bfloat16* __restrict__ dq, int B, int Sq, int Skv,
                 int H, int KV, float scale, int causal, int window,
                 float softcap, int n_dq, int hsplit,
                 const float* __restrict__ part,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv) {
  static_assert(DH <= 128, "dh 256 runs bwd_dq_wg2");
  using W = Tile<DH>;
  constexpr int NO = DH;          // the dQ columns
  constexpr int DT = NO / 8;      // their 8-wide n-tiles
  if ((int)blockIdx.x >= n_dq) {  // the CTAs past the dQ tiles
    merge_dkdv<DH>(part, dk, dv, blockIdx.x - n_dq, B * Skv * KV, hsplit,
                   scale);
    return;
  }
  extern __shared__ __align__(1024) unsigned char smem_q[];
  const uint32_t raw = smem_u32(smem_q);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sG = sQ + W::TILE;               // dO
  const uint32_t sK = sG + W::TILE;               // STAGES K tiles
  const uint32_t sV = sK + STAGES * W::TILE;      // STAGES V tiles
  const uint32_t bQ = sV + STAGES * W::TILE;      // Q and dO landed
  const uint32_t bK = bQ + 8;                     // K landed, a stage
  const uint32_t bV = bK + 8 * STAGES;            // V landed, a stage
  const uint32_t bEK = bV + 8 * STAGES;           // K read, a stage
  const uint32_t bEV = bEK + 8 * STAGES;          // V read, a stage

  // the tile index slowest and reversed: the last query tiles, which see
  // the most keys under a causal mask, start first
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int h = blockIdx.x % H;
  const int b = (blockIdx.x / H) % B;
  const int q0 = (n_qt - 1 - blockIdx.x / (H * B)) * BQ;
  const int kvh = h / (H / KV);
  int kt_start, kt_end;
  key_tiles(q0, Sq, Skv, causal, window, &kt_start, &kt_end);
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
    // The producer: one thread keeps the ring full, as in the forward
    if (threadIdx.x == 128) {
      mbar_expect_tx(bQ, 2 * W::TILE);
#pragma unroll
      for (int c = 0; c < W::NBOX; ++c) {
        tma_load(sQ + c * W::BOX, &tq, bQ, c * W::COLS, h, q0, b);
        tma_load(sG + c * W::BOX, &tdo, bQ, c * W::COLS, h, q0, b);
      }
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

  // The consumer warpgroup: the tile's 64 query rows, r0 + g (half 0)
  // and r0 + g + 8 (half 1)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16;
  const size_t row0 = ((size_t)b * H + h) * Sq;
  float lse2[2], Dr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = q0 + r0 + g + 8 * hf;
    lse2[hf] = s < Sq ? lse[row0 + s] * LOG2E : __int_as_float(0x7f800000);
    Dr[hf] = s < Sq ? Dv[row0 + s] : 0.f;
  }
  float dQ[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dQ[i] = 0.f;
  const float c2 = CAP ? LOG2E : scale * LOG2E;
  const float cap_in = CAP ? 2.f * LOG2E * scale / softcap : 0.f;

  mbar_wait(bQ, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (kt_start + i) * BK;
    const int stage = i % STAGES;
    const uint32_t parity = (i / STAGES) & 1;
    const uint32_t tK = sK + stage * W::TILE, tV = sV + stage * W::TILE;

    // S = Q K^T and dP = dO V^T
    float sc[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    mbar_wait(bK + 8 * stage, parity);
    mbar_wait(bV + 8 * stage, parity);
    wgmma_fence();
    scores_ss<DH>(sc, sQ, tK);
    scores_ss<DH>(dp, sG, tV);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    mbar_arrive(bEV + 8 * stage);  // this thread is done with V_i

    // dS = P (1 - t^2) (dP - D), P = 2^(s c2 - lse2) (0 where masked),
    // bf16 A fragments
    const bool masked = tile_masked(q0, k0, Skv, causal, window);
    uint32_t ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int j = frag_j(kk, f), hf = frag_half(f);
        const int qpos = q0 + r0 + g + 8 * hf;
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * hf + e;
          float dcap;
          float p = prob<CAP>(sc[idx], c2, cap_in, softcap, lse2[hf],
                              &dcap);
          if (masked && !visible(qpos, k0 + 8 * j + 2 * t + e, Sq, Skv,
                                 causal, window))
            p = 0.f;
          d[e] = p * dcap * (dp[idx] - Dr[hf]);
        }
        ds[kk][f] = pack_bf16(d[0], d[1]);
      }

    // dQ += dS K
    fence_regs(dQ);
    wgmma_fence();
    product_rs<DH>(dQ, ds, tK, 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dQ);
    mbar_arrive(bEK + 8 * stage);  // this thread is done with K_i
  }

  const size_t q_step = (size_t)H * DH;
  __nv_bfloat16* qb = dq + (size_t)b * Sq * q_step + (size_t)h * DH;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = q0 + r0 + g + 8 * hf;
    if (s < Sq) {
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int e = 4 * d + 2 * hf;
        *reinterpret_cast<__nv_bfloat162*>(qb + (size_t)s * q_step + 8 * d +
                                           2 * t) =
            __floats2bfloat162_rn(dQ[e] * scale, dQ[e + 1] * scale);
      }
    }
  }
}

// dQ at dh 256 with two consumer warpgroups a CTA (thread 0 issues the
// TMA loads): a key tile's S = Q K^T (warpgroup 0) and dP = dO V^T
// (warpgroup 1) once; P (1 - t^2) crosses to warpgroup 1 and dS back as
// packed bf16 fragments; warpgroup w adds dQ's columns [128 w, 128 w +
// 128).  The CTAs past the dQ tiles merge dK and dV, as in bwd_dq_wgmma.
constexpr size_t WG2_Q_SMEM =
    1024 + (size_t)Tile<256>::TILE * (2 + 2 * STAGES) + 2 * WG2_EX +
    8 * (1 + STAGES);

template <int CAP>
__global__ void __launch_bounds__(WG2_THREADS)
    bwd_dq_wg2(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ Dv,
               __nv_bfloat16* __restrict__ dq, int B, int Sq, int Skv, int H,
               int KV, float scale, int causal, int window, float softcap,
               int n_dq, int hsplit, const float* __restrict__ part,
               __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv) {
  constexpr int DH = 256;
  using W = Tile<DH>;
  constexpr int NO = 128;  // the dQ columns a warpgroup owns
  constexpr int DT = NO / 8;
  if ((int)blockIdx.x >= n_dq) {  // the CTAs past the dQ tiles
    merge_dkdv<DH>(part, dk, dv, blockIdx.x - n_dq, B * Skv * KV, hsplit,
                   scale);
    return;
  }
  extern __shared__ __align__(1024) unsigned char smem_q2[];
  const uint32_t raw = smem_u32(smem_q2);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sG = sQ + W::TILE;            // dO
  const uint32_t sK = sG + W::TILE;            // STAGES K tiles
  const uint32_t sV = sK + STAGES * W::TILE;   // STAGES V tiles
  const uint32_t sEx = sV + STAGES * W::TILE;  // P (1 - t^2), dS
  const uint32_t bQ = sEx + 2 * WG2_EX;        // Q and dO landed
  const uint32_t bFull = bQ + 8;               // K and V landed, a stage
  uint4* exP = reinterpret_cast<uint4*>(smem_q2 + (sEx - raw));
  uint4* exS = exP + 4 * 128;

  // the tile index slowest and reversed: the last query tiles, which see
  // the most keys under a causal mask, start first
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int h = blockIdx.x % H;
  const int b = (blockIdx.x / H) % B;
  const int q0 = (n_qt - 1 - blockIdx.x / (H * B)) * BQ;
  const int kvh = h / (H / KV);
  int kt_start, kt_end;
  key_tiles(q0, Sq, Skv, causal, window, &kt_start, &kt_end);
  const int n_tiles = kt_end - kt_start;

  const int tid = threadIdx.x, wg = tid >> 7, ltid = tid & 127;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (ltid >> 5) * 16;
  // thread 0: key tile j's K and V into stage j % STAGES
  auto issue = [&](int j) {
    const int stage = j % STAGES, kpos = (kt_start + j) * BK;
    const uint32_t full = bFull + 8 * stage;
    mbar_expect_tx(full, 2 * W::TILE);
#pragma unroll
    for (int c = 0; c < W::NBOX; ++c) {
      tma_load(sK + stage * W::TILE + c * W::BOX, &tk, full, c * W::COLS,
               kvh, kpos, b);
      tma_load(sV + stage * W::TILE + c * W::BOX, &tv, full, c * W::COLS,
               kvh, kpos, b);
    }
  };

  if (tid == 0) {
    mbar_init(bQ, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bFull + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bQ, 2 * W::TILE);
#pragma unroll
    for (int c = 0; c < W::NBOX; ++c) {
      tma_load(sQ + c * W::BOX, &tq, bQ, c * W::COLS, h, q0, b);
      tma_load(sG + c * W::BOX, &tdo, bQ, c * W::COLS, h, q0, b);
    }
    for (int j = 0; j < min(STAGES, n_tiles); ++j) issue(j);
  }

  // the thread's query rows r0 + g (half 0) and r0 + g + 8 (half 1)
  const size_t row0 = ((size_t)b * H + h) * Sq;
  float lse2[2], Dr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = q0 + r0 + g + 8 * hf;
    lse2[hf] = s < Sq ? lse[row0 + s] * LOG2E : __int_as_float(0x7f800000);
    Dr[hf] = s < Sq ? Dv[row0 + s] : 0.f;
  }
  float dQ[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dQ[i] = 0.f;
  const float c2 = CAP ? LOG2E : scale * LOG2E;
  const float cap_in = CAP ? 2.f * LOG2E * scale / softcap : 0.f;

  mbar_wait(bQ, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (kt_start + i) * BK;
    const int stage = i % STAGES;
    const uint32_t tK = sK + stage * W::TILE, tV = sV + stage * W::TILE;
    mbar_wait(bFull + 8 * stage, (i / STAGES) & 1);

    // S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1)
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    fence_regs(sc);
    wgmma_fence();
    scores_ss<DH>(sc, wg ? sG : sQ, wg ? tV : tK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    uint32_t pd[4][4], ds[4][4];
    if (wg == 0) {
      // P (1 - t^2), P = 2^(s c2 - lse2) (0 where masked), to the exchange
      const bool masked = tile_masked(q0, k0, Skv, causal, window);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int j = frag_j(kk, f), hf = frag_half(f);
          const int qpos = q0 + r0 + g + 8 * hf;
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float dcap;
            float p = prob<CAP>(sc[4 * j + 2 * hf + e], c2, cap_in, softcap,
                                lse2[hf], &dcap);
            if (masked && !visible(qpos, k0 + 8 * j + 2 * t + e, Sq, Skv,
                                   causal, window))
              p = 0.f;
            d[e] = p * dcap;
          }
          pd[kk][f] = pack_bf16(d[0], d[1]);
        }
        exP[kk * 128 + ltid] =
            make_uint4(pd[kk][0], pd[kk][1], pd[kk][2], pd[kk][3]);
      }
    }
    named_sync(1, WG2_THREADS);
    if (wg == 1) {
      // dS = P (1 - t^2) (dP - D), to the exchange; dQ (columns 128-255)
      // += dS K
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 x = exP[kk * 128 + ltid];
        pd[kk][0] = x.x, pd[kk][1] = x.y, pd[kk][2] = x.z, pd[kk][3] = x.w;
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int j = frag_j(kk, f), hf = frag_half(f);
          const int e0 = 4 * j + 2 * hf;
          ds[kk][f] = pack_bf16(bf16_lo(pd[kk][f]) * (sc[e0] - Dr[hf]),
                                bf16_hi(pd[kk][f]) * (sc[e0 + 1] - Dr[hf]));
        }
        exS[kk * 128 + ltid] =
            make_uint4(ds[kk][0], ds[kk][1], ds[kk][2], ds[kk][3]);
      }
    }
    named_sync(2, WG2_THREADS);
    if (wg == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 x = exS[kk * 128 + ltid];
        ds[kk][0] = x.x, ds[kk][1] = x.y, ds[kk][2] = x.z, ds[kk][3] = x.w;
      }
    }
    // dQ (the warpgroup's columns) += dS K
    fence_regs(dQ);
    wgmma_fence();
    product_rs<DH>(dQ, ds, tK, wg);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dQ);
    __syncthreads();  // the stage read by both warpgroups
    if (tid == 0 && i + STAGES < n_tiles) issue(i + STAGES);
  }

  const size_t q_step = (size_t)H * DH;
  __nv_bfloat16* qb = dq + (size_t)b * Sq * q_step + (size_t)h * DH + wg * NO;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = q0 + r0 + g + 8 * hf;
    if (s < Sq) {
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const int e = 4 * d + 2 * hf;
        *reinterpret_cast<__nv_bfloat162*>(qb + (size_t)s * q_step + 8 * d +
                                           2 * t) =
            __floats2bfloat162_rn(dQ[e] * scale, dQ[e + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: split TF32 on the tensor cores (mma.sync m16n8k8)
// ---------------------------------------------------------------------------
constexpr int F32_THREADS = 128;  // four warps

// The float32 plan's two sizes (kernels/flash_attention.py: bwd_plan owns
// them and passes them; the launcher refuses others).  block: the rows a
// CTA owns, keys in the dK/dV pass and query rows in the dQ pass (64; 32
// at dh 256); step: the rows of each streamed tile, query rows in the
// dK/dV pass and keys in the dQ pass (64; 32 above dh 64).  Both passes'
// shared memory (K and V, or Q and dO, of a block, and a 2-stage ring
// of the other pair) then fits two CTAs an SM up to dh 80 and one at
// 128 (128 KB) and 256 (192 KB).  At dh 256 a block of 32 rows is two
// warps' 16, and each row block is split over two warps a half of the
// output columns (both make the block's S and dP: 192 instead of 128
// accumulators a thread would not fit).
template <int DH>
__host__ __device__ constexpr int f32_block() {
  return DH == 256 ? 32 : 64;
}
template <int DH>
__host__ __device__ constexpr int f32_step() {
  return DH <= 64 ? 64 : 32;
}

// P = 2^(s c2 - lse2) (0 where masked) of a raw score v, and in dcap the
// soft-cap's derivative 1 - tanh^2 (1 uncapped); tanh in float32
template <int CAP>
__device__ __forceinline__ float prob_f32(float v, float c2, float cap_in,
                                          float softcap, float lse2,
                                          float* dcap) {
  *dcap = 1.f;
  if (CAP) {
    const float th = tanhf(v * cap_in);
    v = softcap * th;
    *dcap = 1.f - th * th;
  }
  return ex2(fmaf(v, c2, -lse2));
}

// dK and dV: a CTA a (block of keys, kv head, batch row, head split);
// warp w owns keys 16 (w % (block / 16)) .. + 15 of the block and the
// output columns of its split.  A pair (q head, query tile) at a time:
// S^T = K Q^T and dP^T = V dO^T (split TF32, Q and dO read K-major), P^T
// and dS^T made in the accumulators, then dV += P^T dO and dK += dS^T Q
// with P^T's and dS^T's accumulators as the A fragments (dO and Q read
// N-major).  The next pair's Q, dO, lse and D land in the other slot of
// the ring while this pair is read.
template <int DH, int CAP>
__global__ void __launch_bounds__(F32_THREADS)
    bwd_dkdv_tf32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ Dv,
                  float* __restrict__ dk, float* __restrict__ dv, int B,
                  int Sq, int Skv, int H, int KV, float scale, int causal,
                  int window, float softcap, int hsplit,
                  float* __restrict__ part) {
  constexpr int KB = f32_block<DH>();  // keys the CTA owns
  constexpr int QS = f32_step<DH>();   // query rows a pair
  constexpr int SPLIT = 64 / KB;       // warps a 16-key block
  constexpr int NO = DH / SPLIT;       // the dK, dV columns a warp owns
  constexpr int NT = QS / 8;           // 8-query n-tiles of S^T
  constexpr int P = F32Tile<DH>::PITCH;
  extern __shared__ __align__(16) float smem_kf[];
  float* sK = smem_kf;
  float* sV = sK + KB * P;
  float* sQ = sV + KB * P;         // 2 stages of QS rows
  float* sG = sQ + 2 * QS * P;     // 2 stages of QS rows
  float* sRows = sG + 2 * QS * P;  // 2 stages of lse2 (QS), D (QS)

  // the block index slowest (key block 0 first), the head split fastest
  const int sp = blockIdx.x % hsplit;
  const int cta = blockIdx.x / hsplit;
  const int kvh = cta % KV;
  const int b = (cta / KV) % B;
  const int k0 = (cta / (KV * B)) * KB;
  const int group = H / KV;
  const int h_lo = sp * group / hsplit, h_hi = (sp + 1) * group / hsplit;
  int qt0, qt1;
  query_tiles(k0, Sq, Skv, causal, window, &qt0, &qt1, KB, QS);
  const int per_head = max(qt1 - qt0, 0);
  const int n_iter = (h_hi - h_lo) * per_head;
  const size_t q_step = (size_t)H * DH, kv_step = (size_t)KV * DH;

  // pair i's Q, dO, lse2 and D into slot i & 1
  auto issue = [&](int i) {
    const int slot = i & 1;
    const int h = kvh * group + h_lo + i / per_head;
    const int q0 = (qt0 + i % per_head) * QS;
    const size_t hb = (size_t)b * Sq * q_step + (size_t)h * DH;
    stage_f32<DH, QS, F32_THREADS>(sQ + slot * QS * P, q + hb, q0, Sq, q_step);
    stage_f32<DH, QS, F32_THREADS>(sG + slot * QS * P, dout + hb, q0, Sq,
                                   q_step);
    float* lr = sRows + slot * 2 * QS;
    const size_t row0 = ((size_t)b * H + h) * Sq;
    for (int r = threadIdx.x; r < QS; r += F32_THREADS) {
      const int s = q0 + r;
      lr[r] = s < Sq ? lse[row0 + s] * LOG2E : __int_as_float(0x7f800000);
      lr[QS + r] = s < Sq ? Dv[row0 + s] : 0.f;
    }
  };
  if (n_iter > 0) {
    stage_f32<DH, KB, F32_THREADS>(
        sK, k + (size_t)b * Skv * kv_step + (size_t)kvh * DH, k0, Skv,
        kv_step);
    stage_f32<DH, KB, F32_THREADS>(
        sV, v + (size_t)b * Skv * kv_step + (size_t)kvh * DH, k0, Skv,
        kv_step);
    issue(0);
  }
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % (KB / 16)) * 16;  // the warp's keys in the block
  const int cs = warp / (KB / 16);         // its column split
  float dK[NO / 2], dV[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dK[i] = dV[i] = 0.f;
  const float c2 = CAP ? LOG2E : scale * LOG2E;
  const float cap_in = CAP ? scale / softcap : 0.f;

  for (int i = 0; i < n_iter; ++i) {
    if (i + 1 < n_iter) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt0 + i % per_head) * QS;
    const float* tQ = sQ + (i & 1) * QS * P;
    const float* tG = sG + (i & 1) * QS * P;
    const float* lr = sRows + (i & 1) * 2 * QS;

    // S^T = K Q^T and dP^T = V dO^T over dh
    float st[NT * 4], dp[NT * 4];
    row_mma<DH, NT>(st, sK, r0, tQ, g, t);
    row_mma<DH, NT>(dp, sV, r0, tG, g, t);

    // P^T = 2^(s c2 - lse2[query]) (0 where masked) over st, and dS^T =
    // P^T (1 - t^2) (dP^T - D[query]) over dp
    const bool masked = tile_masked(q0, k0, Skv, causal, window, QS, KB);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int col = 8 * j + 2 * t + (f & 1);
        const int kpos = k0 + r0 + g + 8 * (f >> 1);
        float dcap;
        float p = prob_f32<CAP>(st[4 * j + f], c2, cap_in, softcap, lr[col],
                                &dcap);
        if (masked && !visible(q0 + col, kpos, Sq, Skv, causal, window))
          p = 0.f;
        st[4 * j + f] = p;
        dp[4 * j + f] = p * dcap * (dp[4 * j + f] - lr[QS + col]);
      }

    // dV += P^T dO and dK += dS^T Q over the pair's rows, the warp's
    // columns
    col_mma<DH, NO, NT>(dV, tG, cs * NO, g, t, st);
    col_mma<DH, NO, NT>(dK, tQ, cs * NO, g, t, dp);
    __syncthreads();  // every warp is done with the slot before its refill
  }
  cp_async_wait<0>();

  const size_t plane = (size_t)B * Skv * kv_step;
  float* pk = part != nullptr ? part + (size_t)sp * plane : nullptr;
  float* pv = part != nullptr ? pk + (size_t)hsplit * plane : nullptr;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = k0 + r0 + g + 8 * hf;
    if (s < Skv) {
      const size_t off = ((size_t)b * Skv + s) * kv_step + (size_t)kvh * DH +
                         cs * NO;
      if (part != nullptr) {  // a split's partials, dK unscaled
        col_store<NO>(pk + off, dK, hf, t, 1.f);
        col_store<NO>(pv + off, dV, hf, t, 1.f);
      } else {
        col_store<NO>(dk + off, dK, hf, t, scale);
        col_store<NO>(dv + off, dV, hf, t, 1.f);
      }
    }
  }
}

// dQ: a CTA a (block of query rows, q head, batch row); warp w owns rows
// 16 (w % (block / 16)) .. + 15 and the dQ columns of its split.  A key
// tile at a time through a 2-stage K/V ring: S = Q K^T and dP = dO V^T,
// dS = P (1 - t^2) (dP - D) in the accumulators, dQ += dS K (K read
// N-major).  The CTAs past the dQ blocks merge a head split's dK and dV
// partials (merge_dkdv), as bwd_dq_wg2's do.
template <int DH, int CAP>
__global__ void __launch_bounds__(F32_THREADS)
    bwd_dq_tf32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ Dv,
                float* __restrict__ dq, int B, int Sq, int Skv, int H, int KV,
                float scale, int causal, int window, float softcap, int n_dq,
                int hsplit, const float* __restrict__ part,
                float* __restrict__ dk, float* __restrict__ dv) {
  if ((int)blockIdx.x >= n_dq) {  // the CTAs past the dQ blocks
    merge_dkdv<DH>(part, dk, dv, blockIdx.x - n_dq, B * Skv * KV, hsplit,
                   scale);
    return;
  }
  constexpr int QB = f32_block<DH>();  // query rows the CTA owns
  constexpr int KS = f32_step<DH>();   // keys a tile
  constexpr int SPLIT = 64 / QB;       // warps a 16-row block
  constexpr int NO = DH / SPLIT;       // the dQ columns a warp owns
  constexpr int NT = KS / 8;           // 8-key n-tiles of S
  constexpr int P = F32Tile<DH>::PITCH;
  extern __shared__ __align__(16) float smem_qf[];
  float* sQ = smem_qf;
  float* sG = sQ + QB * P;
  float* sK = sG + QB * P;      // 2 stages of KS rows
  float* sV = sK + 2 * KS * P;  // 2 stages of KS rows

  // the block index slowest and reversed: the last query blocks, which
  // see the most keys under a causal mask, start first
  const int n_qb = (Sq + QB - 1) / QB;
  const int h = blockIdx.x % H;
  const int b = (blockIdx.x / H) % B;
  const int q0 = (n_qb - 1 - blockIdx.x / (H * B)) * QB;
  const int kvh = h / (H / KV);
  int kt0, kt1;
  key_tiles(q0, Sq, Skv, causal, window, &kt0, &kt1, QB, KS);
  const int n_tiles = max(kt1 - kt0, 0);
  const size_t q_step = (size_t)H * DH, kv_step = (size_t)KV * DH;
  const float* kb = k + (size_t)b * Skv * kv_step + (size_t)kvh * DH;
  const float* vb = v + (size_t)b * Skv * kv_step + (size_t)kvh * DH;
  auto issue = [&](int i) {
    const int slot = i & 1;
    stage_f32<DH, KS, F32_THREADS>(sK + slot * KS * P, kb, (kt0 + i) * KS,
                                   Skv, kv_step);
    stage_f32<DH, KS, F32_THREADS>(sV + slot * KS * P, vb, (kt0 + i) * KS,
                                   Skv, kv_step);
  };
  const size_t hb = (size_t)b * Sq * q_step + (size_t)h * DH;
  stage_f32<DH, QB, F32_THREADS>(sQ, q + hb, q0, Sq, q_step);
  stage_f32<DH, QB, F32_THREADS>(sG, dout + hb, q0, Sq, q_step);
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp % (QB / 16)) * 16;  // the warp's rows in the block
  const int cs = warp / (QB / 16);         // its column split
  const size_t row0 = ((size_t)b * H + h) * Sq;
  float lse2[2], Dr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = q0 + r0 + g + 8 * hf;
    lse2[hf] = s < Sq ? lse[row0 + s] * LOG2E : __int_as_float(0x7f800000);
    Dr[hf] = s < Sq ? Dv[row0 + s] : 0.f;
  }
  float dQ[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) dQ[i] = 0.f;
  const float c2 = CAP ? LOG2E : scale * LOG2E;
  const float cap_in = CAP ? scale / softcap : 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = (kt0 + i) * KS;
    const float* tK = sK + (i & 1) * KS * P;
    const float* tV = sV + (i & 1) * KS * P;

    // S = Q K^T and dP = dO V^T over dh
    float sc[NT * 4], dp[NT * 4];
    row_mma<DH, NT>(sc, sQ, r0, tK, g, t);
    row_mma<DH, NT>(dp, sG, r0, tV, g, t);

    // dS = P (1 - t^2) (dP - D), P = 2^(s c2 - lse2) (0 where masked)
    const bool masked = tile_masked(q0, k0, Skv, causal, window, QB, KS);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int hf = f >> 1;
        const int qpos = q0 + r0 + g + 8 * hf;
        float dcap;
        float p = prob_f32<CAP>(sc[4 * j + f], c2, cap_in, softcap, lse2[hf],
                                &dcap);
        if (masked && !visible(qpos, k0 + 8 * j + 2 * t + (f & 1), Sq, Skv,
                               causal, window))
          p = 0.f;
        dp[4 * j + f] = p * dcap * (dp[4 * j + f] - Dr[hf]);
      }

    // dQ += dS K over the tile's keys, the warp's columns
    col_mma<DH, NO, NT>(dQ, tK, cs * NO, g, t, dp);
    __syncthreads();  // every warp is done with the slot before its refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int s = q0 + r0 + g + 8 * hf;
    if (s < Sq)
      col_store<NO>(dq + hb + (size_t)s * q_step + cs * NO, dQ, hf, t, scale);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
template <typename T>
int launch_dot(const void* o, const void* dout, float* Dv, int B, int Sq,
               int H, int DH, cudaStream_t stream) {
  const long rows = (long)B * Sq * H;
  const int blocks = (int)((rows + THREADS / 32 - 1) / (THREADS / 32));
  bwd_dot<T><<<blocks, THREADS, 0, stream>>>((const T*)o, (const T*)dout,
                                             Dv, B, Sq, H, DH);
  return (int)cudaGetLastError();
}

// float32: the plan (kernels/flash_attention.py: bwd_plan) owns the
// threads, the block and step sizes and the shared memory, and the
// launcher refuses threads or sizes it was not built for; head splits
// as the bf16 path's, the dQ launch's extra CTAs merging them
template <int DH, int CAP>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* Dv, void* dq,
               void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
               float scale, int causal, int window, float softcap,
               int hsplit, float* part, int threads, int block, int step,
               int smem, cudaStream_t stream) {
  if (threads != F32_THREADS || block != f32_block<DH>() ||
      step != f32_step<DH>())
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_dkdv_tf32<DH, CAP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(bwd_dq_tf32<DH, CAP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return (int)err;
  int e = launch_dot<float>(o, dout, Dv, B, Sq, H, DH, stream);
  if (e != 0) return e;
  const int n_kb = (Skv + block - 1) / block, n_qb = (Sq + block - 1) / block;
  float* kv_part = hsplit > 1 ? part : nullptr;
  const int rows = B * Skv * KV;
  const int n_merge =
      kv_part != nullptr ? (rows + MERGE_ROWS - 1) / MERGE_ROWS : 0;
  const int n_dq = n_qb * H * B;
  bwd_dkdv_tf32<DH, CAP><<<n_kb * KV * B * hsplit, F32_THREADS, smem,
                           stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, Dv, (float*)dk, (float*)dv, B, Sq, Skv, H, KV, scale, causal,
      window, softcap, hsplit, kv_part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_dq_tf32<DH, CAP><<<n_dq + n_merge, F32_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, Dv, (float*)dq, B, Sq, Skv, H, KV, scale, causal, window, softcap,
      n_dq, hsplit, kv_part, (float*)dk, (float*)dv);
  return (int)cudaGetLastError();
}

template <int DH, int CAP>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* Dv, void* dq,
                 void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
                 float scale, int causal, int window, float softcap,
                 int hsplit, float* part, cudaStream_t stream) {
  using W = Tile<DH>;
  bind_context();
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, B, Sq, H, DH, W::COLS, W::SW) ||
      !tensor_map(&tk, k, B, Skv, KV, DH, W::COLS, W::SW) ||
      !tensor_map(&tv, v, B, Skv, KV, DH, W::COLS, W::SW) ||
      !tensor_map(&tdo, dout, B, Sq, H, DH, W::COLS, W::SW))
    return (int)cudaErrorInvalidValue;
  const long rows_a_block = (long)(THREADS / 32) * (32 / (DH / 8));
  bwd_dot_rows<<<(int)(((long)B * Sq * H + rows_a_block - 1) /
                       rows_a_block),
                 THREADS, 0, stream>>>((const __nv_bfloat16*)o,
                                       (const __nv_bfloat16*)dout, Dv, B, Sq,
                                       H, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the dK/dV tiles split over hsplit CTAs a group, then the dQ tiles
  // and the CTAs that merge the splits' dK and dV (the dK/dV launch has
  // ended before the dQ launch starts: one stream)
  const int n_kt = (Skv + BK - 1) / BK, n_qt = (Sq + BQ - 1) / BQ;
  float* kv_part = hsplit > 1 ? part : nullptr;
  const int rows = B * Skv * KV;
  const int n_merge =
      kv_part != nullptr ? (rows + MERGE_ROWS - 1) / MERGE_ROWS : 0;
  const int n_dq = n_qt * H * B;
  if constexpr (DH == 256) {
    if ((err = cudaFuncSetAttribute(
             bwd_dkdv_wg2<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)Wg2Smem<CAP>::bytes)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             bwd_dq_wg2<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)WG2_Q_SMEM)) != cudaSuccess)
      return (int)err;
    bwd_dkdv_wg2<CAP><<<n_kt * KV * B * hsplit, WG2_THREADS,
                        Wg2Smem<CAP>::bytes, stream>>>(
        tq, tk, tv, tdo, lse, Dv, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, B,
        Sq, Skv, H, KV, scale, causal, window, softcap, hsplit, kv_part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_dq_wg2<CAP>
        <<<n_dq + n_merge, WG2_THREADS, WG2_Q_SMEM, stream>>>(
            tq, tk, tv, tdo, lse, Dv, (__nv_bfloat16*)dq, B, Sq, Skv, H, KV,
            scale, causal, window, softcap, n_dq, hsplit, kv_part,
            (__nv_bfloat16*)dk, (__nv_bfloat16*)dv);
  } else {
    if ((err = cudaFuncSetAttribute(
             bwd_dkdv_wgmma<DH, CAP>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)KvSmem<DH>::bytes)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             bwd_dq_wgmma<DH, CAP>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)QSmem<DH>::bytes)) != cudaSuccess)
      return (int)err;
    bwd_dkdv_wgmma<DH, CAP>
        <<<n_kt * KV * B * hsplit, WG_THREADS, KvSmem<DH>::bytes, stream>>>(
            tq, tk, tv, tdo, lse, Dv, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
            B, Sq, Skv, H, KV, scale, causal, window, softcap, hsplit,
            kv_part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_dq_wgmma<DH, CAP>
        <<<n_dq + n_merge, WG_THREADS, QSmem<DH>::bytes, stream>>>(
            tq, tk, tv, tdo, lse, Dv, (__nv_bfloat16*)dq, B, Sq, Skv, H, KV,
            scale, causal, window, softcap, n_dq, hsplit, kv_part,
            (__nv_bfloat16*)dk, (__nv_bfloat16*)dv);
  }
  return (int)cudaGetLastError();
}

// The two paths, the soft-cap a template argument of each: bfloat16 on
// wgmma, float32 in split TF32 on mma.sync.
template <int DH>
int launch_dh(int bf16, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* Dv,
              void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H,
              int KV, float scale, int causal, int window, float softcap,
              int hsplit, float* part, int threads, int block, int step,
              int smem, cudaStream_t s) {
  if (!bf16) {
    if (softcap > 0.f)
      return launch_f32<DH, 1>(q, k, v, o, dout, lse, Dv, dq, dk, dv, B, Sq,
                               Skv, H, KV, scale, causal, window, softcap,
                               hsplit, part, threads, block, step, smem, s);
    return launch_f32<DH, 0>(q, k, v, o, dout, lse, Dv, dq, dk, dv, B, Sq,
                             Skv, H, KV, scale, causal, window, softcap,
                             hsplit, part, threads, block, step, smem, s);
  }
  if (softcap > 0.f)
    return launch_wgmma<DH, 1>(q, k, v, o, dout, lse, Dv, dq, dk, dv, B, Sq,
                               Skv, H, KV, scale, causal, window, softcap,
                               hsplit, part, s);
  return launch_wgmma<DH, 0>(q, k, v, o, dout, lse, Dv, dq, dk, dv, B, Sq,
                             Skv, H, KV, scale, causal, window, softcap,
                             hsplit, part, s);
}

}  // namespace

// q, o, dout, dq (B, Sq, H, dh); k, v, dk, dv (B, Skv, KV, dh);
// contiguous, all float32 (bf16 = 0) or all bfloat16 (bf16 = 1), 16-byte
// aligned (TMA and cp.async).  lse is the forward's float32 (B, H, Sq)
// row log-sum-exp; Dv a float32 (B, H, Sq) scratch buffer for D.  scale
// is dh^-0.5 rounded to float32; dh is 32, 64, 80, 128 or 256; a causal
// call needs Sq == Skv.  splits is the caller's count of CTAs that share
// one (batch, kv head, key block)'s walk over the group's q heads
// (kernels/flash_attention.py: bwd_head_splits owns it): 1, or up to H
// / KV, with `part` a float32 workspace of 2 x splits x B x Skv x KV x
// dh for the partial dK and dV (null at 1).  threads, block, step
// and smem are the float32 plan's (kernels/flash_attention.py:
// bwd_plan); bfloat16 calls pass zeros (its launcher sizes its own
// tiles).  Launches three kernels on `stream`; returns the first nonzero
// cudaGetLastError() (or the error of a shared-memory opt-in, or
// cudaErrorInvalidValue for another dh, a float32 plan not the kernels',
// no key at all, a causal call with Sq != Skv, a split count out of
// range, or a tensor map that cannot be made).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* Dv, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int KV, int dh, int bf16,
    int causal, int window, float softcap, float scale, int splits,
    void* part, int threads, int block, int step, int smem, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaGetLastError();
  if (Skv == 0 || (causal && Sq != Skv)) return (int)cudaErrorInvalidValue;
  if (splits < 1 || KV < 1 || splits > H / KV ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* D = (float*)Dv;
  float* P = (float*)part;
  switch (dh) {
    case 32:
      return launch_dh<32>(bf16, q, k, v, o, dout, l, D, dq, dk, dv, B, Sq,
                           Skv, H, KV, scale, causal, window, softcap,
                           splits, P, threads, block, step, smem, s);
    case 64:
      return launch_dh<64>(bf16, q, k, v, o, dout, l, D, dq, dk, dv, B, Sq,
                           Skv, H, KV, scale, causal, window, softcap,
                           splits, P, threads, block, step, smem, s);
    case 80:
      return launch_dh<80>(bf16, q, k, v, o, dout, l, D, dq, dk, dv, B, Sq,
                           Skv, H, KV, scale, causal, window, softcap,
                           splits, P, threads, block, step, smem, s);
    case 128:
      return launch_dh<128>(bf16, q, k, v, o, dout, l, D, dq, dk, dv, B, Sq,
                            Skv, H, KV, scale, causal, window, softcap,
                            splits, P, threads, block, step, smem, s);
    case 256:
      return launch_dh<256>(bf16, q, k, v, o, dout, l, D, dq, dk, dv, B, Sq,
                            Skv, H, KV, scale, causal, window, softcap,
                            splits, P, threads, block, step, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
