// Weighted (channel, node, feature, bin) histograms for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/tree_hist.py (tree_hist:
// _kernel), which every depth level and every leaf build of the RF and
// GBDT fits runs:
//
//   hist[g, k, n, f, b] = sum_i w[g, k, i] [node[g, i] == n]
//                                          [xb[g / (G / Gf), i, f] == b]
//
// The reference vmaps the kernel over trees; here a leading batch axis
// takes its place, so one launch builds a whole stacked level: all
// forests x trees of a party's teacher grid, or all stacked GBDTs of a
// boosting round.  xb is (Gf, N, F), shared by the G / Gf trees of a
// forest; node is (G, N); w is (G, K, N); the output is (G, K, n, F, B).
//
// What bounds it on the H100: bytes.  At the student level-5 shape (G =
// 40, N = 8192, F = 14, K = 2, n = 32, B = 32) it must move about 9.4 MB,
// under 3 us of HBM time, and do N * K adds per (tree, feature): 9.2 M
// adds in all, far under a microsecond of the CUDA cores.  The TPU
// kernel's one-hot x one-hot contraction does N * K * n * B multiply-adds
// per (tree, feature), 1,024 times the useful work at that shape; a
// port that keeps the dense form (every cell compared with every sample)
// is bound by that compare work and walks every sample serially per
// (tree, feature).
//
// Design: sample-parallel, about N * K adds per (tree, feature), and
// deterministic by construction (no float atomics, in global or shared
// memory).  Two kernels make one launch:
//
//  1. chunk_hist.  Each tree's rows are cut into chunks of `chunk` rows
//     at fixed row indices from 0 (the chunk size depends only on n * B,
//     never on N or G, so a serial fit and a stacked fit cut a tree's
//     rows alike).  One CTA per (tree, chunk, group of features), one
//     warp per feature.  A warp holds a private histogram of its feature
//     in shared memory (a window of the fused key node * B + bin, for all
//     K channels; wide key spaces take several windows).  The CTA stages
//     its rows' node ids and weights in shared memory 512 rows at a time;
//     each warp then loads its feature's bins for all 16 of the block's
//     32-row steps at once (16 loads in flight, not one a step) and walks
//     the steps in order: __match_any_sync groups the 32 rows by key, and
//     each group's leader sums the group's weights in lane order (from
//     +0.0) and adds the sum to the cell, which no other thread writes.
//     So every sample's weight is added once, into the one cell its
//     (node, bin) names, and each cell of a chunk is summed in one fixed
//     order of its rows.  The warp writes its window, touched or not, as
//     the chunk's partial histogram.  The warps of a CTA read the same
//     rows, so the (N, F) layout's strided bins are shared through L1.
//  2. combine.  One thread per output cell adds the chunks' partials in
//     chunk order, from +0.0.  With one chunk, chunk_hist writes the
//     output directly (0.0 + p == p: no partial is ever -0.0).
//
// Rows padded at w = 0 (a stacked fit's tail) add +0.0 or -0.0 to
// sums that are never -0.0, and whole chunks of padding give partials
// of +0.0: exact no-ops, so stacked fits equal serial fits bit for bit.
// The float order differs from a single sample-order walk: integer
// weights (RF counts) stay exact, float weights (GBDT g/h) stay within
// float32 summation's own limit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 16;
constexpr int MAX_WARPS = 8;
constexpr int SUB = 512;         // rows staged in shared memory at a time
constexpr int STEPS = SUB / 32;  // 32-row warp steps a staged block

__global__ void __launch_bounds__(MAX_WARPS * 32)
chunk_hist(const int* __restrict__ xb, const int* __restrict__ node,
           const float* __restrict__ w, float* __restrict__ part, int Gf,
           int G, int N, int F, int K, int n, int B, int chunk, int C,
           int window, int fw) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.y * fw + warp;
  const bool has_f = f < F;  // a warp past F stages rows, builds nothing
  const int g = blockIdx.x / C;
  const int c = blockIdx.x % C;
  const int gf = g / (G / Gf);
  const int nB = n * B;
  float* hist = smem + (size_t)warp * K * window;  // K x window, this warp's
  float* w_s = smem + (size_t)fw * K * window;     // K x SUB weights
  int* node_s = reinterpret_cast<int*>(w_s + (size_t)K * SUB);  // SUB
  const int r_lo = c * chunk;
  const int r_hi = min(N, r_lo + chunk);
  const int* xb_f = xb + (size_t)gf * N * F + (has_f ? f : 0);
  const int* node_g = node + (size_t)g * N;
  const float* w_g = w + (size_t)g * K * N;
  float* part_g = part + ((size_t)g * C + c) * K * nB * F;

  for (int lo = 0; lo < nB; lo += window) {
    const int span = min(window, nB - lo);
    for (int j = lane; j < K * window; j += 32) hist[j] = 0.0f;
    for (int s0 = r_lo; s0 < r_hi; s0 += SUB) {
      const int len = min(SUB, r_hi - s0);
      __syncthreads();  // every warp is done with the last staged block
      for (int j = threadIdx.x; j < len; j += blockDim.x)
        node_s[j] = node_g[s0 + j];
      for (int j = threadIdx.x; j < K * len; j += blockDim.x) {
        const int k = j / len, r = j - k * len;
        w_s[k * SUB + r] = w_g[(size_t)k * N + s0 + r];
      }
      // this lane's bin in every step of the block, all loads in flight
      int bin[STEPS];
#pragma unroll
      for (int t = 0; t < STEPS; ++t) {
        const int r = 32 * t + lane;
        bin[t] = has_f && r < len ? xb_f[(size_t)(s0 + r) * F] : 0;
      }
      __syncthreads();
      if (!has_f) continue;
#pragma unroll
      for (int t = 0; t < STEPS; ++t) {
        const int r = 32 * t + lane;
        int key = -1;  // -1: a row past the chunk or outside the window
        if (r < len) {
          const int kk = node_s[r] * B + bin[t] - lo;
          key = (kk >= 0 && kk < span) ? kk : -1;
        }
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (key >= 0 && __ffs(peers) - 1 == lane) {
          for (int k = 0; k < K; ++k) {
            const float* wk = w_s + k * SUB + 32 * t;
            float sum = 0.0f;
            for (unsigned m = peers; m; m &= m - 1) sum += wk[__ffs(m) - 1];
            hist[k * window + key] += sum;
          }
        }
        __syncwarp();  // this step's cells are written before the next's
      }
    }
    if (has_f) {
      for (int k = 0; k < K; ++k)
        for (int j = lane; j < span; j += 32) {
          const int key = lo + j;
          part_g[(((size_t)k * n + key / B) * F + f) * B + key % B] =
              hist[k * window + j];
        }
    }
    __syncwarp();
  }
}

__global__ void combine(const float* __restrict__ part,
                        float* __restrict__ out, int G, int C,
                        size_t cells) {
  const size_t total = (size_t)G * cells;
  for (size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x; t < total;
       t += (size_t)gridDim.x * blockDim.x) {
    const size_t g = t / cells;
    const float* p = part + g * C * cells + (t - g * cells);
    float s = 0.0f;
    for (int c = 0; c < C; ++c) s += p[(size_t)c * cells];
    out[t] = s;
  }
}

}  // namespace

extern "C" int tree_hist_max_channels() { return MAX_K; }

// xb (Gf, N, F) int32 with values in [0, B); node (G, N) int32 in
// [0, n); w (G, K, N) float32; out (G, K, n, F, B) float32; part the
// scratch for C > 1 chunks, (G, C, K, n, F, B) float32 (unused and may
// be null for C <= 1).  G must be a multiple of Gf, K at most MAX_K.
// The plan (chunk rows, C = ceil(N / chunk), key window, fw warps a CTA)
// comes from the wrapper (kernels/tree_hist.py: plan).  Launches on
// `stream`; returns cudaGetLastError() or the error of the
// shared-memory opt-in.
extern "C" int tree_hist_launch(const void* xb, const void* node,
                                const void* w, void* out, void* part,
                                int Gf, int G, int N, int F, int K, int n,
                                int B, int chunk, int C, int window, int fw,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (G <= 0 || F <= 0 || K <= 0 || n <= 0 || B <= 0)
    return (int)cudaGetLastError();
  if (K > MAX_K || fw < 1 || fw > MAX_WARPS || window < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const size_t cells = (size_t)K * n * F * B;
  if (C >= 1) {
    const size_t smem =
        sizeof(float) * ((size_t)fw * K * window + (size_t)K * SUB + SUB);
    // opt in to the device's whole per-block shared memory, not this
    // launch's bytes: plans differ in their bytes, and a thread setting
    // its own smaller cap between another thread's opt-in and launch
    // fails that launch (the thread and socket transports launch from a
    // thread a party)
    int dev = 0, cap = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          chunk_hist, cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)G * C, (F + fw - 1) / fw);
    chunk_hist<<<grid, fw * 32, smem, s>>>(
        (const int*)xb, (const int*)node, (const float*)w,
        (float*)(C == 1 ? out : part), Gf, G, N, F, K, n, B, chunk, C,
        window, fw);
    if (C == 1) return (int)cudaGetLastError();
  }
  const size_t total = (size_t)G * cells;
  const size_t blocks = (total + 255) / 256;
  combine<<<(unsigned)(blocks < (1u << 20) ? blocks : (1u << 20)), 256, 0,
            s>>>((const float*)part, (float*)out, G, C, cells);
  return (int)cudaGetLastError();
}
