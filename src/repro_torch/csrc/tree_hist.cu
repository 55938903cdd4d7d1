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
// What bounds it on the H100: the bytes it must move are small (about
// 9.4 MB at the student level-5 shape G=40, N=8192, F=14, K=2, n=32,
// B=32: under 3 us of HBM time), so by bytes it is memory-light; the
// dense formulation below does N x K*n*B compare-and-adds per (tree,
// feature) on the CUDA cores, the same dense work as the TPU kernel's
// one-hot x one-hot contraction, and that compare work is what it
// spends its time on.
//
// Design, deterministic by construction (no float atomics, in global or
// shared memory): one CTA per (tree g, feature f).  Its threads own the
// K*n*B output cells, CELLS_PER_THREAD each per pass.  All threads walk
// the samples in one fixed order through a tile staged in shared memory
// (the fused node*B + bin key and the K weights of each sample), and
// each thread adds w[k, i] to the one cell it owns that sample i hits,
// if any.  Every cell is written once, summed in sample order, so a
// GBDT's float g/h give the same bits on every run and for every batch
// size.  Rows padded at w = 0 add exact zeros.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CELLS_PER_THREAD = 8;
constexpr int TILE = 512;
constexpr int W_STRIDE = TILE + 1;  // weights of channel k at k*W_STRIDE
constexpr int MAX_K = 16;

__global__ void __launch_bounds__(THREADS)
tree_hist_kernel(const int* __restrict__ xb, const int* __restrict__ node,
                 const float* __restrict__ w, float* __restrict__ out,
                 int Gf, int G, int N, int F, int K, int n, int B) {
  extern __shared__ int smem[];
  int* key_s = smem;                             // TILE fused keys
  float* w_s = (float*)(smem + TILE);            // K x W_STRIDE weights

  const int f = blockIdx.x;
  const int g = blockIdx.y;
  const int gf = g / (G / Gf);
  const int nB = n * B;
  const int cells = K * nB;
  const int* xb_g = xb + (size_t)gf * N * F;
  const int* node_g = node + (size_t)g * N;
  const float* w_g = w + (size_t)g * K * N;
  float* out_g = out + (size_t)g * K * nB * F;

  for (int base = 0; base < cells; base += THREADS * CELLS_PER_THREAD) {
    float acc[CELLS_PER_THREAD];
    int ckey[CELLS_PER_THREAD];   // node*B + bin of the owned cell
    int woff[CELLS_PER_THREAD];   // its channel's row in w_s
#pragma unroll
    for (int j = 0; j < CELLS_PER_THREAD; ++j) {
      const int c = base + j * THREADS + threadIdx.x;
      acc[j] = 0.0f;
      ckey[j] = c < cells ? c % nB : -1;       // -1 never matches a key
      woff[j] = c < cells ? (c / nB) * W_STRIDE : 0;
    }
    for (int i0 = 0; i0 < N; i0 += TILE) {
      const int len = min(TILE, N - i0);
      __syncthreads();
      for (int i = threadIdx.x; i < len; i += THREADS) {
        const int s = i0 + i;
        key_s[i] = node_g[s] * B + xb_g[(size_t)s * F + f];
        for (int k = 0; k < K; ++k)
          w_s[k * W_STRIDE + i] = w_g[(size_t)k * N + s];
      }
      __syncthreads();
      for (int i = 0; i < len; ++i) {
        const int key = key_s[i];
#pragma unroll
        for (int j = 0; j < CELLS_PER_THREAD; ++j)
          if (key == ckey[j]) acc[j] += w_s[woff[j] + i];
      }
    }
#pragma unroll
    for (int j = 0; j < CELLS_PER_THREAD; ++j) {
      const int c = base + j * THREADS + threadIdx.x;
      if (c < cells) {
        const int k = c / nB, r = c % nB;
        const int nn = r / B, b = r % B;
        out_g[(((size_t)k * n + nn) * F + f) * B + b] = acc[j];
      }
    }
  }
}

}  // namespace

extern "C" int tree_hist_max_channels() { return MAX_K; }

// xb (Gf, N, F) int32 with values in [0, B); node (G, N) int32 in
// [0, n); w (G, K, N) float32; out (G, K, n, F, B) float32.  G must be
// a multiple of Gf and K at most MAX_K.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int tree_hist_launch(const void* xb, const void* node,
                                const void* w, void* out, int Gf, int G,
                                int N, int F, int K, int n, int B,
                                void* stream) {
  if (G > 0 && F > 0) {
    const size_t smem = sizeof(int) * TILE + sizeof(float) * K * W_STRIDE;
    dim3 grid(F, G);
    tree_hist_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)xb, (const int*)node, (const float*)w, (float*)out, Gf,
        G, N, F, K, n, B);
  }
  return (int)cudaGetLastError();
}
