// Teacher-ensemble vote aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/vote_aggregate.py
// (vote_aggregate: _kernel, _block_top2, _fold_top2).  For each of T
// queries it counts the M teacher votes per class, adds the (T, U)
// noise, and keeps the noisy argmax (first occurrence) with its top-2
// plus the clean (pre-noise) top-2 of the same counts — the Lemma-7
// gap input — without materialising the (T, U) histogram.
//
// Exactness.  Every score is one float add of an integer count and a
// noise value (0.0f + noise for a class no teacher chose), and the rest
// is compares, so all five outputs equal the plain version bit for bit
// whatever order the classes are visited in, as long as partial results
// merge by one rule (merge() below, the TPU kernel's _fold_top2 made
// order-free): the larger value wins, an equal value goes to the
// smaller class, and the loser's best joins the seconds, so an exact
// tie gives top2 == top1.  No atomics: identical run to run.
//
// Two layouts; the launcher picks one by U.
//
//  - A CTA per query (U > SMALL_U): the token vote's shape, U a
//    vocabulary (phi4-mini: 200,064) and T = B x S queries.  What
//    bounds it on the H100 is the one read of the (T, U) noise: 0.82 GB
//    at T = 1024, 0.245 ms at 3.35 TB/s.  The query's M predictions go
//    to shared memory once.  Only the classes a teacher chose (at most
//    M) have a nonzero count, so the noise row is streamed coalesced,
//    in 16-byte vectors, with every other class scored 0.0f + noise; a
//    class is checked against the predictions only when it could enter
//    the thread's top-2 (rare once the running second is high), and a
//    chosen class is skipped there.  32 registers a thread keep 8 CTAs
//    on an SM, so T = 1024 runs in one wave.  Warps merge by shuffles,
//    then the warps in order.
//    Thread 0 then folds in the chosen classes with their counts, and
//    builds the clean top-2 from the predictions alone, O(M^2): the
//    distinct predictions' counts, and, if fewer than U distinct
//    classes were chosen, a count of 0 at the smallest class none chose.
//  - A thread per query (U <= SMALL_U): the round's shape (M = 5, T =
//    6105, U = 2) moves about 0.3 MB, under a microsecond of HBM time,
//    so a launch costs more than the work.  Each thread reads its M
//    predictions once, counts them into registers (2 or 32 counters),
//    and walks its U classes in order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NO_CLASS = 0x7fffffff;
constexpr int SMALL_U = 32;         // up to here: a thread per query
constexpr int SMALL_THREADS = 128;
constexpr int ROW_THREADS = 256;    // a CTA per query above SMALL_U
constexpr int ROW_MAX_M = 12000;    // its staging: M ints, under 48 KB

// (best, its class, the best of the rest) of a set of classes
struct Top2 {
  float best;
  int arg;
  float second;
};

__device__ __forceinline__ Top2 none() { return {NEG_INF, NO_CLASS, NEG_INF}; }

// The top-2 of the union of two disjoint sets of classes
__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  const bool take = b.best > a.best || (b.best == a.best && b.arg < a.arg);
  const Top2 w = take ? b : a;
  const Top2 l = take ? a : b;
  return {w.best, w.arg, fmaxf(l.best, fmaxf(w.second, l.second))};
}

__device__ __forceinline__ Top2 add_class(Top2 a, float s, int c) {
  return merge(a, {s, c, NEG_INF});
}

__device__ __forceinline__ Top2 shfl_xor(Top2 a, int lanes) {
  return {__shfl_xor_sync(0xffffffffu, a.best, lanes),
          __shfl_xor_sync(0xffffffffu, a.arg, lanes),
          __shfl_xor_sync(0xffffffffu, a.second, lanes)};
}

__device__ __forceinline__ bool chosen(const int* sp, int M, int c) {
  for (int m = 0; m < M; ++m)
    if (sp[m] == c) return true;
  return false;
}

// One class a teacher may have chosen, seen by a thread of the row
// layout: skipped if chosen (thread 0 folds those in with their counts)
__device__ __forceinline__ Top2 stream_class(Top2 a, const int* sp, int M,
                                             float noise, int c) {
  const float s = __fadd_rn(0.0f, noise);
  if (s >= a.second && !chosen(sp, M, c)) a = add_class(a, s, c);
  return a;
}

__device__ __forceinline__ Top2 stream4(Top2 a, const int* sp, int M,
                                        float4 q, int c) {
  const float m = fmaxf(fmaxf(q.x, q.y), fmaxf(q.z, q.w));
  if (__fadd_rn(0.0f, m) >= a.second) {  // rare once a.second is high
    a = stream_class(a, sp, M, q.x, c);
    a = stream_class(a, sp, M, q.y, c + 1);
    a = stream_class(a, sp, M, q.z, c + 2);
    a = stream_class(a, sp, M, q.w, c + 3);
  }
  return a;
}

__global__ void __launch_bounds__(ROW_THREADS, 8)
    vote_rows(const int* __restrict__ preds, const float* __restrict__ noise,
              int M, int T, int U, int* __restrict__ labels,
              float* __restrict__ top1, float* __restrict__ top2,
              float* __restrict__ clean1, float* __restrict__ clean2) {
  extern __shared__ int sp[];  // the query's M predictions
  __shared__ Top2 warp_top[ROW_THREADS / 32];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  for (int m = tid; m < M; m += ROW_THREADS) sp[m] = preds[(size_t)m * T + t];
  __syncthreads();

  // the classes no teacher chose, scored 0.0f + noise
  Top2 part = none();
  if (noise != nullptr) {
    const float* row = noise + (size_t)t * U;
    // scalars up to a 16-byte boundary, float4s, then the tail
    const int head =
        min(U, (int)(((16 - ((uintptr_t)row & 15)) & 15) / sizeof(float)));
    const int nvec = (U - head) / 4;
    const float4* body = reinterpret_cast<const float4*>(row + head);
    if (tid < head) part = stream_class(part, sp, M, __ldg(row + tid), tid);
    int v = tid;
    for (; v + 3 * ROW_THREADS < nvec; v += 4 * ROW_THREADS) {
      float4 q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = __ldcs(body + v + k * ROW_THREADS);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        part = stream4(part, sp, M, q[k], head + 4 * (v + k * ROW_THREADS));
    }
    for (; v < nvec; v += ROW_THREADS)
      part = stream4(part, sp, M, __ldcs(body + v), head + 4 * v);
    for (int c = head + 4 * nvec + tid; c < U; c += ROW_THREADS)
      part = stream_class(part, sp, M, __ldg(row + c), c);
  }
#pragma unroll
  for (int lanes = 16; lanes > 0; lanes >>= 1)
    part = merge(part, shfl_xor(part, lanes));
  if ((tid & 31) == 0) warp_top[tid / 32] = part;
  __syncthreads();
  if (tid != 0) return;
  Top2 noisy = warp_top[0];
  for (int w = 1; w < ROW_THREADS / 32; ++w) noisy = merge(noisy, warp_top[w]);

  // the chosen classes, each once, with its count
  Top2 clean = none();
  int distinct = 0;
  for (int m = 0; m < M; ++m) {
    const int p = sp[m];
    if (p < 0 || p >= U || chosen(sp, m, p)) continue;
    ++distinct;
    int count = 0;
    for (int j = m; j < M; ++j) count += sp[j] == p;
    const float cf = (float)count;
    clean = add_class(clean, cf, p);
    if (noise != nullptr)
      noisy = add_class(noisy, __fadd_rn(cf, noise[(size_t)t * U + p]), p);
  }
  // the classes none chose: count 0, the first at the smallest such class
  if (distinct < U) {
    int z = 0;
    while (chosen(sp, M, z)) ++z;
    clean = merge(clean, {0.0f, z, distinct + 1 < U ? 0.0f : NEG_INF});
  }
  if (noise == nullptr) noisy = clean;
  labels[t] = noisy.arg;
  top1[t] = noisy.best;
  top2[t] = noisy.second;
  clean1[t] = clean.best;
  clean2[t] = clean.second;
}

// U <= UB classes: the counts live in registers
template <int UB>
__global__ void __launch_bounds__(SMALL_THREADS)
    vote_small(const int* __restrict__ preds, const float* __restrict__ noise,
               int M, int T, int U, int* __restrict__ labels,
               float* __restrict__ top1, float* __restrict__ top2,
               float* __restrict__ clean1, float* __restrict__ clean2) {
  const int t = blockIdx.x * SMALL_THREADS + threadIdx.x;
  if (t >= T) return;
  int counts[UB];
#pragma unroll
  for (int c = 0; c < UB; ++c) counts[c] = 0;
  for (int m = 0; m < M; ++m) {
    const int p = __ldg(preds + (size_t)m * T + t);
#pragma unroll
    for (int c = 0; c < UB; ++c) counts[c] += p == c;
  }
  Top2 noisy = none(), clean = none();
#pragma unroll
  for (int c = 0; c < UB; ++c) {
    if (c >= U) break;
    const float cf = (float)counts[c];
    // classes in order: a strict '>' keeps the first of equal values
    if (cf > clean.best) {
      clean = {cf, c, clean.best};
    } else {
      clean.second = fmaxf(clean.second, cf);
    }
    const float s =
        noise != nullptr ? __fadd_rn(cf, __ldg(noise + (size_t)t * U + c))
                         : cf;
    if (s > noisy.best) {
      noisy = {s, c, noisy.best};
    } else {
      noisy.second = fmaxf(noisy.second, s);
    }
  }
  labels[t] = noisy.arg;
  top1[t] = noisy.best;
  top2[t] = noisy.second;
  clean1[t] = clean.best;
  clean2[t] = clean.second;
}

template <int UB>
void launch_small(const int* p, const float* n, int M, int T, int U,
                  void* labels, void* top1, void* top2, void* clean1,
                  void* clean2, cudaStream_t s) {
  const int blocks = (T + SMALL_THREADS - 1) / SMALL_THREADS;
  vote_small<UB><<<blocks, SMALL_THREADS, 0, s>>>(
      p, n, M, T, U, (int*)labels, (float*)top1, (float*)top2,
      (float*)clean1, (float*)clean2);
}

}  // namespace

// preds (M, T) int32; noise (T, U) float32 or null (adds 0.0); outputs
// (T,) each.  Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for an M past the staging's room).
extern "C" int vote_aggregate_launch(const void* preds, const void* noise,
                                     void* labels, void* top1, void* top2,
                                     void* clean1, void* clean2, int M,
                                     int T, int U, void* stream) {
  if (T == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int* p = (const int*)preds;
  const float* n = (const float*)noise;
  if (U <= 2) {  // the round's binary vote: two counters, not 32
    launch_small<2>(p, n, M, T, U, labels, top1, top2, clean1, clean2, s);
  } else if (U <= SMALL_U) {
    launch_small<SMALL_U>(p, n, M, T, U, labels, top1, top2, clean1,
                          clean2, s);
  } else {
    if (M > ROW_MAX_M) return (int)cudaErrorInvalidValue;
    vote_rows<<<T, ROW_THREADS, sizeof(int) * M, s>>>(
        p, n, M, T, U, (int*)labels, (float*)top1, (float*)top2,
        (float*)clean1, (float*)clean2);
  }
  return (int)cudaGetLastError();
}
