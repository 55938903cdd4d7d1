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
// causal one, a sliding window, keys past S; q_offset is 0 and Sq = Skv
// (training).  A row that sees no key has lse = +inf from the forward, so
// its P is 0 and its dQ is 0, consistent with the forward's 0 output.
//
// What bounds it on the H100: at phi4-mini's training shape (B 4, S 512,
// H 24, KV 8, dh 128, bf16, causal) the inputs and outputs are about 44
// MB (13 us at 3.35 TB/s) and the five products 10·B·H·pairs·dh = 16
// GFLOP, 16 us on the bf16 tensor cores: operations.  This first kernel
// is right and simple instead: float32 FMAs on the CUDA cores (67 TFLOP/s
// at best), S and dP recomputed in both passes, so expect it well above
// its bound (PERF.md has the measured times).  Making it fast (wgmma, a
// pipelined K/V ring, one pass for S) is later work.
//
// Design: three launches, no atomics anywhere, every sum in one fixed
// order, so the gradients are identical run to run.
//  1. bwd_dot: D, one warp a (b, s, h) row.
//  2. bwd_dkdv: one CTA owns one 64-key tile of one kv head of one batch
//     row.  It keeps K and V in shared memory and dK, dV in registers,
//     and walks every q head of its group and every 64-row query tile the
//     mask lets see its keys; for each it stages Q, dO, lse and D,
//     computes S and dP (a 16 x 16 thread grid, 4 x 4 scores a thread),
//     writes P and dS to shared memory and adds P^T dO and dS^T Q.
//  3. bwd_dq: one CTA owns one 64-row query tile of one q head; it walks
//     the key tiles the mask lets through, recomputes S, P, dP and dS
//     the same way and adds dS K.
// Inputs are float32 or bfloat16 (converted to float32 as they are
// staged); every product accumulates in float32; outputs are in q's type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows a tile
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 256;  // a 16 x 16 thread grid
constexpr int R = 4;          // rows (or keys) a thread owns in a tile

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S,
                                        int causal, int window) {
  bool ok = qpos < S && kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// Shared memory of one CTA (both passes): Q and dO tiles (64 query rows),
// K and V tiles (64 keys), rows padded by one float so that a column walk
// is free of bank conflicts; P and dS (64 x 64, padded); lse and D of the
// 64 rows.
template <int DH>
struct Smem {
  static constexpr int LD = DH + 1;
  static constexpr int PLD = BK + 1;
  static constexpr int TILE = 64 * LD;
  static constexpr int PT = BQ * PLD;
  static constexpr size_t bytes =
      sizeof(float) * (4 * TILE + 2 * PT + 2 * BQ);
};

// Stages rows [r0, r0 + 64) of one head of a (B, S, heads, DH) tensor
// into a padded float tile; rows past S are zeros.
template <int DH, typename T>
__device__ __forceinline__ void stage(float* dst, const T* base, int r0,
                                      int S, size_t row_step) {
  for (int i = threadIdx.x; i < 64 * DH; i += THREADS) {
    const int r = i / DH, d = i % DH;
    const int s = r0 + r;
    dst[r * Smem<DH>::LD + d] =
        s < S ? load(base + (size_t)s * row_step + d) : 0.f;
  }
}

// S (scaled, soft-capped) and dP of the 4 x 4 (row, key) pairs of thread
// (ty, tx): rows ty + 16i of Q / dO against keys tx + 16j of K / V.  Then
// P and dS of each pair into shared memory (Ps may be null: dQ needs only
// dS).
template <int DH>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       const float* lse_s, const float* D_s,
                                       float* Ps, float* dSs, int q0, int k0,
                                       int S, float scale, int causal,
                                       int window, float softcap) {
  using M = Smem<DH>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sc[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float a[R], g[R], kk[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a[i] = Qs[(ty + 16 * i) * M::LD + d];
      g[i] = dOs[(ty + 16 * i) * M::LD + d];
      kk[i] = Ks[(tx + 16 * i) * M::LD + d];
      vv[i] = Vs[(tx + 16 * i) * M::LD + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
  }
  const bool capped = softcap > 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    const float lse = lse_s[r], D = D_s[r];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j;
      float s = sc[i][j] * scale, dcap = 1.f;
      if (capped) {
        const float t = tanhf(s / softcap);
        s = softcap * t;
        dcap = 1.f - t * t;
      }
      const float p = visible(q0 + r, k0 + c, S, causal, window)
                          ? expf(s - lse) : 0.f;
      if (Ps != nullptr) Ps[r * M::PLD + c] = p;
      dSs[r * M::PLD + c] = p * (dp[i][j] - D) * dcap;
    }
  }
}

// lse and D of query rows [q0, q0 + 64) of head h; rows past S get lse
// +inf (P = 0) and D 0.
__device__ __forceinline__ void stage_rows(float* lse_s, float* D_s,
                                           const float* lse,
                                           const float* Dv, int q0, int S,
                                           size_t row0) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int s = q0 + r;
    lse_s[r] = s < S ? lse[row0 + s] : __int_as_float(0x7f800000);
    D_s[r] = s < S ? Dv[row0 + s] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO ∘ O), float32 (B, H, S)
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

// ---------------------------------------------------------------------------
// 2. dK and dV: a CTA a (key tile, kv head, batch row)
// ---------------------------------------------------------------------------
template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ Dv,
             T* __restrict__ dk, T* __restrict__ dv, int S, int H, int KV,
             float scale, int causal, int window, float softcap) {
  using M = Smem<DH>;
  constexpr int C = DH / 16;  // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + M::TILE;
  float* Ks = dOs + M::TILE;
  float* Vs = Ks + M::TILE;
  float* Ps = Vs + M::TILE;
  float* dSs = Ps + M::PT;
  float* lse_s = dSs + M::PT;
  float* D_s = lse_s + BQ;

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t q_step = (size_t)H * DH, kv_step = (size_t)KV * DH;

  stage<DH>(Ks, k + (size_t)b * S * kv_step + (size_t)kvh * DH, k0, S,
            kv_step);
  stage<DH>(Vs, v + (size_t)b * S * kv_step + (size_t)kvh * DH, k0, S,
            kv_step);

  // the query tiles that can see a key of this tile
  const int kmax = min(k0 + BK, S) - 1;
  const int qt_start = causal ? k0 / BQ : 0;
  const int q_end = window > 0 ? min(S, kmax + window) : S;
  const int qt_end = (q_end + BQ - 1) / BQ;

  float dK[R][C], dV[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dK[i][c] = dV[i][c] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const T* qb = q + (size_t)b * S * q_step + (size_t)h * DH;
    const T* gb = dout + (size_t)b * S * q_step + (size_t)h * DH;
    const size_t row0 = ((size_t)b * H + h) * S;
    for (int qt = qt_start; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the last tile's P, dS, Q and dO reads are done
      stage<DH>(Qs, qb, q0, S, q_step);
      stage<DH>(dOs, gb, q0, S, q_step);
      stage_rows(lse_s, D_s, lse, Dv, q0, S, row0);
      __syncthreads();
      scores<DH>(Qs, dOs, Ks, Vs, lse_s, D_s, Ps, dSs, q0, k0, S, scale,
                 causal, window, softcap);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's 64 rows, in row order
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float p[R], ds[R], g[C], a[C];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          p[i] = Ps[r * M::PLD + ty + 16 * i];
          ds[i] = dSs[r * M::PLD + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          g[c] = dOs[r * M::LD + tx + 16 * c];
          a[c] = Qs[r * M::LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            dV[i][c] = fmaf(p[i], g[c], dV[i][c]);
            dK[i][c] = fmaf(ds[i], a[c], dK[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s < S) {
      const size_t off = ((size_t)b * S + s) * kv_step + (size_t)kvh * DH;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        store(dk + off + tx + 16 * c, dK[i][c] * scale);
        store(dv + off + tx + 16 * c, dV[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: a CTA a (query tile, q head, batch row)
// ---------------------------------------------------------------------------
template <int DH, typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ Dv,
           T* __restrict__ dq, int S, int H, int KV, float scale, int causal,
           int window, float softcap) {
  using M = Smem<DH>;
  constexpr int C = DH / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + M::TILE;
  float* Ks = dOs + M::TILE;
  float* Vs = Ks + M::TILE;
  float* dSs = Vs + M::TILE + M::PT;  // the P slot stays unused
  float* lse_s = dSs + M::PT;
  float* D_s = lse_s + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t q_step = (size_t)H * DH, kv_step = (size_t)KV * DH;
  const T* kb = k + (size_t)b * S * kv_step + (size_t)kvh * DH;
  const T* vb = v + (size_t)b * S * kv_step + (size_t)kvh * DH;

  stage<DH>(Qs, q + (size_t)b * S * q_step + (size_t)h * DH, q0, S, q_step);
  stage<DH>(dOs, dout + (size_t)b * S * q_step + (size_t)h * DH, q0, S,
            q_step);
  stage_rows(lse_s, D_s, lse, Dv, q0, S, ((size_t)b * H + h) * S);

  // the key tiles rows [q0, q0 + 64) can see (the forward's key_tiles)
  const int qhi = min(q0 + BQ, S) - 1;
  int kt_end = (S + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, qhi / BK + 1);
  const int kt_start =
      window > 0 && q0 - window + 1 > 0 ? (q0 - window + 1) / BK : 0;

  float dQ[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dQ[i][c] = 0.f;

  for (int kt = kt_start; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's dS and K reads are done
    stage<DH>(Ks, kb, k0, S, kv_step);
    stage<DH>(Vs, vb, k0, S, kv_step);
    __syncthreads();
    scores<DH>(Qs, dOs, Ks, Vs, lse_s, D_s, nullptr, dSs, q0, k0, S, scale,
               causal, window, softcap);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[R], kv[C];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = dSs[(ty + 16 * i) * M::PLD + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = Ks[kk * M::LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) dQ[i][c] = fmaf(ds[i], kv[c], dQ[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s < S) {
      const size_t off = ((size_t)b * S + s) * q_step + (size_t)h * DH;
#pragma unroll
      for (int c = 0; c < C; ++c)
        store(dq + off + tx + 16 * c, dQ[i][c] * scale);
    }
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* Dv, void* dq, void* dk,
           void* dv, int B, int S, int H, int KV, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  const size_t smem = Smem<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv<DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq<DH, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long rows = (long)B * S * H;
  const int dot_blocks = (int)((rows + THREADS / 32 - 1) / (THREADS / 32));
  bwd_dot<T><<<dot_blocks, THREADS, 0, stream>>>(
      (const T*)o, (const T*)dout, Dv, B, S, H, DH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 kv_grid((S + BK - 1) / BK, KV, B);
  bwd_dkdv<DH, T><<<kv_grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, Dv,
      (T*)dk, (T*)dv, S, H, KV, scale, causal, window, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 q_grid((S + BQ - 1) / BQ, H, B);
  bwd_dq<DH, T><<<q_grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, Dv,
      (T*)dq, S, H, KV, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dtype(int bf16, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const float* lse,
                 float* Dv, void* dq, void* dk, void* dv, int B, int S,
                 int H, int KV, float scale, int causal, int window,
                 float softcap, cudaStream_t s) {
  if (bf16)
    return launch<DH, __nv_bfloat16>(q, k, v, o, dout, lse, Dv, dq, dk, dv,
                                     B, S, H, KV, scale, causal, window,
                                     softcap, s);
  return launch<DH, float>(q, k, v, o, dout, lse, Dv, dq, dk, dv, B, S, H,
                           KV, scale, causal, window, softcap, s);
}

}  // namespace

// q, o, dout, dq (B, S, H, dh); k, v, dk, dv (B, S, KV, dh); contiguous,
// all float32 (bf16 = 0) or all bfloat16 (bf16 = 1).  lse is the
// forward's float32 (B, H, S) row log-sum-exp; Dv a float32 (B, H, S)
// scratch buffer for D.  scale is dh^-0.5 rounded to float32; dh is 32,
// 64 or 128.  Launches three kernels on `stream`; returns the first
// nonzero cudaGetLastError() (or cudaErrorInvalidValue for another dh).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* Dv, void* dq, void* dk,
    void* dv, int B, int S, int H, int KV, int dh, int bf16, int causal,
    int window, float softcap, float scale, void* stream) {
  if (B == 0 || S == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* D = (float*)Dv;
  switch (dh) {
    case 32:
      return launch_dtype<32>(bf16, q, k, v, o, dout, l, D, dq, dk, dv, B, S,
                              H, KV, scale, causal, window, softcap, s);
    case 64:
      return launch_dtype<64>(bf16, q, k, v, o, dout, l, D, dq, dk, dv, B, S,
                              H, KV, scale, causal, window, softcap, s);
    case 128:
      return launch_dtype<128>(bf16, q, k, v, o, dout, l, D, dq, dk, dv, B,
                               S, H, KV, scale, causal, window, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
