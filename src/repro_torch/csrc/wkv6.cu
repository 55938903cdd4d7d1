// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py (wkv6: _kernel),
// which every prefill of every RWKV layer of rwkv6 reaches through
// ops.wkv.  Per (batch, head), with a (dh x dh) float32 state S
// (rows k, columns v) and per step t:
//
//     o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// It writes o (in r's type) and the last state (float32).
//
// What bounds it on the H100: at the rwkv6-7b prefill (B = 4, S = 1024,
// H = 64, dh = 64, bf16) r, k, v, w and o are 168 MB and the states
// 8 MB, 0.053 ms at 3.35 TB/s; the recurrence needs at least three
// float32 instructions per state element per step (k_i * v_j, the
// state's multiply-add, the output's multiply-add), 3.2 G instructions,
// 0.096 ms at the CUDA cores' 33.5 T instructions/s (67 TFLOP/s counted
// as 2 per FMA): operations.  On the card what holds it is not the
// arithmetic but what feeds it: the operands every thread reads from
// shared memory each step, and the latency of one CTA's chain of steps.
//
// Design.  The TPU grid walks time blocks in order with the state in
// VMEM scratch; here one CTA owns one (b, h) and walks S in order, with
// the state in registers, so it never leaves the SM.  Each thread holds
// an R x C block of the state: rows 4 P m + 4 p + e (m < R / 4, e < 4)
// of columns C c .. C c + C - 1, where the P = 64 / R threads p of a
// column block are adjacent lanes of one warp (kernels/wkv6.py: plan;
// R = 8, C = 4: 128 threads).  The u term of o_t is the same for every
// row block, u[i] k_t[i] v_t[j] summed over i being v_t[j] beta_t with
// beta_t = sum_i r_t[i] u[i] k_t[i], so a step is three instructions a
// state element: kv = k_i * v_j, the output's fmaf(r_i, S, acc) on the
// old state, and the update S = fmaf(w_i, S, kv); beta_t is one 64-term
// sum a step, taken for a whole chunk at once.  A step needs, per
// thread, r, k and w of its R rows and v of its C columns, read as
// float4s from shared memory (the P lanes read P adjacent float4s,
// shared by the warp's column blocks): 3 R + C floats for 3 R C
// instructions.  At one column a thread (C = 1) the shared memory's
// delivery, 128 bytes a clock, set the pace; an 8 x 4 block needs a
// third of it.  Time is staged in chunks of T steps: at the start of
// chunk c every thread issues its 16-byte loads of chunk c + 1's r, k, w
// and v (read straight from the model layout (B, S, H, dh) by stride;
// the reference's transpose is not made) into registers, and stores
// them, as float32, into the other half of a double buffer in shared
// memory after chunk c's steps: loads run a whole chunk ahead, and a
// chunk, not a step, costs the barriers.  A thread sums its rows' share
// of r_t S for its C columns in a fixed order and stores the C sums into
// the chunk's (T, P, 64) tile of partials in shared memory; after the
// chunk's barrier each output sums its P partials in row-block order,
// adds v_t[j] beta_t, and goes out in coalesced stores, so no step waits
// on a chain of shuffles.  The staged rows and the partial rows are
// padded so that neither the beta sums nor the partials' reads meet a
// bank conflict.  There are no atomics, and every sum has one order: the
// result is identical run to run.  The chunked tensor-core form, which
// divides by cumulative decays, is not used: at decays near 0.05 a
// 32-step product underflows float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;  // rwkv_head_dim of the supported configs

constexpr int R = 8;   // state rows a thread holds
constexpr int C = 4;   // state columns a thread holds
constexpr int T = 16;  // steps staged at once (a chunk)
constexpr int P = DH / R;  // lanes of a column block
constexpr int THREADS = P * (DH / C);
// rows padded against bank conflicts: a staged row by 8 floats (the beta
// sums read 4 steps' rows at once), a partial row by 4 (a quarter-warp's
// float4 stores of P rows)
constexpr int ILD = DH + 8;
constexpr int PLD = DH + 4;
// float32 r, k, w, v of a chunk, (2, 4, T, ILD), double-buffered; the
// chunk's per-thread partial sums of o, (T, P, PLD); u; beta of a chunk,
// double-buffered
constexpr size_t SMEM_BYTES =
    sizeof(float) * (2 * 4 * T * ILD + T * P * PLD + DH + 2 * T);

__device__ __forceinline__ void unpack(uint4 x, float (&f)[8],
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(w[e] << 16);          // low half first
    f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(uint4 x, float (&f)[4],
                                       const float*) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 f) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(f.x, f.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(f.z, f.w);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                 *reinterpret_cast<uint32_t*>(&hi));
}
__device__ __forceinline__ void store4(float* dst, float4 f) {
  *reinterpret_cast<float4*>(dst) = f;
}

// two CTAs an SM at least: 256 CTAs (B 4 x H 64) fit the 132 SMs in one
// wave
template <typename Tp>
__global__ void __launch_bounds__(THREADS, 2)
    wkv6_kernel(const Tp* __restrict__ r, const Tp* __restrict__ k,
                const Tp* __restrict__ v, const Tp* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                Tp* __restrict__ o, float* __restrict__ s_last, int S,
                int H) {
  constexpr int NT = THREADS;
  constexpr int VW = 16 / sizeof(Tp);  // elements of a 16-byte vector
  constexpr int VPR = DH / VW;         // vectors of one step's row
  constexpr int NV = 4 * T * VPR;      // vectors of a chunk's r, k, w, v
  constexpr int PV = NV / NT;          // of them, a thread's
  static_assert(R % 4 == 0 && C % 4 == 0 && 32 % P == 0, "a block layout");
  static_assert(NV % NT == 0, "a chunk's loads split evenly");
  extern __shared__ __align__(16) float smem_wkv[];
  float* in = smem_wkv;                    // [2][4][T][ILD]: r, k, w, v
  float* part = smem_wkv + 2 * 4 * T * ILD;  // [T][P][PLD]: o's partials
  float* us = part + T * P * PLD;           // [DH]: u
  float* betas = us + DH;                   // [2][T]: beta_t
  constexpr int G = NT / T;  // lanes summing one beta_t
  static_assert(G >= 1 && G <= 32 && 32 % G == 0 && DH % G == 0,
                "a step's beta over adjacent lanes");

  const int tid = threadIdx.x;
  const int p = tid % P;               // row block
  const int j0 = tid / P * C;          // first column of the block
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t step = (size_t)H * DH;  // one sequence position
  const size_t base = (size_t)b * S * step + (size_t)h * DH;
  const size_t state = ((size_t)b * H + h) * DH * DH;

  // row 4 P m + 4 p + e is the thread's row 4 m + e
  float st[R][C];
#pragma unroll
  for (int m = 0; m < R / 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * P * m + 4 * p + e;
#pragma unroll
      for (int c = 0; c < C; ++c)
        st[4 * m + e][c] = s0[state + (size_t)i * DH + j0 + c];
    }
  for (int i = tid; i < DH; i += NT) us[i] = u[(size_t)h * DH + i];

  // chunk c's vectors, a thread's share: vector q of the thread is
  // number tid + NT q of the chunk, array a (r, k, w, v), step t,
  // columns col .. col + VW - 1
  uint4 pre[PV];
  auto fetch = [&](int c) {
#pragma unroll
    for (int q = 0; q < PV; ++q) {
      const int idx = tid + NT * q;
      const int a = idx / (T * VPR), t = idx / VPR % T;
      const int col = idx % VPR * VW;
      const Tp* src = a == 0 ? r : a == 1 ? k : a == 2 ? w : v;
      const int ts = c * T + t;
      pre[q] = ts < S ? *reinterpret_cast<const uint4*>(
                            src + base + (size_t)ts * step + col)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int q = 0; q < PV; ++q) {
      const int idx = tid + NT * q;
      const int a = idx / (T * VPR), t = idx / VPR % T;
      const int col = idx % VPR * VW;
      float f[VW];
      unpack(pre[q], f, r);
      float4* dst = reinterpret_cast<float4*>(
          in + ((buf * 4 + a) * T + t) * ILD + col);
#pragma unroll
      for (int e = 0; e < VW / 4; ++e)
        dst[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2],
                             f[4 * e + 3]);
    }
  };

  // beta_t = sum_i r_t[i] u[i] k_t[i] for the steps of a staged chunk:
  // G adjacent lanes a step, each over rows g, g + G, ..., joined by
  // __shfl_xor_sync (commutative adds: every lane ends with the same bits)
  auto beta = [&](int buf) {
    const int t = tid / G, g = tid % G;
    const float* rt = in + ((buf * 4 + 0) * T + t) * ILD;
    const float* kt = in + ((buf * 4 + 1) * T + t) * ILD;
    float x = 0.f;
#pragma unroll
    for (int i = g; i < DH; i += G) x = fmaf(rt[i] * us[i], kt[i], x);
#pragma unroll
    for (int off = G / 2; off >= 1; off /= 2)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (g == 0) betas[buf * T + t] = x;
  };

  const int chunks = (S + T - 1) / T;
  if (chunks > 0) {
    fetch(0);
    stage(0);
  }
  __syncthreads();
  if (chunks > 0) beta(0);  // read after chunk 0's first barrier
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks) fetch(c + 1);  // lands during this chunk's steps
    const float* rs = in + (buf * 4 + 0) * T * ILD;
    const float* ks = in + (buf * 4 + 1) * T * ILD;
    const float* ws = in + (buf * 4 + 2) * T * ILD;
    const float* vs = in + (buf * 4 + 3) * T * ILD;
    const int n = min(T, S - c * T);
    // a step's operands: r, k, w of the thread's rows, v of its columns
    struct Ops {
      float r[R], k[R], w[R], v[C];
    };
    auto load = [&](int t, Ops& x) {
#pragma unroll
      for (int m = 0; m < R / 4; ++m) {
        const int i0 = t * ILD + 4 * P * m + 4 * p;
        const float4 rq = *reinterpret_cast<const float4*>(rs + i0);
        const float4 kq = *reinterpret_cast<const float4*>(ks + i0);
        const float4 wq = *reinterpret_cast<const float4*>(ws + i0);
        x.r[4 * m] = rq.x, x.r[4 * m + 1] = rq.y, x.r[4 * m + 2] = rq.z,
                  x.r[4 * m + 3] = rq.w;
        x.k[4 * m] = kq.x, x.k[4 * m + 1] = kq.y, x.k[4 * m + 2] = kq.z,
                  x.k[4 * m + 3] = kq.w;
        x.w[4 * m] = wq.x, x.w[4 * m + 1] = wq.y, x.w[4 * m + 2] = wq.z,
                  x.w[4 * m + 3] = wq.w;
      }
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 vq =
            *reinterpret_cast<const float4*>(vs + t * ILD + j0 + 4 * q);
        x.v[4 * q] = vq.x, x.v[4 * q + 1] = vq.y, x.v[4 * q + 2] = vq.z,
                  x.v[4 * q + 3] = vq.w;
      }
    };
    auto advance = [&](int t, const Ops& x) {
      float y[C];  // the thread's rows' share of o_t at its columns
#pragma unroll
      for (int cc = 0; cc < C; ++cc) y[cc] = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const float kv = x.k[i] * x.v[cc];
          y[cc] = fmaf(x.r[i], st[i][cc], y[cc]);
          st[i][cc] = fmaf(x.w[i], st[i][cc], kv);
        }
      float* dst = part + (t * P + p) * PLD + j0;  // to shared memory
#pragma unroll
      for (int q = 0; q < C / 4; ++q)
        reinterpret_cast<float4*>(dst)[q] =
            make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
    };
    // step t + 1's operands are loaded before step t computes
    // (ping-pong, no copies); a load one step past the chunk reads the
    // next array (or the partials), inside shared memory, and is never
    // used
    Ops a, b;
    load(0, a);
    for (int t = 0; t < n; t += 2) {
      load(t + 1, b);
      advance(t, a);
      if (t + 1 == n) break;
      load(t + 2, a);
      advance(t + 1, b);
    }
    if (c + 1 < chunks) stage(buf ^ 1);  // its last reads were chunk c - 1's
    __syncthreads();
    // chunk c's o: each 4 outputs of a step sum their P partials in row
    // block order (a quarter-warp reads 128 contiguous bytes), add
    // v_t[j] beta_t, and go out in one coalesced store
    for (int idx = tid; idx < n * (DH / 4); idx += NT) {
      const int t = idx / (DH / 4), col = idx % (DH / 4) * 4;
      const float* src = part + t * P * PLD + col;
      float4 sum = *reinterpret_cast<const float4*>(src);
#pragma unroll
      for (int q = 1; q < P; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(src + q * PLD);
        sum.x += a.x, sum.y += a.y, sum.z += a.z, sum.w += a.w;
      }
      const float4 vt = *reinterpret_cast<const float4*>(vs + t * ILD + col);
      const float bt = betas[buf * T + t];
      sum.x = fmaf(vt.x, bt, sum.x), sum.y = fmaf(vt.y, bt, sum.y);
      sum.z = fmaf(vt.z, bt, sum.z), sum.w = fmaf(vt.w, bt, sum.w);
      store4(o + base + (size_t)(c * T + t) * step + col, sum);
    }
    if (c + 1 < chunks) beta(buf ^ 1);  // staged before this barrier
    __syncthreads();  // the partials and betas are read before they are
                      // written again
  }
#pragma unroll
  for (int m = 0; m < R / 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * P * m + 4 * p + e;
#pragma unroll
      for (int c = 0; c < C; ++c)
        s_last[state + (size_t)i * DH + j0 + c] = st[4 * m + e][c];
    }
}

template <typename Tp>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* o, void* s_last, int B,
           int S, int H, cudaStream_t stream) {
  // above 48 KB of shared memory only after opting in (per device)
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<Tp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B);
  wkv6_kernel<Tp><<<grid, THREADS, SMEM_BYTES, stream>>>(
      (const Tp*)r, (const Tp*)k, (const Tp*)v, (const Tp*)w,
      (const float*)u, (const float*)s0, (Tp*)o, (float*)s_last, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, o (B, S, H, dh) contiguous and 16-byte aligned, all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1); u (H, dh) float32; s0,
// s_last (B, H, dh, dh) float32; dh must be 64.  threads and smem are
// the launch plan's (kernels/wkv6.py: plan); a plan that is not the
// kernel's is refused.  Launches on `stream`; returns cudaGetLastError().
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* o, void* s_last, int B, int S, int H,
                           int dh, int bf16, int threads, int smem,
                           void* stream) {
  if (dh != DH || threads != THREADS || (size_t)smem != SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, o, s_last, B, S, H, s);
  return launch<float>(r, k, v, w, u, s0, o, s_last, B, S, H, s);
}
