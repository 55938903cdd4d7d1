// The backward pass of the RWKV-6 WKV recurrence (dr, dk, dv, dw, du,
// ds0) for Hopper (sm_90a).
//
// No TPU kernel to replace: the reference has no backward Pallas kernel
// and trains rwkv6, off the TPU, through autodiff of its xla recurrence
// (src/repro/kernels/ops.py: _wkv_xla_chunked, per-chunk remat of
// ref.wkv6_ref).  This is the gradient of the forward kernel
// csrc/wkv6.cu (which replaces src/repro/kernels/wkv6.py: wkv6), so the
// RWKV layers train on the card through hand-written kernels both ways.
// Per (batch, head), with S_t the (dh x dh) float32 state after step t
// (S_{-1} = s0; rows i over the key, columns j over the value
// dimension), G_t = dL/dS_t (G_{S-1} = ds_last) and the upstream do_t:
//
//   dr_t = S_{t-1} do_t + u * k_t (v_t . do_t)
//   dk_t = G_t v_t + u * r_t (v_t . do_t)
//   dv_t = G_t^T k_t + (sum_i r_t u k_t) do_t
//   dw_t = rowsum(G_t * S_{t-1})
//   G_{t-1} = diag(w_t) G_t + r_t do_t^T,   ds0 = G_{-1}
//   du = sum over b and t of r_t * k_t (v_t . do_t)
//
// What makes it hard: dr and dw need the forward states S_{t-1}, and dk,
// dv and dw need G_t, which runs backward in time; dw needs both at the
// same step.  S_{t-1} is never rebuilt backward from S_t by dividing by
// w_t (a bf16 decay can round to 0, and the division amplifies the
// cancellation), and dw is not taken as a difference of suffix sums.
//
// What bounds it on the H100: at rwkv6-7b's train shape (B 4, S 512,
// H 64, dh 64, bf16) the inputs r, k, v, w, do and the outputs dr, dk,
// dv, dw are 151 MB, s0, ds_last and ds0 13 MB (0.049 ms at 3.35 TB/s);
// the state work is at least 13 float32 operations a state element a
// step (3 to build the states once, 2 each for dr, dk, dw, 1 for dv, 3
// for G's update), 7.0 GFLOP, 0.104 ms at 67 TFLOP/s: operations.  As
// built it does 16 (the states are built twice: once for the
// checkpoints, once per chunk).  What holds it on the card is the
// chain of steps one CTA walks, and the cross-thread sums a step needs.
//
// Design: one CTA of 256 threads owns one (b, h); thread (i, q) holds
// row i of the state and of G at columns 16 q .. 16 q + 15, so the three
// row sums a step (dr, dk, dw) are 16-term sums in a thread and two
// shuffles across the 4 adjacent lanes of a row.  Two walks:
//  1. forward, over chunks of T steps: the state before each chunk goes
//     to a float32 checkpoint workspace (B, H, ceil(S / T), dh, dh) that
//     the wrapper allocates;
//  2. backward, chunk by chunk from the last: the chunk's checkpoint is
//     reloaded and its T states S_{t-1} rebuilt forward into shared
//     memory (each thread's own elements, laid out thread-fastest, so no
//     barrier and no bank conflict), dr taken on the way; then G walks
//     back through the chunk: dk, dw from the row sums, dv's column sum
//     over the warp's 8 rows by a reduce-scatter butterfly of shuffles
//     (16 values to 2 in three rounds), its 8 warps' partials added in
//     warp order after the chunk.  Tried and not kept: a 4-step chunk at
//     two CTAs an SM (slower), and 512 threads of 8 columns (a few per
//     cent faster, not worth a second layout).
// The chunk's r, k, v, w and do are staged in shared memory as float32,
// the next chunk's loaded into registers while this one runs; v . do and
// beta_t = sum_i r_t u k_t are one 64-term sum a step, taken for a
// chunk at once.  du is a per-(b, h) partial written by each CTA, added
// over b in order by a second kernel.  No atomics, every sum in one
// fixed order: the gradients are identical run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;         // rwkv_head_dim of the supported configs
constexpr int NT = 256;        // threads a (b, h): a (row, quarter) each
constexpr int QC = DH * DH / NT;  // state columns a thread: 16
constexpr int LPR = DH / QC;   // adjacent lanes holding one row: 4
constexpr int NW = NT / 32;    // warps
constexpr int T = 8;           // steps a chunk (and between checkpoints)
constexpr int NA = 5;          // staged arrays: r, k, v, w, do
constexpr int PER = T * DH / NT;  // a staged array's elements a thread
static_assert(QC == 16 && LPR == 4,
              "the row sums' two shuffles and dv's three-round butterfly");
static_assert(T * DH % NT == 0, "a chunk's rows split evenly");

enum { AR = 0, AK = 1, AV = 2, AW = 3, AG = 4 };

// shared memory, in floats: the chunk's rebuilt states, thread-fastest;
// the staged arrays; dv's per-warp partials; dr, dk, dw of the chunk;
// u; v . do and beta a step
constexpr int SM_STATES = T * DH * DH;
constexpr int SM_IN = NA * T * DH;
constexpr int SM_PART = T * NW * DH;
constexpr int SM_OUT = 3 * T * DH;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (SM_STATES + SM_IN + SM_PART + SM_OUT + DH + 2 * T);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// QC floats of a staged row from shared memory, as 16-byte loads
__device__ __forceinline__ void load_row(const float* p, float (&x)[QC]) {
#pragma unroll
  for (int e = 0; e < QC / 4; ++e) {
    const float4 f = reinterpret_cast<const float4*>(p)[e];
    x[4 * e] = f.x, x[4 * e + 1] = f.y, x[4 * e + 2] = f.z,
          x[4 * e + 3] = f.w;
  }
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename Tp>
__global__ void __launch_bounds__(NT, 1)
    wkv6_bwd_kernel(const Tp* __restrict__ r, const Tp* __restrict__ k,
                    const Tp* __restrict__ v, const Tp* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    const Tp* __restrict__ dout,
                    const float* __restrict__ ds_last, Tp* __restrict__ dr,
                    Tp* __restrict__ dk, Tp* __restrict__ dv,
                    Tp* __restrict__ dw, float* __restrict__ du_part,
                    float* __restrict__ ds0, float* __restrict__ ckpt, int S,
                    int H) {
  extern __shared__ __align__(16) float smem_wkvb[];
  float* states = smem_wkvb;
  float* in = states + SM_STATES;   // [NA][T][DH]
  float* part = in + SM_IN;         // [T][NW][DH]
  float* outs = part + SM_PART;     // [3][T][DH]: dr, dk, dw
  float* us = outs + SM_OUT;        // [DH]
  float* vdo = us + DH;             // [T]
  float* beta = vdo + T;            // [T]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int i = tid / LPR;          // state row
  const int q = tid % LPR;
  const int j0 = q * QC;            // first state column
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t step = (size_t)H * DH;  // one sequence position
  const size_t base = (size_t)b * S * step + (size_t)h * DH;
  const size_t state = ((size_t)b * H + h) * DH * DH;
  const int chunks = (S + T - 1) / T;
  float* cp = ckpt + ((size_t)b * H + h) * chunks * DH * DH;
  const Tp* src[NA] = {r, k, v, w, dout};

  for (int x = tid; x < DH; x += NT) us[x] = u[(size_t)h * DH + x];

  // a chunk's staged arrays: thread tid loads element tid + NT m of each
  // array's (T, DH) block (rows past S as zeros), into registers first
  float pre[NA][PER];
  auto fetch = [&](int c, int arrays) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int idx = tid + NT * m;
        const int ts = c * T + idx / DH;
        pre[a][m] = ((arrays >> a) & 1) && ts < S
                        ? to_f(src[a][base + (size_t)ts * step + idx % DH])
                        : 0.f;
      }
  };
  auto stage = [&](int arrays) {
#pragma unroll
    for (int a = 0; a < NA; ++a)
      if ((arrays >> a) & 1)
#pragma unroll
        for (int m = 0; m < PER; ++m)
          in[a * T * DH + tid + NT * m] = pre[a][m];
  };
  auto row = [&](int a, int tt) { return in + (a * T + tt) * DH; };
  // the 4 lanes of a row end with the same sum (commutative adds)
  auto row_sum = [&](float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    return x;
  };

  // 1. forward: the state before each chunk to the workspace
  float st[QC];
#pragma unroll
  for (int e = 0; e < QC; ++e) st[e] = s0[state + i * DH + j0 + e];
  constexpr int KVW = (1 << AK) | (1 << AV) | (1 << AW);
  fetch(0, KVW);
  stage(KVW);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) fetch(c + 1, KVW);
    float4* dst = reinterpret_cast<float4*>(cp + (size_t)c * DH * DH +
                                            i * DH + j0);
#pragma unroll
    for (int e = 0; e < QC / 4; ++e)
      dst[e] = make_float4(st[4 * e], st[4 * e + 1], st[4 * e + 2],
                           st[4 * e + 3]);
    const int n = min(T, S - c * T);
    for (int tt = 0; tt < n; ++tt) {
      const float ki = row(AK, tt)[i], wi = row(AW, tt)[i];
      float vt[QC];
      load_row(row(AV, tt) + j0, vt);
#pragma unroll
      for (int e = 0; e < QC; ++e) st[e] = fmaf(wi, st[e], ki * vt[e]);
    }
    __syncthreads();
    if (c + 1 < chunks) {
      stage(KVW);
      __syncthreads();
    }
  }

  // v_t . do_t and beta_t for a staged chunk: a warp a sum, lanes over
  // elements lane and lane + 32, joined by shuffles in a fixed order
  auto dots = [&]() {
    for (int p = warp; p < 2 * T; p += NW) {
      const int tt = p % T;
      float x;
      if (p < T) {
        x = row(AV, tt)[lane] * row(AG, tt)[lane] +
            row(AV, tt)[lane + 32] * row(AG, tt)[lane + 32];
      } else {
        x = row(AR, tt)[lane] * us[lane] * row(AK, tt)[lane] +
            row(AR, tt)[lane + 32] * us[lane + 32] * row(AK, tt)[lane + 32];
      }
#pragma unroll
      for (int off = 16; off >= 1; off /= 2)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) (p < T ? vdo : beta)[tt] = x;
    }
  };

  // 2. backward, chunk by chunk from the last
  constexpr int ALL = (1 << NA) - 1;
  float G[QC];
#pragma unroll
  for (int e = 0; e < QC; ++e)
    G[e] = ds_last != nullptr ? ds_last[state + i * DH + j0 + e] : 0.f;
  float du_acc = 0.f;
  fetch(chunks - 1, ALL);
  stage(ALL);
  __syncthreads();
  dots();
  __syncthreads();
  float cpre[QC];
#pragma unroll
  for (int e = 0; e < QC; ++e)
    cpre[e] = cp[(size_t)(chunks - 1) * DH * DH + i * DH + j0 + e];
  const float ui = us[i];
  for (int c = chunks - 1; c >= 0; --c) {
    const int n = min(T, S - c * T);
#pragma unroll
    for (int e = 0; e < QC; ++e) st[e] = cpre[e];
    if (c > 0) {
      fetch(c - 1, ALL);
#pragma unroll
      for (int e = 0; e < QC; ++e)
        cpre[e] = cp[(size_t)(c - 1) * DH * DH + i * DH + j0 + e];
    }
    // the chunk's states S_{t-1}, rebuilt forward; dr on the way
    for (int tt = 0; tt < n; ++tt) {
      float vt[QC], gt[QC];
      load_row(row(AV, tt) + j0, vt);
      load_row(row(AG, tt) + j0, gt);
      const float ki = row(AK, tt)[i], wi = row(AW, tt)[i];
      float x = 0.f;
#pragma unroll
      for (int e = 0; e < QC; ++e) {
        states[(tt * QC + e) * NT + tid] = st[e];
        x = fmaf(st[e], gt[e], x);
        st[e] = fmaf(wi, st[e], ki * vt[e]);
      }
      x = row_sum(x);
      if (q == 0) outs[tt * DH + i] = fmaf(ui * ki, vdo[tt], x);
    }
    // G back through the chunk: dk, dw, dv
    for (int tt = n - 1; tt >= 0; --tt) {
      float vt[QC], gt[QC];
      load_row(row(AV, tt) + j0, vt);
      load_row(row(AG, tt) + j0, gt);
      const float ki = row(AK, tt)[i], wi = row(AW, tt)[i];
      const float ri = row(AR, tt)[i];
      float xk = 0.f, xw = 0.f, pv[QC];
#pragma unroll
      for (int e = 0; e < QC; ++e) {
        const float sp = states[(tt * QC + e) * NT + tid];
        xk = fmaf(G[e], vt[e], xk);
        xw = fmaf(G[e], sp, xw);
        pv[e] = G[e] * ki;
        G[e] = fmaf(wi, G[e], ri * gt[e]);
      }
      xk = row_sum(xk);
      xw = row_sum(xw);
      if (q == 0) {
        outs[(T + tt) * DH + i] = fmaf(ui * ri, vdo[tt], xk);
        outs[(2 * T + tt) * DH + i] = xw;
        du_acc = fmaf(ri * ki, vdo[tt], du_acc);
      }
      // dv: the column sums over the warp's 8 rows (lane bits 2-4), a
      // reduce-scatter: each round keeps half the columns and adds the
      // partner's share of them; 2 columns a lane remain
      const bool h4 = (lane >> 4) & 1, h3 = (lane >> 3) & 1,
                 h2 = (lane >> 2) & 1;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float send = h4 ? pv[m] : pv[m + 8];
        const float keep = h4 ? pv[m + 8] : pv[m];
        pv[m] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float send = h3 ? pv[m] : pv[m + 4];
        const float keep = h3 ? pv[m + 4] : pv[m];
        pv[m] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float send = h2 ? pv[m] : pv[m + 2];
        const float keep = h2 ? pv[m + 2] : pv[m];
        pv[m] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
      }
      const int jj = j0 + 8 * h4 + 4 * h3 + 2 * h2;
      *reinterpret_cast<float2*>(part + (tt * NW + warp) * DH + jj) =
          make_float2(pv[0], pv[1]);
    }
    __syncthreads();
    // the chunk's gradients out: dr, dk, dw from their rows; dv as its
    // warps' partials in warp order plus beta_t do_t
    for (int idx = tid; idx < n * DH; idx += NT) {
      const int tt = idx / DH, col = idx % DH;
      const size_t o = base + (size_t)(c * T + tt) * step + col;
      put(dr + o, outs[tt * DH + col]);
      put(dk + o, outs[(T + tt) * DH + col]);
      put(dw + o, outs[(2 * T + tt) * DH + col]);
      float x = part[(tt * NW) * DH + col];
#pragma unroll
      for (int m = 1; m < NW; ++m) x += part[(tt * NW + m) * DH + col];
      put(dv + o, fmaf(beta[tt], row(AG, tt)[col], x));
    }
    __syncthreads();
    if (c > 0) {
      stage(ALL);
      __syncthreads();
      dots();
      __syncthreads();
    }
  }
#pragma unroll
  for (int e = 0; e < QC; ++e) ds0[state + i * DH + j0 + e] = G[e];
  if (q == 0) du_part[((size_t)b * H + h) * DH + i] = du_acc;
}

// du[h][i] = sum over b, in order, of the CTAs' partials
__global__ void wkv6_bwd_du(const float* __restrict__ du_part,
                            float* __restrict__ du, int B, int H) {
  const int h = blockIdx.x, i = threadIdx.x;
  float x = 0.f;
  for (int b = 0; b < B; ++b) x += du_part[((size_t)b * H + h) * DH + i];
  du[(size_t)h * DH + i] = x;
}

template <typename Tp>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, const void* dout,
           const void* ds_last, void* dr, void* dk, void* dv, void* dw,
           void* du, void* ds0, void* du_part, void* ckpt, int B, int S,
           int H, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<Tp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_kernel<Tp><<<dim3(H, B), NT, SMEM_BYTES, stream>>>(
      (const Tp*)r, (const Tp*)k, (const Tp*)v, (const Tp*)w,
      (const float*)u, (const float*)s0, (const Tp*)dout,
      (const float*)ds_last, (Tp*)dr, (Tp*)dk, (Tp*)dv, (Tp*)dw,
      (float*)du_part, (float*)ds0, (float*)ckpt, S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_du<<<H, DH, 0, stream>>>((const float*)du_part, (float*)du, B, H);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, do and dr, dk, dv, dw (B, S, H, dh) contiguous, all
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1); u, du (H, dh) float32;
// s0, ds0 (B, H, dh, dh) float32; ds_last the same or null (zeros);
// du_part a float32 workspace of B x H x dh, ckpt one of B x H x
// ceil(S / chunk) x dh x dh, chunk the kernel's (checked:
// kernels/wkv6.py: BWD_CHUNK).  dh must be 64, S at least 1.  Launches
// two kernels on `stream`; returns the first nonzero cudaGetLastError()
// (cudaErrorInvalidValue for another dh or chunk).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               const void* dout, const void* ds_last,
                               void* dr, void* dk, void* dv, void* dw,
                               void* du, void* ds0, void* du_part,
                               void* ckpt, int B, int S, int H, int dh,
                               int bf16, int chunk, void* stream) {
  if (dh != DH || chunk != T || S < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, dout, ds_last, dr, dk,
                                 dv, dw, du, ds0, du_part, ckpt, B, S, H, s);
  return launch<float>(r, k, v, w, u, s0, dout, ds_last, dr, dk, dv, dw, du,
                       ds0, du_part, ckpt, B, S, H, s);
}
