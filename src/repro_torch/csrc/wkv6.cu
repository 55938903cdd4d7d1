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
// as 2 per FMA): operations.
//
// Design.  The TPU grid walks time blocks in order with the state in
// VMEM scratch; here one CTA of dh = 64 threads owns one (b, h) and
// walks S in order, thread j holding column j of the state, S[:, j], as
// 64 float32 registers, so the state never leaves the SM.  At each step
// thread j loads element j of r_t, k_t, v_t and w_t (consecutive threads
// on consecutive addresses: coalesced, read straight from the model
// layout (B, S, H, dh) by stride; the reference's transpose is not
// made), stages r, k and w in shared memory (u once), and then reads
// them as broadcasts.  The loads of step t + 1 are issued before step t
// is computed, and the staging is double-buffered, so a step costs one
// barrier.  The output sum runs over i in a fixed order, in four
// interleaved partial sums joined in a fixed order, and there are no
// atomics: the result is identical run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int DH = 64;  // rwkv_head_dim of the supported configs

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(DH)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ o, float* __restrict__ s_last, int S,
                int H) {
  __shared__ __align__(16) float rs[2][DH];
  __shared__ __align__(16) float ks[2][DH];
  __shared__ __align__(16) float ws[2][DH];
  __shared__ __align__(16) float us[DH];
  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t step = (size_t)H * DH;  // one sequence position
  const size_t base = (size_t)b * S * step + (size_t)h * DH + j;
  const size_t state = ((size_t)b * H + h) * DH * DH + j;

  float st[DH];  // column j of the state
#pragma unroll
  for (int i = 0; i < DH; ++i) st[i] = s0[state + (size_t)i * DH];
  us[j] = u[(size_t)h * DH + j];

  float rn = 0.f, kn = 0.f, vn = 0.f, wn = 0.f;  // the next step's inputs
  if (S > 0) {
    rn = to_f(r[base]);
    kn = to_f(k[base]);
    vn = to_f(v[base]);
    wn = to_f(w[base]);
  }
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    rs[buf][j] = rn;
    ks[buf][j] = kn;
    ws[buf][j] = wn;
    const float vj = vn;
    // the last reads of this buffer (step t - 2) finished before every
    // thread passed step t - 1's barrier
    __syncthreads();
    if (t + 1 < S) {
      const size_t n = base + (size_t)(t + 1) * step;
      rn = to_f(r[n]);
      kn = to_f(k[n]);
      vn = to_f(v[n]);
      wn = to_f(w[n]);
    }
    const float4* r4 = reinterpret_cast<const float4*>(rs[buf]);
    const float4* k4 = reinterpret_cast<const float4*>(ks[buf]);
    const float4* w4 = reinterpret_cast<const float4*>(ws[buf]);
    const float4* u4 = reinterpret_cast<const float4*>(us);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < DH / 4; ++q) {
      const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = u4[q];
      const float ri[4] = {rq.x, rq.y, rq.z, rq.w};
      const float ki[4] = {kq.x, kq.y, kq.z, kq.w};
      const float wi[4] = {wq.x, wq.y, wq.z, wq.w};
      const float ui[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * q + e;
        const float kv = ki[e] * vj;
        acc[e] = fmaf(ri[e], fmaf(ui[e], kv, st[i]), acc[e]);
        st[i] = fmaf(wi[e], st[i], kv);
      }
    }
    o[base + (size_t)t * step] =
        from_f<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
  }
#pragma unroll
  for (int i = 0; i < DH; ++i) s_last[state + (size_t)i * DH] = st[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* o, void* s_last, int B,
           int S, int H, cudaStream_t stream) {
  const dim3 grid(H, B);
  wkv6_kernel<T><<<grid, DH, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (const float*)s0, (T*)o, (float*)s_last, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, o (B, S, H, dh) contiguous, all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1); u (H, dh) float32; s0, s_last (B, H, dh, dh)
// float32; dh must be 64.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* o, void* s_last, int B, int S, int H,
                           int dh, int bf16, void* stream) {
  if (dh != DH) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, o, s_last, B, S, H, s);
  return launch<float>(r, k, v, w, u, s0, o, s_last, B, S, H, s);
}
