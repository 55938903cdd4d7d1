// RG-LRU linear-recurrence scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py (rglru_scan:
// _kernel), which every prefill of every RG-LRU layer of recurrentgemma
// reaches through ops.rglru.  Along the sequence axis of each (batch,
// channel) it computes
//
//     h_t = exp(log_a_t) * h_{t-1} + x_t,    h_{-1} = h0,
//
// with a float32 carry, and writes every h_t (in x's type) and the last
// carry h_last (float32, as the reference's off-TPU paths and its model
// state keep it).
//
// What bounds it on the H100: one read of x and log_a and one write of
// h; at the recurrentgemma-2b prefill (B = 4, S = 1024, D = 2560, bf16)
// that is 63 MB, 0.019 ms at 3.35 TB/s, against 3 operations per
// element: bytes.
//
// Design.  The TPU grid walks time blocks in order with the carry in
// VMEM scratch; here one thread owns one (b, d) channel and walks S in
// order, the carry in a register, so there is no state round trip and
// no second pass.  Threads are consecutive along d, so each step's loads
// and stores are coalesced; the loop is unrolled so the loads of
// several steps are in flight while the carry's chain of multiply-adds
// runs.  Any S and D: the last CTA masks channels past D (the
// reference's 256-multiple blocking is not carried over).  The multiply
// and the add are rounded separately (no contraction into an FMA), as
// the plain version computes them, and there are no atomics: the result
// is identical run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

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
__global__ void __launch_bounds__(THREADS)
    rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ log_a,
                      const float* __restrict__ h0, T* __restrict__ h,
                      float* __restrict__ h_last, int S, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t row = (size_t)b * D + d;
  const size_t base = (size_t)b * S * D + d;
  float carry = h0[row];
#pragma unroll 16
  for (int t = 0; t < S; ++t) {
    const size_t i = base + (size_t)t * D;
    carry = __fadd_rn(__fmul_rn(expf(to_f(log_a[i])), carry), to_f(x[i]));
    h[i] = from_f<T>(carry);
  }
  h_last[row] = carry;
}

template <typename T>
int launch(const void* x, const void* log_a, const void* h0, void* h,
           void* h_last, int B, int S, int D, cudaStream_t stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const T*)log_a, (const float*)h0, (T*)h, (float*)h_last,
      S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// x, log_a, h (B, S, D) contiguous, all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1); h0, h_last (B, D) float32.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int rglru_scan_launch(const void* x, const void* log_a,
                                 const void* h0, void* h, void* h_last,
                                 int B, int S, int D, int bf16,
                                 void* stream) {
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(x, log_a, h0, h, h_last, B, S, D, s);
  return launch<float>(x, log_a, h0, h, h_last, B, S, D, s);
}
