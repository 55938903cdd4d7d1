// The backward pass of the RG-LRU scan (dx, dlog_a, dh0) for Hopper
// (sm_90a).
//
// No TPU kernel to replace: the reference has no backward Pallas kernel
// and trains recurrentgemma, off the TPU, through autodiff of its xla
// associative scan (src/repro/kernels/ops.py: rglru, impl "xla").  This
// is the gradient of the forward kernel csrc/rglru_scan.cu (which
// replaces src/repro/kernels/rglru_scan.py: rglru_scan), so the RG-LRU
// layers train on the card through hand-written kernels both ways.
// Per (batch, channel), with a_t = exp(log_a_t), the float32 carry
// h_t = a_t h_{t-1} + x_t (h_{-1} = h0), and the upstream gradients dh_t
// (of h, in x's type) and dh_last (of the last carry, float32):
//
//   g_{S-1} = dh_{S-1} + dh_last;   g_{t-1} = dh_{t-1} + a_t g_t
//   dx_t = g_t;   dlog_a_t = (g_t a_t) h_{t-1};   dh0 = a_0 g_0
//
// h_{t-1} is the float32 carry, not the h the forward returned in x's
// type: the reference differentiates through its float32 carry.
//
// What bounds it on the H100: reads of x, log_a and dh and writes of dx
// and dlog_a, five (B, S, D) tensors; at recurrentgemma-2b's train shape
// (B 4, S 512, D 2560, bf16) 52 MB, 0.016 ms at 3.35 TB/s, against 6
// operations an element: bytes.  The carry's chain, one multiply and
// one add a step each way, is a few microseconds over 512 steps.
//
// Design.  One thread owns one (b, d) channel and walks it twice: once
// forward, rebuilding the carry and writing it, every CH steps, to a
// float32 checkpoint workspace (B, ceil(S / CH), D) the wrapper
// allocates; then chunk by chunk in reverse, where it reloads the
// chunk's checkpoint, rebuilds the chunk's CH carries into registers
// and walks g back through them.  There are few threads (B D, 10,240 at
// the train shape, two or three warps an SM), so the walk is bound by
// load latency: a chunk's loads are unconditional (rows clamped into
// the sequence; steps past S are computed and dropped by a select) so
// that they issue together, and the next chunk's are issued before this
// chunk's chain runs (its x, log_a, dh and checkpoint in registers).  Every
// product and every sum is rounded on its own (no contraction into an
// FMA), exp is expf, as the plain version (kernels/ref.py:
// rglru_scan_backward_plain) computes them, so dx, dlog_a and dh0 equal
// it bit for bit; with no atomics the result is identical run to run.
// A CTA is one warp of 32 channels (320 CTAs at the train shape), the
// loads coalesced across the warp, as K4's per-element path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TD = 32;  // channels a CTA: one warp, a thread each
constexpr int CH = 16;  // steps a checkpoint covers (a chunk)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A chunk's raw inputs: CH steps of one or two (B, S, D) tensors at rows
// first .. first + CH - 1, clamped into [0, S) so that every load is
// unconditional (guarded loads would issue one by one) and the whole
// chunk's loads are in flight at once
template <typename T>
struct Chunk {
  T a[CH], b[CH];
  __device__ __forceinline__ void load(const T* pa, const T* pb,
                                       size_t base, int first, int S, int D) {
#pragma unroll
    for (int tt = 0; tt < CH; ++tt) {
      const size_t i = base + (size_t)min(max(first + tt, 0), S - 1) * D;
      a[tt] = pa[i];
      if (pb != nullptr) b[tt] = pb[i];
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(TD)
    rglru_scan_bwd(const T* __restrict__ x, const T* __restrict__ log_a,
                   const float* __restrict__ h0, const T* __restrict__ dh,
                   const float* __restrict__ dh_last, T* __restrict__ dx,
                   T* __restrict__ dla, float* __restrict__ dh0,
                   float* __restrict__ ckpt, int S, int D) {
  const int d = blockIdx.x * TD + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const int chunks = (S + CH - 1) / CH;
  const size_t row = (size_t)b * D + d;
  const size_t base = (size_t)b * S * D + d;
  float* cp = ckpt + (size_t)b * chunks * D + d;

  // forward: the carry before each chunk, to the workspace; chunk c + 1's
  // x and log_a are loaded while chunk c's chain runs
  float carry = h0[row];
  Chunk<T> next, cur;
  next.load(x, log_a, base, 0, S, D);
  for (int c = 0; c < chunks; ++c) {
    cur = next;
    if (c + 1 < chunks) next.load(x, log_a, base, (c + 1) * CH, S, D);
    cp[(size_t)c * D] = carry;
    const int n = min(CH, S - c * CH);
#pragma unroll
    for (int tt = 0; tt < CH; ++tt) {
      const float h = __fadd_rn(__fmul_rn(expf(to_f(cur.b[tt])), carry),
                                to_f(cur.a[tt]));
      carry = tt < n ? h : carry;
    }
  }

  // backward, chunk by chunk from the last; a chunk's dh rows are those
  // the walk adds after each step, t - 1 for t in the chunk
  float g = to_f(dh[base + (size_t)(S - 1) * D]);
  if (dh_last != nullptr) g = __fadd_rn(g, dh_last[row]);
  Chunk<T> in_next, g_next;
  in_next.load(x, log_a, base, (chunks - 1) * CH, S, D);
  g_next.load(dh, nullptr, base, (chunks - 1) * CH - 1, S, D);
  float cp_next = cp[(size_t)(chunks - 1) * D];
  for (int c = chunks - 1; c >= 0; --c) {
    const Chunk<T> in = in_next, gr = g_next;
    carry = cp_next;
    if (c > 0) {
      in_next.load(x, log_a, base, (c - 1) * CH, S, D);
      g_next.load(dh, nullptr, base, (c - 1) * CH - 1, S, D);
      cp_next = cp[(size_t)(c - 1) * D];
    }
    const int n = min(CH, S - c * CH);
    float a[CH], prev[CH];
#pragma unroll
    for (int tt = 0; tt < CH; ++tt) {
      a[tt] = expf(to_f(in.b[tt]));
      prev[tt] = carry;
      carry = __fadd_rn(__fmul_rn(a[tt], carry), to_f(in.a[tt]));
    }
#pragma unroll
    for (int tt = CH - 1; tt >= 0; --tt) {
      if (tt < n) {
        const int t = c * CH + tt;
        const size_t i = base + (size_t)t * D;
        dx[i] = from_f<T>(g);
        dla[i] = from_f<T>(__fmul_rn(__fmul_rn(g, a[tt]), prev[tt]));
        g = t > 0 ? __fadd_rn(to_f(gr.a[tt]), __fmul_rn(a[tt], g))
                  : __fmul_rn(a[tt], g);
      }
    }
  }
  dh0[row] = g;
}

template <typename T>
int launch(const void* x, const void* log_a, const void* h0, const void* dh,
           const void* dh_last, void* dx, void* dla, void* dh0, void* ckpt,
           int B, int S, int D, cudaStream_t stream) {
  const dim3 grid((D + TD - 1) / TD, B);
  rglru_scan_bwd<T><<<grid, TD, 0, stream>>>(
      (const T*)x, (const T*)log_a, (const float*)h0, (const T*)dh,
      (const float*)dh_last, (T*)dx, (T*)dla, (float*)dh0, (float*)ckpt, S,
      D);
  return (int)cudaGetLastError();
}

}  // namespace

// x, log_a, dh, dx, dla (B, S, D) contiguous, all float32 (bf16 = 0) or
// all bfloat16 (bf16 = 1); h0, dh0 (B, D) float32; dh_last (B, D)
// float32 or null (zeros); ckpt a float32 workspace of B x ceil(S / chunk)
// x D elements, chunk the kernel's (checked: kernels/rglru_scan.py:
// CHECKPOINT_STEPS).  S >= 1.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int rglru_scan_bwd_launch(const void* x, const void* log_a,
                                     const void* h0, const void* dh,
                                     const void* dh_last, void* dx,
                                     void* dla, void* dh0, void* ckpt, int B,
                                     int S, int D, int bf16, int chunk,
                                     void* stream) {
  if (chunk != CH || S < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(x, log_a, h0, dh, dh_last, dx, dla, dh0,
                                 ckpt, B, S, D, s);
  return launch<float>(x, log_a, h0, dh, dh_last, dx, dla, dh0, ckpt, B, S,
                       D, s);
}
