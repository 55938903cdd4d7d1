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
// state keep it).  For training it can also write the float32 carry
// before each chunk of CH steps, the checkpoints its backward
// (csrc/rglru_scan_bwd.cu, N2a) walks back from.
//
// What bounds it on the H100: one read of x and log_a and one write of
// h; at the recurrentgemma-2b prefill (B = 4, S = 1024, D = 2560, bf16)
// that is 63 MB, 0.019 ms at 3.35 TB/s, against 3 operations per
// element: bytes.  The carry's own chain (one multiply, one add a step)
// is a few microseconds over 1024 steps, so what the kernel has to
// supply is bytes in flight on every SM.
//
// Design.  One thread still owns one (b, d) channel and walks S in
// order, the carry in a register: the multiply and the add are rounded
// separately (no contraction into an FMA), exp is expf, as the plain
// version computes them, so h and h_last equal it bit for bit, and with
// no atomics the result is identical run to run.  A CTA is one warp of
// 32 channels (320 CTAs at the prefill, every SM busy).  Time is staged
// by TMA: a 3-d tensor map over (B, S, D) cuts boxes of CH steps x 32
// channels of x and of log_a into a ring of STAGES stages on mbarriers
// (lane 0 issues the copies), and each chunk's h goes to shared memory
// and out by a TMA store, double-buffered.  The tensor map zero-fills
// channels and steps past the edge on load and clips them on store (a
// box never runs into the next batch row); the last chunk stops at S so
// the carry sees no padding.  Within a chunk the steps are unrolled, so
// the loads, converts and expf of later steps run ahead of the carry.
//
// Where TMA refuses the layout (a row of D elements that is not a
// multiple of 16 bytes, or a base that is not 16-byte aligned), the
// launcher takes the second path: the same walk with per-element loads
// and stores, coalesced across the warp.  The launcher is the one place
// that chooses.
#include <cuda.h>  // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TD = 32;         // channels a CTA: one warp, a thread each
constexpr int STAGES = 4;      // input ring depth
constexpr int BOX_BYTES = 4096;  // one box of x or log_a: CH x TD elements

template <typename T>
struct Tile {
  static constexpr int CH = BOX_BYTES / (TD * (int)sizeof(T));  // steps
};

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

// One step of the recurrence, rounded as the plain version rounds it:
// a = expf(log_a), then h = a * h rounded, + x rounded (no FMA)
__device__ __forceinline__ float step(float carry, float a, float x) {
  return __fadd_rn(__fmul_rn(a, carry), x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the barrier's phase of `parity` to complete.  A copy that
// never lands traps after 2^24 polls, so the launch fails with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-d tensor map, {c0, c1, c2} innermost first
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's stores still read shared memory
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's shared-memory accesses before the async proxy's
// (the TMA store that reads h, the TMA load that refills a stage)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Chunk c's x and log_a (CH steps of the CTA's 32 channels) into one
// stage of the ring; its barrier completes when both boxes have landed
template <typename T, int CH>
__device__ __forceinline__ void load_chunk(const CUtensorMap* tx,
                                           const CUtensorMap* ta, T* xs,
                                           T* as, uint64_t* full, int d0,
                                           int c, int b) {
  const uint32_t bar = smem_u32(full);
  mbar_expect_tx(bar, 2 * BOX_BYTES);
  tma_load(smem_u32(xs), tx, bar, d0, c * CH, b);
  tma_load(smem_u32(as), ta, bar, d0, c * CH, b);
}

// CH steps of one chunk from the staged x and log_a into the staged h;
// with FULL false, only the first n (the chunk that ends at S).  Steps
// go in blocks of K: block j + 1's loads, converts and expf are issued
// before block j's carry chain, so they run while the chain waits.
template <typename T, int CH, bool FULL>
__device__ __forceinline__ float scan_chunk(const T* __restrict__ xs,
                                            const T* __restrict__ as,
                                            T* __restrict__ hs, int lane,
                                            float carry, int n) {
  constexpr int K = 16;
  float a[K], x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a[k] = expf(to_f(as[k * TD + lane]));
    x[k] = to_f(xs[k * TD + lane]);
  }
#pragma unroll
  for (int j = 0; j < CH; j += K) {
    float an[K], xn[K];
    if (j + K < CH) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        an[k] = expf(to_f(as[(j + K + k) * TD + lane]));
        xn[k] = to_f(xs[(j + K + k) * TD + lane]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (FULL || j + k < n) {
        carry = step(carry, a[k], x[k]);
        hs[(j + k) * TD + lane] = from_f<T>(carry);
      }
    }
    if (j + K < CH) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a[k] = an[k];
        x[k] = xn[k];
      }
    }
  }
  return carry;
}

template <typename T>
__global__ void __launch_bounds__(TD)
    rglru_scan_tma(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap th,
                   const float* __restrict__ h0, float* __restrict__ h_last,
                   float* __restrict__ ckpt, int S, int D) {
  constexpr int CH = Tile<T>::CH;
  constexpr int BOX = CH * TD;  // elements
  // STAGES boxes of x, STAGES of log_a, two of h
  __shared__ __align__(128) unsigned char smem[(2 * STAGES + 2) * BOX_BYTES];
  __shared__ __align__(8) uint64_t full[STAGES];
  T* const sx = reinterpret_cast<T*>(smem);
  T* const sa = sx + STAGES * BOX;
  T* const sh = sa + STAGES * BOX;
  const int lane = threadIdx.x;
  const int d0 = blockIdx.x * TD;
  const int b = blockIdx.y;
  const int d = d0 + lane;
  const int chunks = (S + CH - 1) / CH;

  if (lane == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < STAGES && c < chunks; ++c)
      load_chunk<T, CH>(&tx, &ta, sx + c * BOX, sa + c * BOX, &full[c], d0,
                        c, b);
  }
  __syncwarp();

  float carry = d < D ? h0[(size_t)b * D + d] : 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % STAGES;
    const T* xs = sx + s * BOX;
    const T* as = sa + s * BOX;
    T* const hs = sh + (c & 1) * BOX;
    mbar_wait(smem_u32(&full[s]), (c / STAGES) & 1);
    if (c >= 2) {
      // the store of chunk c - 2 has read this h buffer
      if (lane == 0) tma_store_wait_read<1>();
      __syncwarp();
    }
    const int n = S - c * CH;
    if (ckpt != nullptr && d < D)
      ckpt[((size_t)b * chunks + c) * D + d] = carry;
    if (n >= CH)
      carry = scan_chunk<T, CH, true>(xs, as, hs, lane, carry, CH);
    else
      carry = scan_chunk<T, CH, false>(xs, as, hs, lane, carry, n);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      tma_store(&th, smem_u32(hs), d0, c * CH, b);
      if (c + STAGES < chunks)
        load_chunk<T, CH>(&tx, &ta, sx + s * BOX, sa + s * BOX, &full[s], d0,
                          c + STAGES, b);
    }
  }
  if (d < D) h_last[(size_t)b * D + d] = carry;
  if (lane == 0) tma_store_wait_read<0>();
}

// The second path, for layouts TMA refuses: per-element loads and
// stores, consecutive threads on consecutive channels (coalesced)
template <typename T>
__global__ void __launch_bounds__(TD)
    rglru_scan_direct(const T* __restrict__ x, const T* __restrict__ log_a,
                      const float* __restrict__ h0, T* __restrict__ h,
                      float* __restrict__ h_last, float* __restrict__ ckpt,
                      int S, int D) {
  constexpr int CH = Tile<T>::CH;
  const int d = blockIdx.x * TD + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t row = (size_t)b * D + d;
  const size_t base = (size_t)b * S * D + d;
  const int chunks = (S + CH - 1) / CH;
  float carry = h0[row];
  for (int c = 0; c < chunks; ++c) {
    if (ckpt != nullptr) ckpt[((size_t)b * chunks + c) * D + d] = carry;
    const int end = min(S, (c + 1) * CH);
#pragma unroll 16
    for (int t = c * CH; t < end; ++t) {
      const size_t i = base + (size_t)t * D;
      carry = step(carry, expf(to_f(log_a[i])), to_f(x[i]));
      h[i] = from_f<T>(carry);
    }
  }
  h_last[row] = carry;
}

// cuTensorMapEncodeTiled, a driver-API call, found through the runtime
// so that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// The 3-d map {D, S, B} of a contiguous (B, S, D) tensor, boxes of
// {TD, CH, 1}: CH steps of 32 channels of one batch row, unswizzled.
// Channels and steps past the edge read as zeros and are not written.
template <typename T>
bool tensor_map(CUtensorMap* map, const void* base, int B, int S, int D) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {sizeof(T) * (cuuint64_t)D,
                                 sizeof(T) * (cuuint64_t)D * S};
  const cuuint32_t box[3] = {(cuuint32_t)TD, (cuuint32_t)Tile<T>::CH, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
int launch(const void* x, const void* log_a, const void* h0, void* h,
           void* h_last, void* ckpt, int B, int S, int D,
           cudaStream_t stream) {
  const dim3 grid((D + TD - 1) / TD, B);
  const bool tma = S > 0 && (sizeof(T) * (size_t)D) % 16 == 0 &&
                   aligned16(x) &&
                   aligned16(log_a) && aligned16(h);
  if (!tma) {
    rglru_scan_direct<T><<<grid, TD, 0, stream>>>(
        (const T*)x, (const T*)log_a, (const float*)h0, (T*)h,
        (float*)h_last, (float*)ckpt, S, D);
    return (int)cudaGetLastError();
  }
  // the encode needs a current context: a thread that has made no CUDA
  // runtime call yet (autograd's, recomputing a checkpointed layer) has
  // none, and cudaSetDevice binds the device's primary one
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaSetDevice(dev);
  CUtensorMap tx, ta, th;
  if (!tensor_map<T>(&tx, x, B, S, D) || !tensor_map<T>(&ta, log_a, B, S, D)
      || !tensor_map<T>(&th, h, B, S, D))
    return (int)cudaErrorInvalidValue;
  rglru_scan_tma<T><<<grid, TD, 0, stream>>>(tx, ta, th, (const float*)h0,
                                             (float*)h_last, (float*)ckpt, S,
                                             D);
  return (int)cudaGetLastError();
}

}  // namespace

// x, log_a, h (B, S, D) contiguous, all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1); h0, h_last (B, D) float32; ckpt null, or float32
// (B, ceil(S / chunk), D) for the carry before each chunk of `chunk`
// steps (the backward's checkpoints; kernels/rglru_scan.py:
// CHECKPOINT_STEPS owns the chunk, and it must be this kernel's box: 64
// bfloat16 or 32 float32 steps).  Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for another chunk, or where
// a tensor map cannot be made).
extern "C" int rglru_scan_launch(const void* x, const void* log_a,
                                 const void* h0, void* h, void* h_last,
                                 void* ckpt, int B, int S, int D, int bf16,
                                 int chunk, void* stream) {
  const int built = bf16 ? Tile<__nv_bfloat16>::CH : Tile<float>::CH;
  if (chunk != built) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(x, log_a, h0, h, h_last, ckpt, B, S, D, s);
  return launch<float>(x, log_a, h0, h, h_last, ckpt, B, S, D, s);
}
