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
// (B 4, S 512, D 2560, bf16) 52 MB, 0.016 ms at 3.35 TB/s, against 7
// operations an element: bytes.  The carry's chain, one multiply and
// one add a step each way, is a few microseconds over 512 steps.  What
// the kernel has to supply is bytes in flight: one thread a channel
// gives only B D = 10,240 threads (320 one-warp CTAs, two or three an
// SM), so each of them must have several chunks of loads outstanding.
//
// Design.  One thread owns one (b, d) channel and walks it in the order
// of the plain version (kernels/ref.py: rglru_scan_backward_plain):
// every product and every sum rounded on its own (no contraction into
// an FMA), exp as expf, so dx, dlog_a and dh0 equal it bit for bit, and
// with no atomics the result is identical run to run.  Time is cut into
// chunks of CH steps, the box of K4's forward (64 bf16 or 32 float32
// steps of the CTA's 32 channels, 4 KB), and the float32 carry before
// each chunk is a checkpoint (B, ceil(S / CH), D) that K4 wrote in the
// forward (kernels/rglru_scan.py: RGLRUScan asks it to), so x, log_a and
// dh are read once, and no walk forward is made here.  The chunks are
// taken from the last: the chunk's carries h_{t-1} and a_t are rebuilt
// from its checkpoint into this thread's column of shared memory, and g
// is walked back through them.
//
// TMA stages time, as in K4: 3-d tensor maps over (B, S, D) cut boxes
// of CH steps x 32 channels, and one lane issues each chunk's loads of
// x, log_a and dh, last chunk first, into a ring of STAGES stages on
// mbarriers, so that STAGES chunks are in flight behind the one being
// walked.  dx and dlog_a go to shared memory and out by TMA stores,
// double-buffered.  The maps zero-fill channels and steps past the edge
// on load and clip them on store; the walks stop at S.  Where TMA
// refuses the layout (a row of D elements that is not a multiple of 16
// bytes, or a base that is not 16-byte aligned) the launcher takes the
// second path: the same walks with per-element loads and stores,
// coalesced across the warp.  The launcher is the one place that
// chooses.
#include "hopper.cuh"

namespace {

constexpr int TD = 32;           // channels a CTA: one warp, a thread each
constexpr int STAGES = 3;        // ring depth; a stage holds x, log_a, dh
constexpr int BOX_BYTES = 4096;  // one box: CH steps x TD channels

// The chunk: the steps of one box, K4's (csrc/rglru_scan.cu: Tile), so
// that K4's checkpoints are this kernel's; kernels/rglru_scan.py:
// CHECKPOINT_STEPS owns the value and both launchers check it
template <typename T>
struct Chunk {
  static constexpr int CH = BOX_BYTES / (TD * (int)sizeof(T));
  static constexpr int BOX = CH * TD;  // elements of a box
};

// Dynamic shared memory of the TMA path: the ring (x, log_a, dh a
// stage), two buffers of dx and dlog_a, a chunk's h_{t-1} and a_t in
// float32, the ring's barriers
template <typename T>
struct Smem {
  static constexpr size_t bytes =
      (size_t)BOX_BYTES * (3 * STAGES + 4) +
      2 * sizeof(float) * Chunk<T>::BOX + 8 * STAGES;
};

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

// One box of a 3-d tensor map, {c0, c1, c2} innermost first
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store3(const CUtensorMap* map,
                                           uint32_t src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's store groups still read shared memory
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's shared-memory accesses before the async proxy's
// (a TMA store that reads dx, a TMA load that refills a stage)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The walks over one chunk.  Every input is this thread's column of a
// staged box in shared memory, step tt at p[tt * TD]: x, log_a and dh,
// and the chunk's float32 h_{t-1} and a_t (hp, av).  With FULL false
// only the first n steps
// are walked (the chunk that ends at S).  Steps go in register blocks of
// K: block j + 1's loads (and expf) are issued before block j's chain
// and its stores, so they are in flight while the chain runs (a load
// issued after a store it might alias would wait for it).  A block's
// loads are unconditional: steps past n read step n - 1 and are dropped.
constexpr int K = 16;  // steps a register block

template <bool FULL>
__device__ __forceinline__ int at(int tt, int n) {
  return FULL ? tt : min(tt, n - 1);
}

// h_{t-1} and a_t of each step of the chunk into hp and av, from the
// carry before it
template <typename T, int CH, bool FULL>
__device__ __forceinline__ void rebuild(const T* xs, const T* as,
                                        float carry, float* hp, float* av,
                                        int n) {
  float a[K], x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a[k] = expf(to_f(as[at<FULL>(k, n) * TD]));
    x[k] = to_f(xs[at<FULL>(k, n) * TD]);
  }
#pragma unroll
  for (int j = 0; j < CH; j += K) {
    float an[K], xn[K];
    if (j + K < CH) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        an[k] = expf(to_f(as[at<FULL>(j + K + k, n) * TD]));
        xn[k] = to_f(xs[at<FULL>(j + K + k, n) * TD]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (FULL || j + k < n) {
        hp[(j + k) * TD] = carry;
        av[(j + k) * TD] = a[k];
        carry = __fadd_rn(__fmul_rn(a[k], carry), x[k]);
      }
    if (j + K < CH) {
#pragma unroll
      for (int k = 0; k < K; ++k) a[k] = an[k], x[k] = xn[k];
    }
  }
}

// g walked back over the chunk, blocks from the last: u is a_{t+1}
// g_{t+1} carried in from the chunk after (dh_last at S - 1, or -0,
// which adds nothing: x + -0 is x, bit for bit); g_t = dh_t + u.
// Returns a_c g_c of the chunk's first step c (dh0 after chunk 0).
template <typename T, int CH, bool FULL>
__device__ __forceinline__ float walk(const T* gs, T* dxs, T* das,
                                      int ostride, const float* hp,
                                      const float* av, float u, int n) {
  float g[K], a[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = at<FULL>(CH - K + k, n);
    g[k] = to_f(gs[i * TD]);
    a[k] = av[i * TD];
    h[k] = hp[i * TD];
  }
#pragma unroll
  for (int j = CH - K; j >= 0; j -= K) {
    float gn[K], an[K], hn[K];
    if (j > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = at<FULL>(j - K + k, n);
        gn[k] = to_f(gs[i * TD]);
        an[k] = av[i * TD];
        hn[k] = hp[i * TD];
      }
    }
#pragma unroll
    for (int k = K - 1; k >= 0; --k)
      if (FULL || j + k < n) {
        const float gt = __fadd_rn(g[k], u);
        dxs[(j + k) * ostride] = from_f<T>(gt);
        das[(j + k) * ostride] =
            from_f<T>(__fmul_rn(__fmul_rn(gt, a[k]), h[k]));
        u = __fmul_rn(a[k], gt);
      }
    if (j > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) g[k] = gn[k], a[k] = an[k], h[k] = hn[k];
    }
  }
  return u;
}

// Chunk c's x, log_a and dh boxes into one stage of the ring; the
// stage's barrier completes when all three have landed
template <typename T>
__device__ __forceinline__ void load_chunk(const CUtensorMap* tx,
                                           const CUtensorMap* ta,
                                           const CUtensorMap* tg, T* stage,
                                           uint64_t* full, int d0, int c,
                                           int b) {
  constexpr int CH = Chunk<T>::CH, BOX = Chunk<T>::BOX;
  const uint32_t bar = smem_u32(full);
  mbar_expect_tx(bar, 3 * BOX_BYTES);
  tma_load3(smem_u32(stage), tx, bar, d0, c * CH, b);
  tma_load3(smem_u32(stage + BOX), ta, bar, d0, c * CH, b);
  tma_load3(smem_u32(stage + 2 * BOX), tg, bar, d0, c * CH, b);
}

template <typename T>
__global__ void __launch_bounds__(TD)
    rglru_scan_bwd_tma(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tg,
                       const __grid_constant__ CUtensorMap tdx,
                       const __grid_constant__ CUtensorMap tda,
                       const float* __restrict__ ckpt,
                       const float* __restrict__ dh_last,
                       float* __restrict__ dh0, int S, int D) {
  constexpr int CH = Chunk<T>::CH, BOX = Chunk<T>::BOX;
  extern __shared__ __align__(128) unsigned char smem[];
  T* const ring = reinterpret_cast<T*>(smem);       // STAGES x {x, a, dh}
  T* const outs = ring + 3 * STAGES * BOX;          // 2 x {dx, dlog_a}
  float* const hp = reinterpret_cast<float*>(outs + 4 * BOX);
  float* const av = hp + BOX;
  uint64_t* const full = reinterpret_cast<uint64_t*>(av + BOX);
  const int lane = threadIdx.x;
  const int d0 = blockIdx.x * TD;
  const int b = blockIdx.y;
  const int d = d0 + lane;
  const bool live = d < D;
  const int chunks = (S + CH - 1) / CH;
  const float* const cp = ckpt + (size_t)b * chunks * D + d;

  // the r-th chunk walked is chunk chunks - 1 - r
  if (lane == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int r = 0; r < STAGES && r < chunks; ++r)
      load_chunk<T>(&tx, &ta, &tg, ring + 3 * r * BOX, &full[r], d0,
                    chunks - 1 - r, b);
  }
  __syncwarp();

  float u = live && dh_last != nullptr ? dh_last[(size_t)b * D + d] : -0.f;
  for (int r = 0; r < chunks; ++r) {
    const int s = r % STAGES;
    const int c = chunks - 1 - r;
    const int n = S - c * CH;
    const T* xs = ring + 3 * s * BOX + lane;
    T* const dxs = outs + 2 * (r & 1) * BOX;
    const float start = live ? cp[(size_t)c * D] : 0.f;
    mbar_wait(smem_u32(&full[s]), (r / STAGES) & 1);
    if (n >= CH)
      rebuild<T, CH, true>(xs, xs + BOX, start, hp + lane, av + lane, CH);
    else
      rebuild<T, CH, false>(xs, xs + BOX, start, hp + lane, av + lane, n);
    if (r >= 2) {
      // the stores of chunk r - 2 have read this buffer
      if (lane == 0) tma_store_wait_read<1>();
      __syncwarp();
    }
    u = n >= CH ? walk<T, CH, true>(xs + 2 * BOX, dxs + lane,
                                    dxs + BOX + lane, TD, hp + lane,
                                    av + lane, u, CH)
                : walk<T, CH, false>(xs + 2 * BOX, dxs + lane,
                                     dxs + BOX + lane, TD, hp + lane,
                                     av + lane, u, n);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      tma_store3(&tdx, smem_u32(dxs), d0, c * CH, b);
      tma_store3(&tda, smem_u32(dxs + BOX), d0, c * CH, b);
      tma_commit();
      if (r + STAGES < chunks)
        load_chunk<T>(&tx, &ta, &tg, ring + 3 * s * BOX, &full[s], d0,
                      c - STAGES, b);
    }
  }
  if (live) dh0[(size_t)b * D + d] = u;
  if (lane == 0) tma_store_wait_read<0>();
}

// The second path, for layouts TMA refuses: each chunk's x, log_a and
// dh staged into this thread's column of shared memory by per-element
// loads (consecutive threads on consecutive channels, coalesced), then
// the same walks, dx and dlog_a stored element by element
template <typename T>
__global__ void __launch_bounds__(TD)
    rglru_scan_bwd_direct(const T* __restrict__ x,
                          const T* __restrict__ log_a,
                          const float* __restrict__ ckpt,
                          const T* __restrict__ dh,
                          const float* __restrict__ dh_last,
                          T* __restrict__ dx, T* __restrict__ dla,
                          float* __restrict__ dh0, int S, int D) {
  constexpr int CH = Chunk<T>::CH, BOX = Chunk<T>::BOX;
  extern __shared__ float cols[];  // h_{t-1}, a_t; then x, log_a, dh
  const int lane = threadIdx.x;
  const int d = blockIdx.x * TD + lane;
  const int b = blockIdx.y;
  if (d >= D) return;
  const int chunks = (S + CH - 1) / CH;
  const size_t row = (size_t)b * D + d;
  const size_t base = (size_t)b * S * D + d;
  const float* const cp = ckpt + (size_t)b * chunks * D + d;
  float* const hp = cols + lane;
  float* const av = hp + BOX;
  T* const xs = reinterpret_cast<T*>(cols + 2 * BOX) + lane;
  T* const as = xs + BOX;
  T* const gs = as + BOX;
  float u = dh_last != nullptr ? dh_last[row] : -0.f;
  for (int c = chunks - 1; c >= 0; --c) {
    const size_t i = base + (size_t)c * CH * D;
    const int n = min(CH, S - c * CH);
    for (int tt = 0; tt < n; ++tt) {
      xs[tt * TD] = x[i + (size_t)tt * D];
      as[tt * TD] = log_a[i + (size_t)tt * D];
      gs[tt * TD] = dh[i + (size_t)tt * D];
    }
    const float start = cp[(size_t)c * D];
    if (n == CH) {
      rebuild<T, CH, true>(xs, as, start, hp, av, CH);
      u = walk<T, CH, true>(gs, dx + i, dla + i, D, hp, av, u, CH);
    } else {
      rebuild<T, CH, false>(xs, as, start, hp, av, n);
      u = walk<T, CH, false>(gs, dx + i, dla + i, D, hp, av, u, n);
    }
  }
  dh0[row] = u;
}

// The 3-d map {D, S, B} of a contiguous (B, S, D) tensor, boxes of
// {TD, CH, 1}: CH steps of 32 channels of one batch row, unswizzled.
// Channels and steps past the edge read as zeros and are not written.
template <typename T>
bool tensor_map3(CUtensorMap* map, const void* base, int B, int S, int D) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {sizeof(T) * (cuuint64_t)D,
                                 sizeof(T) * (cuuint64_t)D * S};
  const cuuint32_t box[3] = {(cuuint32_t)TD, (cuuint32_t)Chunk<T>::CH, 1};
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
int launch(const void* x, const void* log_a, const void* ckpt,
           const void* dh, const void* dh_last, void* dx, void* dla,
           void* dh0, int B, int S, int D, cudaStream_t stream) {
  const dim3 grid((D + TD - 1) / TD, B);
  const bool tma = (sizeof(T) * (size_t)D) % 16 == 0 && aligned16(x) &&
                   aligned16(log_a) && aligned16(dh) && aligned16(dx) &&
                   aligned16(dla);
  if (!tma) {
    rglru_scan_bwd_direct<T>
        <<<grid, TD, (2 * sizeof(float) + 3 * sizeof(T)) * Chunk<T>::BOX,
           stream>>>(
            (const T*)x, (const T*)log_a, (const float*)ckpt, (const T*)dh,
            (const float*)dh_last, (T*)dx, (T*)dla, (float*)dh0, S, D);
    return (int)cudaGetLastError();
  }
  bind_context();
  CUtensorMap tx, ta, tg, tdx, tda;
  if (!tensor_map3<T>(&tx, x, B, S, D) ||
      !tensor_map3<T>(&ta, log_a, B, S, D) ||
      !tensor_map3<T>(&tg, dh, B, S, D) ||
      !tensor_map3<T>(&tdx, dx, B, S, D) ||
      !tensor_map3<T>(&tda, dla, B, S, D))
    return (int)cudaErrorInvalidValue;
  // set on every call: threads that launch at once set the same value
  cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_bwd_tma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<T>::bytes);
  if (err != cudaSuccess) return (int)err;
  rglru_scan_bwd_tma<T><<<grid, TD, Smem<T>::bytes, stream>>>(
      tx, ta, tg, tdx, tda, (const float*)ckpt, (const float*)dh_last,
      (float*)dh0, S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// x, log_a, dh, dx, dla (B, S, D) contiguous, all float32 (bf16 = 0) or
// all bfloat16 (bf16 = 1); ckpt float32 (B, ceil(S / chunk), D), the
// carry before each chunk of `chunk` steps, as K4 writes it (the first
// is h0); dh_last (B, D) float32 or null (zeros); dh0 (B, D) float32.
// chunk is the caller's (kernels/rglru_scan.py: CHECKPOINT_STEPS owns
// it): 64 in bfloat16, 32 in float32, the only chunks built.  S >= 1.
// Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for another chunk or S, or a tensor map that
// cannot be made).
extern "C" int rglru_scan_bwd_launch(const void* x, const void* log_a,
                                     const void* ckpt, const void* dh,
                                     const void* dh_last, void* dx,
                                     void* dla, void* dh0, int B, int S,
                                     int D, int bf16, int chunk,
                                     void* stream) {
  const int built = bf16 ? Chunk<__nv_bfloat16>::CH : Chunk<float>::CH;
  if (chunk != built || S < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(x, log_a, ckpt, dh, dh_last, dx, dla, dh0,
                                 B, S, D, s);
  return launch<float>(x, log_a, ckpt, dh, dh_last, dx, dla, dh0, B, S, D,
                       s);
}
