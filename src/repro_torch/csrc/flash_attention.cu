// Blocked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention: _kernel), which every prefill of every attention
// layer reaches through ops.attention.  For each query row it computes
// softmax(q k^T * dh^-0.5) v over the keys the row may see: causal mask,
// sliding window, tanh logit soft-cap, a scalar q_offset (absolute
// position of query row 0), and GQA (kv head = h / (H / KV)).  Like the
// TPU kernel it keeps the running max, the running denominator and the
// output accumulator in float32, and gives a row with no visible key an
// output of 0.
//
// Layout: the model's, q/o (B, Sq, H, dh) and k/v (B, Skv, KV, dh),
// contiguous; the kernel indexes heads by stride, so no transpose is
// made.  Inputs are float32 or bfloat16 (o has q's type); dh is 32, 64,
// 128 or 256 (recurrentgemma's local attention: 2560 / 10 heads).
//
// What bounds it on the H100: at the phi4-mini prefill (b = 8, S = 512,
// H = 24, KV = 8, dh = 128, bf16) the inputs and output are 67 MB, 0.020
// ms at 3.35 TB/s, and the causal products 12.9 GFLOP, 0.013 ms at the
// 989 TFLOP/s of the bf16 tensor cores: bytes, barely.  At long
// sequences (gemma2's 6144 positions, window 4096) the products bound
// it.
//
// Design.  One CTA per (64-row q tile, head, batch row); it loops over
// the 64-key tiles IN ORDER, which replaces the TPU grid's sequential kv
// axis that carried the scratch.  K and V tiles are staged in shared
// memory; every accumulator stays in registers.  Ragged edges are
// masked, not padded: query rows past Sq are loaded as zeros and never
// stored, keys past Skv are masked.  Key tiles wholly past the tile's
// causal horizon or wholly before its window are skipped: in the TPU
// kernel they add exactly nothing (alpha = 1, p = 0).  There are no
// atomics: every sum has one fixed order, so the output is identical
// run to run.  Two paths, by input type:
//
//  - bfloat16: the two products run on the tensor cores, mma.sync
//    m16n8k16 with float32 accumulation; 4 warps, each owns 16 query
//    rows.  Q's fragments are loaded once into registers (at dh = 256
//    they are reloaded from shared memory at each k-step, which keeps
//    the 128 O accumulators a thread holds there clear of spills; the
//    tile is then 104 KB of shared memory, 2 CTAs an SM); S's fragments
//    turn into P's A-fragments in registers (P rounded to bf16, as the
//    reference's xla path rounds p to v's type before P.V); V is stored
//    transposed so its B-fragments are single 32-bit loads.  Rows of
//    the staged tiles are padded by 8 elements, which makes every
//    fragment load free of bank conflicts.  wgmma and TMA come later.
//  - float32: FMAs on the CUDA cores (no tensor cores, no TF32), a
//    16 x 16 thread grid; thread (ty, tx) owns query rows ty + 16i,
//    score columns tx + 16j and output columns tx + 16c, the q tile is
//    pre-scaled in shared memory, and the score tile is written over the
//    K tile as P.  P stays float32, as in the TPU kernel.  At dh = 256
//    the tiles take 197 KB of shared memory, one CTA an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // keys per tile

// The key tiles [start, end) a q tile can see.
__device__ __forceinline__ void key_tiles(int q0, int Sq, int Skv,
                                          int q_offset, int causal,
                                          int window, int* start, int* end) {
  const int qlo = q_offset + q0;
  const int qhi = q_offset + min(q0 + BQ, Sq) - 1;
  *end = (Skv + BK - 1) / BK;
  if (causal) *end = min(*end, qhi < 0 ? 0 : qhi / BK + 1);
  *start = 0;
  if (window > 0 && qlo - window + 1 > 0) *start = (qlo - window + 1) / BK;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Skv,
                                        int causal, int window) {
  bool ok = kpos < Skv;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

__device__ __forceinline__ float lanes_max(float x, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float lanes_sum(float x, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

template <int DH>
struct SmemBF16 {
  static constexpr int LD = DH + 8;   // a Q or K row, padded
  static constexpr int VLD = BK + 8;  // a row of the transposed V tile
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * (BQ * LD + BK * LD + DH * VLD);
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A-fragment of k-step kk for rows row, row + 8 of a (rows, ld) tile
__device__ __forceinline__ void q_frag(const __nv_bfloat16* Qs, int ld,
                                       int row, int kk, int t,
                                       uint32_t (&a)[4]) {
  const __nv_bfloat16* p = Qs + row * ld + kk * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DH>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_attention_bf16(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int Sq, int Skv,
                         int H, int KV, float scale, int causal, int window,
                         float softcap, int q_offset) {
  using S = SmemBF16<DH>;
  constexpr int KS = DH / 16;  // k-steps of Q K^T
  constexpr int NT = BK / 8;   // 8-key n-tiles of S
  constexpr int DT = DH / 8;   // 8-wide n-tiles of O
  constexpr int CH = DH / 8;   // 16-byte chunks in a row
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* Ks = Qs + BQ * S::LD;
  __nv_bfloat16* Vt = Ks + BK * S::LD;  // (DH, BK): V transposed

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int r0 = (tid >> 5) * 16;         // the warp's first row in the tile

  const size_t q_step = (size_t)H * DH;
  const size_t kv_step = (size_t)KV * DH;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_step + (size_t)h * DH;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_step + (size_t)kvh * DH;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_step + (size_t)kvh * DH;
  __nv_bfloat16* ob = o + (size_t)b * Sq * q_step + (size_t)h * DH;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < BQ * CH; i += MMA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    const int s = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * S::LD + c) =
        s < Sq ? *reinterpret_cast<const uint4*>(qb + (size_t)s * q_step + c)
               : zero;
  }
  __syncthreads();
  // A-fragments of the warp's 16 q rows: held in registers for the whole
  // CTA up to DH = 128; at DH = 256 they would take 64 registers beside
  // 128 O accumulators, so they are reloaded from Qs at each k-step.
  constexpr bool QREG = DH <= 128;
  uint32_t qf[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) q_frag(Qs, S::LD, r0 + g, kk, t, qf[kk]);
  }

  // rows r0 + g (half 0: accumulator slots 0, 1) and r0 + g + 8 (half
  // 1: slots 2, 3)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  int kt_start, kt_end;
  key_tiles(q0, Sq, Skv, q_offset, causal, window, &kt_start, &kt_end);
  for (int kt = kt_start; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the last tile's K and V
    for (int i = tid; i < BK * CH; i += MMA_THREADS) {
      const int r = i / CH, c = (i % CH) * 8;  // consecutive threads: a row
      const int s = k0 + r;
      *reinterpret_cast<uint4*>(Ks + r * S::LD + c) =
          s < Skv
              ? *reinterpret_cast<const uint4*>(kb + (size_t)s * kv_step + c)
              : zero;
    }
    for (int i = tid; i < BK * CH; i += MMA_THREADS) {
      const int r = i % BK, c = (i / BK) * 8;  // consecutive threads: keys
      const int s = k0 + r;
      const uint4 x = s < Skv ? *reinterpret_cast<const uint4*>(
                                    vb + (size_t)s * kv_step + c)
                              : zero;
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};  // dims c .. c + 7
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Vt[(c + 2 * e) * S::VLD + r] =
            __ushort_as_bfloat16((unsigned short)(w[e] & 0xffffu));
        Vt[(c + 2 * e + 1) * S::VLD + r] =
            __ushort_as_bfloat16((unsigned short)(w[e] >> 16));
      }
    }
    __syncthreads();

    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        q_frag(Qs, S::LD, r0 + g, kk, t, qa);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* p = Ks + (8 * j + g) * S::LD + kk * 16 + 2 * t;
        mma_bf16(sc[j], qa, ld32(p), ld32(p + 8));
      }
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qpos = q_offset + q0 + r0 + g + 8 * half;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = sc[j][2 * half + e] * scale;
          if (softcap > 0.f) s = softcap * tanhf(s / softcap);
          const int kpos = k0 + 8 * j + 2 * t + e;
          s = visible(qpos, kpos, Skv, causal, window) ? s : NEG_INF;
          sc[j][2 * half + e] = s;
          mx = fmaxf(mx, s);
        }
      mx = lanes_max(mx, 4);  // the quad that shares the row
      const float m_new = fmaxf(m[half], mx);
      const float alpha = expf(m[half] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + 2 * t + e;
          const float p = visible(qpos, kpos, Skv, causal, window)
                              ? expf(sc[j][2 * half + e] - m_new)
                              : 0.f;
          sc[j][2 * half + e] = p;
          rs += p;
        }
      rs = lanes_sum(rs, 4);
      l[half] = l[half] * alpha + rs;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][2 * half] *= alpha;
        acc[d][2 * half + 1] *= alpha;
      }
      m[half] = m_new;
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // S's accumulators of n-tiles 2kk and 2kk+1 are P's A-fragment
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const __nv_bfloat16* p = Vt + (8 * d + g) * S::VLD + kk * 16 + 2 * t;
        mma_bf16(acc[d], pa, ld32(p), ld32(p + 8));
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = q0 + r0 + g + 8 * half;
    if (s < Sq) {
      const float li = l[half] == 0.f ? 1.f : l[half];
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)s * q_step + 8 * d +
                                           2 * t) =
            __floats2bfloat162_rn(acc[d][2 * half] / li,
                                  acc[d][2 * half + 1] / li);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int FMA_THREADS = 256;  // a 16 x 16 thread grid
constexpr int RQ = BQ / 16;       // query rows per thread
constexpr int CK = BK / 16;       // score columns per thread

template <int DH>
struct SmemF32 {
  static constexpr int LD = DH + 1;   // padded row: conflict-free K reads
  static constexpr int PLD = BK + 1;  // padded row of the P tile
  static constexpr int Q = BQ * LD;
  static constexpr int KP = BK * LD > BQ * PLD ? BK * LD : BQ * PLD;
  static constexpr int V = BK * DH;
  static constexpr size_t bytes = sizeof(float) * (Q + KP + V);
};

template <int DH>
__global__ void __launch_bounds__(FMA_THREADS)
    flash_attention_f32(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        int Sq, int Skv, int H, int KV, float scale,
                        int causal, int window, float softcap, int q_offset) {
  using S = SmemF32<DH>;
  constexpr int CD = DH / 16;  // output columns per thread
  extern __shared__ float smem_f32[];
  float* Qs = smem_f32;
  float* Ks = Qs + S::Q;  // the K tile, then the P tile
  float* Vs = Ks + S::KP;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  const size_t q_step = (size_t)H * DH;    // one sequence position of q, o
  const size_t kv_step = (size_t)KV * DH;  // one sequence position of k, v
  const float* qb = q + (size_t)b * Sq * q_step + (size_t)h * DH;
  const float* kb = k + (size_t)b * Skv * kv_step + (size_t)kvh * DH;
  const float* vb = v + (size_t)b * Skv * kv_step + (size_t)kvh * DH;
  float* ob = o + (size_t)b * Sq * q_step + (size_t)h * DH;

  for (int i = tid; i < BQ * DH; i += FMA_THREADS) {
    const int r = i / DH, d = i % DH;
    const int s = q0 + r;
    Qs[r * S::LD + d] = s < Sq ? qb[(size_t)s * q_step + d] * scale : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  int kt_start, kt_end;
  key_tiles(q0, Sq, Skv, q_offset, causal, window, &kt_start, &kt_end);
  for (int kt = kt_start; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q is staged; the last tile's P and V reads are done
    for (int i = tid; i < BK * DH; i += FMA_THREADS) {
      const int r = i / DH, d = i % DH;
      const int s = k0 + r;
      const bool in = s < Skv;
      Ks[r * S::LD + d] = in ? kb[(size_t)s * kv_step + d] : 0.f;
      Vs[r * DH + d] = in ? vb[(size_t)s * kv_step + d] : 0.f;
    }
    __syncthreads();

    float sc[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[RQ], bk[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qs[(ty + 16 * i) * S::LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) bk[j] = Ks[(tx + 16 * j) * S::LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

    float p[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      bool ok[CK];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        float s = sc[i][j];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        ok[j] = visible(qpos, k0 + tx + 16 * j, Skv, causal, window);
        sc[i][j] = ok[j] ? s : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = lanes_max(mx, 16);  // the half-warp that shares the row
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        p[i][j] = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += p[i][j];
      }
      rs = lanes_sum(rs, 16);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }

    __syncthreads();  // every score is read from Ks before P replaces it
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j)
        Ps[(ty + 16 * i) * S::PLD + tx + 16 * j] = p[i][j];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ], vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + 16 * i) * S::PLD + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[kk * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s < Sq) {
      const float li = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int c = 0; c < CD; ++c)
        ob[(size_t)s * q_step + tx + 16 * c] = acc[i][c] / li;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
template <typename T, typename Kernel>
int launch(Kernel kern, int threads, size_t smem, const void* q,
           const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int H, int KV, float scale, int causal, int window, float softcap,
           int q_offset, cudaStream_t stream) {
  // above 48 KB of shared memory only after opting in (per device)
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, threads, smem, stream>>>((const T*)q, (const T*)k,
                                        (const T*)v, (T*)o, Sq, Skv, H, KV,
                                        scale, causal, window, softcap,
                                        q_offset);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dh(int bf16, const void* q, const void* k, const void* v,
              void* o, int B, int Sq, int Skv, int H, int KV, float scale,
              int causal, int window, float softcap, int q_offset,
              cudaStream_t s) {
  if (bf16)
    return launch<__nv_bfloat16>(flash_attention_bf16<DH>, MMA_THREADS,
                                 SmemBF16<DH>::bytes, q, k, v, o, B, Sq, Skv,
                                 H, KV, scale, causal, window, softcap,
                                 q_offset, s);
  return launch<float>(flash_attention_f32<DH>, FMA_THREADS,
                       SmemF32<DH>::bytes, q, k, v, o, B, Sq, Skv, H, KV,
                       scale, causal, window, softcap, q_offset, s);
}

}  // namespace

// q, o (B, Sq, H, dh); k, v (B, Skv, KV, dh); contiguous, all float32
// (bf16 = 0) or all bfloat16 (bf16 = 1, 16-byte aligned).  scale is
// dh^-0.5 rounded to float32.  Launches on `stream`; returns
// cudaGetLastError() (or the error of the shared-memory opt-in).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int dh,
                                      int bf16, int causal, int window,
                                      float softcap, float scale,
                                      int q_offset, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 32:
      return launch_dh<32>(bf16, q, k, v, o, B, Sq, Skv, H, KV, scale,
                           causal, window, softcap, q_offset, s);
    case 64:
      return launch_dh<64>(bf16, q, k, v, o, B, Sq, Skv, H, KV, scale,
                           causal, window, softcap, q_offset, s);
    case 128:
      return launch_dh<128>(bf16, q, k, v, o, B, Sq, Skv, H, KV, scale,
                            causal, window, softcap, q_offset, s);
    case 256:
      return launch_dh<256>(bf16, q, k, v, o, B, Sq, Skv, H, KV, scale,
                            causal, window, softcap, q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
