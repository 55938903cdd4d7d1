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
// same step.  Walked step by step, one CTA a (b, h), the 64 x 64 state
// work of every step sits on the CUDA cores behind shared-memory and
// shuffle latency, with 256 CTAs for 132 SMs.
//
// Design: the chunked form (kernels/ref.py: wkv6_backward_chunked_plain
// states the algebra, and the CPU tests hold it to the step-by-step
// gradients).  Steps are cut into chunks of C (the wrapper's BWD_CHUNK,
// passed in; the last chunk padded with steps of decay 1 and zero r, k,
// v, do).  Within a chunk, per key channel i, p[t] = prod_{m<t} w_m,
// q[t] = prod_{m>t} w_m and D[a, b] = prod_{a<m<b} w_m are running
// products: no decay is ever divided by (a bf16 decay can round to 0).
// Three launches:
//  1. wkv6_bwd_chains: two sequential chains a (b, h), one CTA each.
//     The state chain writes S_c, the state before chunk c, and steps
//     S_{c+1} = diag(prod w) S_c + (k q)^T v; the gradient chain writes
//     G_c, the state gradient at chunk c's end, and steps G_{c-1} =
//     diag(prod w) G_c + (r p)^T do, ending with ds0.  Each CTA keeps
//     its 64 x 64 float32 state in mma.sync accumulators (4 warps of 16
//     rows) and adds the chunk's (64 x C)(C x 64) product on the tensor
//     cores; the next chunk's inputs are loaded while this one runs.
//  2. wkv6_bwd_chunk: a CTA a (b, h, chunk), all independent, in three
//     phases: M[t,s] = sum_i D[t,s] k_t r_s and beta_t = sum_i r_t u k_t
//     as partials a group of 8 channels (a running product a channel),
//     k q, and c0 = rowsum(G_c * S_c), then M's partials summed in group
//     order; then on the tensor cores X1 = do S_c^T, X2 = v G_c^T, A = do
//     v^T, and dv whole:
//       dv_t = ((k q) G_c)_t + sum_{s>t} M[t,s] do_s + beta_t do_t
//     then a thread a channel for each of dw, dr, dk and du's partial,
//     the intra-chunk C x C terms by Horner's rule in float32 (a running
//     product a term, multiplications only):
//       dr_t = p_t X1_t + sum_{s<t} D[s,t] k_s A[t,s] + u k_t A[t,t]
//       dk_t = q_t X2_t + sum_{s>t} D[t,s] r_s A[s,t] + u r_t A[t,t]
//       dw_t = q_t p_t c0 + q_t sum_{s<t} D[s,t] k_s X2_s
//              + p_t sum_{s>t} D[t,s] r_s X1_s
//              + sum_{s'<t<s} D[s',t] D[t,s] r_s k_s' A[s,s']
//     The last term's decay is the product over the pair's interval with
//     step t left out, taken as the prefix D[s',t] times the suffix
//     D[t,s] by two nested Horner walks.
//  3. wkv6_bwd_du: du, the partials summed over b and chunks in order.
// No atomics and every sum in one fixed order: the gradients are
// identical run to run.
//
// Tensor cores in TF32 (bfloat16 inputs): the products' float32
// operands S_c, G_c, M and the decayed k q, r p keep 10 mantissa bits
// (cvt.rna),
// bf16 r, k, v, do are exact in TF32, and every product accumulates in
// float32.  That is 2^-11 relative a term, against the bf16 gradients'
// own rounding of 2^-8 and the 2e-2 of the largest |gradient| they are
// held to.  float32 inputs (the card-vs-CPU parity smokes, held to 1e-5,
// which TF32 cannot meet) run the same kernels with every product as
// float32 FMAs in k order.
//
// What bounds it on the H100: at rwkv6-7b's train shape (B 4, S 512,
// H 64, dh 64, bf16) the inputs r, k, v, w, do and the outputs dr, dk,
// dv, dw are 151 MB, s0, ds_last and ds0 13 MB (0.049 ms at 3.35
// TB/s).  As built the chains read k, v, w and r, w, do once more, and
// the checkpoints S_c and G_c, (B, H, S / C, 64, 64) float32 each (134
// MB at C 16), are written once and read once; the products are 10 dh^2
// FLOPs a step (two chains, X1, X2, (k q) G_c), 5.4 GFLOP, 0.011 ms at
// 495 TFLOP/s in TF32.  So the checkpoints' bytes bound it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // tf32, mma_tf32

namespace {

constexpr int DH = 64;          // rwkv_head_dim of the supported configs
constexpr int CHAIN_NT = 128;   // a chain's CTA: 4 warps of 16 state rows
constexpr int NT = 256;         // a chunk's CTA: 8 warps
constexpr int LDC = DH + 8;     // chain staging row: (t LDC + g) reads
                                // hit 32 banks
constexpr int LD = DH + 4;      // a chunk's float32 rows, padded (rows
                                // stay 16-byte aligned)
constexpr int NA = 5;           // staged arrays: r, k, v, w, do

enum { AR = 0, AK = 1, AV = 2, AW = 3, AG = 4 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16-byte vectors of a (B, S, H, DH) array: VEC elements, VPR a row
template <typename Tp>
struct Vec {
  static constexpr int N = 16 / sizeof(Tp);
  static constexpr int VPR = DH / N;
};

// Vector `idx` of chunk c's (C, DH) block of one array; past S zeros,
// or ones (a decay of 1)
template <typename Tp, int C>
__device__ __forceinline__ uint4 fetch_vec(const Tp* src, size_t base,
                                           size_t step, int c, int idx,
                                           int S, bool one) {
  const int tau = idx / Vec<Tp>::VPR;
  const int col = (idx % Vec<Tp>::VPR) * Vec<Tp>::N;
  const int ts = c * C + tau;
  if (ts < S)
    return *reinterpret_cast<const uint4*>(src + base + (size_t)ts * step +
                                           col);
  const uint32_t x = !one ? 0u : sizeof(Tp) == 2 ? 0x3f803f80u : 0x3f800000u;
  return make_uint4(x, x, x, x);
}

// A vector's elements as float32 into shared memory (16-byte aligned)
template <typename Tp>
__device__ __forceinline__ void unpack(float* dst, uint4 x) {
  if constexpr (sizeof(Tp) == 4) {
    *reinterpret_cast<uint4*>(dst) = x;
  } else {
    const uint32_t u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // bf16 pairs, the lower element low
      dst[2 * e] = __uint_as_float(u[e] << 16);
      dst[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  }
}

// x as the tensor cores' TF32 operand (rounded once) where TC
template <bool TC>
__device__ __forceinline__ float round1(float x) {
  if constexpr (TC) return __uint_as_float(tf32(x));
  return x;
}
template <bool TC>
__device__ __forceinline__ float4 round4(float4 x) {
  return make_float4(round1<TC>(x.x), round1<TC>(x.y), round1<TC>(x.z),
                     round1<TC>(x.w));
}

// 4 consecutive elements as float32: one 16-byte load of float, 8 of bf16
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(x.x << 16),
                     __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16),
                     __uint_as_float(x.y & 0xffff0000u));
}

// 8 consecutive elements as float32: one 16-byte load of bf16, two of
// float
__device__ __forceinline__ void ld8(const float* p, float (&x)[8]) {
  const float4 a = ld4(p), b = ld4(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[2 * e] = __uint_as_float(u[e] << 16);
    x[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// acc (one 16 x 8 tile in the accumulator layout) += sum over k < K (a
// multiple of 16) of A(m, k) B(k, n); A4(m, k) gives A(m, k .. k + 3) and
// B4(k, n) gives B(k .. k + 3, n).  TC: thread t's k-slots t and t + 4 of
// two mma k-steps take its own four k, k0 + 4t .. k0 + 4t + 3, in order,
// for A and B alike (the same sum), so a row contiguous in k is one
// vector load; the operands are TF32 already (bf16 values, or rounded
// once).  Else float32 FMAs in k order.
template <bool TC, int K, typename FA, typename FB>
__device__ __forceinline__ void tile_mma(float (&acc)[4], FA A4, FB B4,
                                         int g, int t) {
  if constexpr (TC) {
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      const float4 a = A4(g, k0 + 4 * t), a8 = A4(g + 8, k0 + 4 * t);
      const float4 b = B4(k0 + 4 * t, g);
      const uint32_t s0[4] = {__float_as_uint(a.x), __float_as_uint(a8.x),
                              __float_as_uint(a.y), __float_as_uint(a8.y)};
      mma_tf32(acc, s0, __float_as_uint(b.x), __float_as_uint(b.y));
      const uint32_t s1[4] = {__float_as_uint(a.z), __float_as_uint(a8.z),
                              __float_as_uint(a.w), __float_as_uint(a8.w)};
      mma_tf32(acc, s1, __float_as_uint(b.z), __float_as_uint(b.w));
    }
  } else {
#pragma unroll 4
    for (int kk = 0; kk < K; kk += 4) {
      const float4 a = A4(g, kk), a8 = A4(g + 8, kk);
      const float4 b0 = B4(kk, 2 * t), b1 = B4(kk, 2 * t + 1);
      acc[0] = dot4(a, b0, acc[0]);
      acc[1] = dot4(a, b1, acc[1]);
      acc[2] = dot4(a8, b0, acc[2]);
      acc[3] = dot4(a8, b1, acc[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. The chains: blockIdx.x = 2 (b H + h) + dir; dir 0 the states forward
//    (k, v, w; S_c to ck_s), dir 1 the gradients backward (r, do, w; G_c
//    to ck_g, then ds0)
// ---------------------------------------------------------------------------
template <typename Tp, int C, bool TC>
__global__ void __launch_bounds__(CHAIN_NT)
    wkv6_bwd_chains(const Tp* __restrict__ r, const Tp* __restrict__ k,
                    const Tp* __restrict__ v, const Tp* __restrict__ w,
                    const Tp* __restrict__ dout,
                    const float* __restrict__ s0,
                    const float* __restrict__ ds_last,
                    float* __restrict__ ck_s, float* __restrict__ ck_g,
                    float* __restrict__ ds0, int S, int H, int NC) {
  __shared__ __align__(16) float xs[C * LDC];  // k q (or r p)
  __shared__ __align__(16) float ys[C * LDC];  // v (or do)
  __shared__ __align__(16) float ws[C * LDC];
  __shared__ float decay[DH];                  // the chunk's prod w
  const int dir = blockIdx.x & 1;
  const int bh = blockIdx.x >> 1;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t step = (size_t)H * DH;
  const size_t base = (size_t)b * S * step + (size_t)h * DH;
  const size_t state = (size_t)bh * DH * DH;
  const Tp* xsrc = dir ? r : k;
  const Tp* ysrc = dir ? dout : v;
  float* ck = (dir ? ck_g : ck_s) + (size_t)bh * NC * DH * DH;

  // the state's rows 16 warp + g (+ 8), columns 8 n + 2 t (+ 1)
  float acc[8][4];
  const float* init = dir ? ds_last : s0;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + g + 8 * (e >> 1);
      const int col = 8 * n + 2 * t + (e & 1);
      acc[n][e] = init != nullptr ? init[state + row * DH + col] : 0.f;
    }

  constexpr int NV = C * Vec<Tp>::VPR;               // vectors an array
  constexpr int PV = (NV + CHAIN_NT - 1) / CHAIN_NT;
  uint4 px[PV], py[PV], pw[PV];
  auto fetch = [&](int c) {
#pragma unroll
    for (int m = 0; m < PV; ++m) {
      const int idx = tid + m * CHAIN_NT;
      if (idx < NV) {
        px[m] = fetch_vec<Tp, C>(xsrc, base, step, c, idx, S, false);
        py[m] = fetch_vec<Tp, C>(ysrc, base, step, c, idx, S, false);
        pw[m] = fetch_vec<Tp, C>(w, base, step, c, idx, S, true);
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int m = 0; m < PV; ++m) {
      const int idx = tid + m * CHAIN_NT;
      if (idx < NV) {
        const int off = (idx / Vec<Tp>::VPR) * LDC +
                        (idx % Vec<Tp>::VPR) * Vec<Tp>::N;
        unpack<Tp>(xs + off, px[m]);
        unpack<Tp>(ys + off, py[m]);
        unpack<Tp>(ws + off, pw[m]);
      }
    }
  };

  int c = dir ? NC - 1 : 0;
  fetch(c);
  for (int it = 0; it < NC; ++it, c += dir ? -1 : 1) {
    stage();
    __syncthreads();
    if (it + 1 < NC) fetch(dir ? c - 1 : c + 1);  // in flight meanwhile
    // the decay products, a thread a channel: k times its suffix
    // products (states) or r times its prefix products (gradients)
    if (tid < DH) {
      float run = 1.f;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int tau = dir ? j : C - 1 - j;
        xs[tau * LDC + tid] *= run;
        run *= ws[tau * LDC + tid];
      }
      decay[tid] = run;
    }
    // the state before chunk c (or the gradient at its end) out
    float* dst = ck + (size_t)c * DH * DH;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 16 * warp + g + 8 * hf;
        *reinterpret_cast<float2*>(dst + row * DH + 8 * n + 2 * t) =
            make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
      }
    __syncthreads();
    if (dir == 0 && it == NC - 1) break;  // the last state is not needed
    const float d0 = decay[16 * warp + g], d1 = decay[16 * warp + g + 8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= d0;
      acc[n][1] *= d0;
      acc[n][2] *= d1;
      acc[n][3] *= d1;
    }
    // acc += xs^T ys: A(row, tau) = xs[tau][row], B(tau, col) =
    // ys[tau][col], a k-step's A fragment shared by the 8 n-tiles
    if constexpr (TC) {
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 8) {
        const float* xa = xs + (k0 + t) * LDC + 16 * warp + g;
        const uint32_t a[4] = {tf32(xa[0]), tf32(xa[8]), tf32(xa[4 * LDC]),
                               tf32(xa[4 * LDC + 8])};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float* yb = ys + (k0 + t) * LDC + 8 * n + g;
          mma_tf32(acc[n], a, tf32(yb[0]), tf32(yb[4 * LDC]));
        }
      }
    } else {
#pragma unroll 2
      for (int kk = 0; kk < C; ++kk) {
        const float x0 = xs[kk * LDC + 16 * warp + g];
        const float x1 = xs[kk * LDC + 16 * warp + g + 8];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float y0 = ys[kk * LDC + 8 * n + 2 * t];
          const float y1 = ys[kk * LDC + 8 * n + 2 * t + 1];
          acc[n][0] = fmaf(x0, y0, acc[n][0]);
          acc[n][1] = fmaf(x0, y1, acc[n][1]);
          acc[n][2] = fmaf(x1, y0, acc[n][2]);
          acc[n][3] = fmaf(x1, y1, acc[n][3]);
        }
      }
    }
    __syncthreads();  // xs, ys read before the next chunk lands
  }
  if (dir == 1) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 16 * warp + g + 8 * hf;
        *reinterpret_cast<float2*>(ds0 + state + row * DH + 8 * n + 2 * t) =
            make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// 2. A chunk's gradients: blockIdx.x = (b H + h) NC + c
// ---------------------------------------------------------------------------
// shared memory: in floats, S_c and G_c (DH, LD); k q, X1, X2 (C, LD);
// A (C, C + 1); M's partials (NG, C, C) and beta's (C, NG), a group of
// DH / NG channels each, and M (C, C); u, c0 (DH); then the five staged
// arrays (C, LS) in the inputs' own type (bf16 rows of 72: 16-byte
// rows); 70,720 bytes in all at C 16 in bf16, three CTAs an SM
constexpr int NG = 8;         // channel groups of M's and beta's partials
constexpr int GW = DH / NG;   // channels a group

template <typename Tp, int C>
struct ChunkSmem {
  static constexpr int LS = sizeof(Tp) == 2 ? DH + 8 : DH + 4;
  static constexpr int SC = 0;
  static constexpr int GC = SC + DH * LD;
  static constexpr int KQ = GC + DH * LD;
  static constexpr int X1 = KQ + C * LD;
  static constexpr int X2 = X1 + C * LD;
  static constexpr int AM = X2 + C * LD;
  static constexpr int MP = AM + C * (C + 1);
  static constexpr int BP = MP + NG * C * C;
  static constexpr int MM = BP + C * NG;
  static constexpr int US = MM + C * C;
  static constexpr int C0 = US + DH;
  static constexpr int FLOATS = (C0 + DH + 3) / 4 * 4;  // 16-byte aligned
  static constexpr size_t bytes =
      sizeof(float) * FLOATS + sizeof(Tp) * NA * C * LS;
};

// One staged (C, LS) array read as float32
template <typename Tp>
struct Staged {
  const Tp* p;
  __device__ __forceinline__ float operator[](int idx) const {
    return to_f(p[idx]);
  }
};

template <typename Tp, int C, bool TC>
__global__ void __launch_bounds__(NT)
    wkv6_bwd_chunk(const Tp* __restrict__ r, const Tp* __restrict__ k,
                   const Tp* __restrict__ v, const Tp* __restrict__ w,
                   const float* __restrict__ u, const Tp* __restrict__ dout,
                   const float* __restrict__ ck_s,
                   const float* __restrict__ ck_g, Tp* __restrict__ dr,
                   Tp* __restrict__ dk, Tp* __restrict__ dv,
                   Tp* __restrict__ dw, float* __restrict__ du_part, int S,
                   int H, int NC) {
  using L = ChunkSmem<Tp, C>;
  constexpr int LS = L::LS;
  extern __shared__ __align__(16) float sm[];
  float* Sc = sm + L::SC;
  float* Gc = sm + L::GC;
  float* KQ = sm + L::KQ;
  float* X1 = sm + L::X1;
  float* X2 = sm + L::X2;
  float* Am = sm + L::AM;  // A[t][s] = do_t . v_s
  float* Mp = sm + L::MP;  // [group][t][s]
  float* Bp = sm + L::BP;  // [t][group]
  float* Mm = sm + L::MM;  // M[t][s], the partials summed
  float* us = sm + L::US;
  float* c0 = sm + L::C0;
  Tp* in = reinterpret_cast<Tp*>(sm + L::FLOATS);  // [NA][C][LS]
  const Staged<Tp> R{in + AR * C * LS}, K{in + AK * C * LS},
      V{in + AV * C * LS}, W{in + AW * C * LS}, G{in + AG * C * LS};
  const Tp* Vs = V.p;
  const Tp* Gs = G.p;
  constexpr int AS = C + 1;  // A's row stride

  const int c = blockIdx.x % NC;
  const int bh = blockIdx.x / NC;
  const int h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t step = (size_t)H * DH;
  const size_t base = (size_t)(bh / H) * S * step + (size_t)h * DH;
  const int n = min(C, S - c * C);  // the chunk's steps within S
  const size_t row0 = base + (size_t)c * C * step;

  // 1. stage r, k, v, w, do (16-byte loads), S_c and G_c (float4), u:
  // every load in flight before the first store
  {
    constexpr int NV = NA * C * Vec<Tp>::VPR;
    constexpr int PV = (NV + NT - 1) / NT;
    constexpr int PS = DH * DH / 4 / NT;
    const Tp* src[NA] = {r, k, v, w, dout};
    uint4 x[PV];
#pragma unroll
    for (int m = 0; m < PV; ++m) {
      const int idx = tid + m * NT;
      if (idx < NV) {
        const int a = idx / (C * Vec<Tp>::VPR);
        x[m] = fetch_vec<Tp, C>(src[a], base, step, c,
                                idx % (C * Vec<Tp>::VPR), S, a == AW);
      }
    }
    const float4* s4 = reinterpret_cast<const float4*>(
        ck_s + ((size_t)bh * NC + c) * DH * DH);
    const float4* g4 = reinterpret_cast<const float4*>(
        ck_g + ((size_t)bh * NC + c) * DH * DH);
    float4 xs[PS], xg[PS];
#pragma unroll
    for (int m = 0; m < PS; ++m) {
      xs[m] = s4[tid + m * NT];
      xg[m] = g4[tid + m * NT];
    }
#pragma unroll
    for (int m = 0; m < PV; ++m) {
      const int idx = tid + m * NT;
      if (idx < NV) {
        const int a = idx / (C * Vec<Tp>::VPR);
        const int e = idx % (C * Vec<Tp>::VPR);
        *reinterpret_cast<uint4*>(in + (a * C + e / Vec<Tp>::VPR) * LS +
                                  (e % Vec<Tp>::VPR) * Vec<Tp>::N) = x[m];
      }
    }
#pragma unroll
    for (int m = 0; m < PS; ++m) {
      const int idx = tid + m * NT;
      const int off = (idx / (DH / 4)) * LD + (idx % (DH / 4)) * 4;
      *reinterpret_cast<float4*>(Sc + off) = round4<TC>(xs[m]);
      *reinterpret_cast<float4*>(Gc + off) = round4<TC>(xg[m]);
    }
    if (tid < DH) us[tid] = u[(size_t)h * DH + tid];
  }
  __syncthreads();

  // 2. M[t][s] = sum_i D[t,s] k_t r_s (0 for s <= t) and beta_t =
  // sum_i r_t u k_t as partials a (t, group of 8 channels), a running
  // product a channel (threads 0-127); k q, a running suffix product a
  // channel (128-191); c0 = rowsum(G_c * S_c), a row each (192-255)
  if (tid < 2 * DH) {
    static_assert(GW == 8, "a group's channels are one 16-byte load");
    const Tp* Rs = R.p;
    const Tp* Ks = K.p;
    const Tp* Ws = W.p;
    for (int pp = tid; pp < C * NG; pp += 2 * DH) {
      const int tau = pp / NG, grp = pp % NG, i0 = grp * GW;
      float kt[GW], d[GW], rt[GW], ws[GW], bsum = 0.f;
      ld8(Ks + tau * LS + i0, kt);
      ld8(Rs + tau * LS + i0, rt);
#pragma unroll
      for (int e = 0; e < GW; ++e) {
        d[e] = 1.f;
        bsum = fmaf(rt[e] * us[i0 + e], kt[e], bsum);
      }
      Bp[tau * NG + grp] = bsum;
      for (int s = 0; s < C; ++s) {
        float y = 0.f;
        if (s > tau) {
          ld8(Rs + s * LS + i0, rt);
          ld8(Ws + s * LS + i0, ws);
#pragma unroll
          for (int e = 0; e < GW; ++e) {
            y = fmaf(kt[e] * rt[e], d[e], y);
            d[e] *= ws[e];
          }
        }
        Mp[(grp * C + tau) * C + s] = y;
      }
    }
  } else if (tid < 3 * DH) {
    const int i = tid - 2 * DH;
    float run = 1.f;
#pragma unroll
    for (int tau = C - 1; tau >= 0; --tau) {
      KQ[tau * LD + i] = round1<TC>(K[tau * LS + i] * run);
      run *= W[tau * LS + i];
    }
  } else {
    // a row a thread, its columns from (j + row) % DH on: 32 rows on 32
    // banks
    const int row = tid - 3 * DH;
    float x = 0.f;
#pragma unroll 8
    for (int jj = 0; jj < DH; ++jj) {
      const int j = (jj + row) & (DH - 1);
      x = fmaf(Gc[row * LD + j], Sc[row * LD + j], x);
    }
    c0[row] = x;
  }
  __syncthreads();

  // M, its partials summed in group order (TF32 on the tensor cores)
  for (int idx = tid; idx < C * C; idx += NT) {
    float y = Mp[idx];
#pragma unroll
    for (int e = 1; e < NG; ++e) y += Mp[e * C * C + idx];
    Mm[idx] = round1<TC>(y);
  }
  __syncthreads();

  // 3. the products (tensor cores), 16-row m-tiles of 8-column n-tiles:
  // X1 = do S_c^T and X2 = v G_c^T (8 n-tiles each), dv = (k q) G_c +
  // M do + beta do (8, written out), A = do v^T (C / 8)
  {
    constexpr int PER = 24 + C / 8;
    auto col4 = [](const auto* p, int ld) {  // p[0], p[ld], p[2 ld], ...
      return make_float4(to_f(p[0]), to_f(p[ld]), to_f(p[2 * ld]),
                         to_f(p[3 * ld]));
    };
    for (int tt = warp; tt < (C / 16) * PER; tt += NT / 32) {
      const int m0 = 16 * (tt / PER), x = tt % PER;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float* out = nullptr;
      int ldo = LD, n0;
      if (x < 8) {
        n0 = 8 * x;
        tile_mma<TC, DH>(
            acc, [&](int m, int kk) { return ld4(Gs + (m0 + m) * LS + kk); },
            [&](int kk, int nn) { return ld4(Sc + (n0 + nn) * LD + kk); }, g,
            t);
        out = X1;
      } else if (x < 16) {
        n0 = 8 * (x - 8);
        tile_mma<TC, DH>(
            acc, [&](int m, int kk) { return ld4(Vs + (m0 + m) * LS + kk); },
            [&](int kk, int nn) { return ld4(Gc + (n0 + nn) * LD + kk); }, g,
            t);
        out = X2;
      } else if (x < 24) {
        n0 = 8 * (x - 16);
        tile_mma<TC, DH>(
            acc, [&](int m, int kk) { return ld4(KQ + (m0 + m) * LD + kk); },
            [&](int kk, int nn) { return col4(Gc + kk * LD + n0 + nn, LD); },
            g, t);
        tile_mma<TC, C>(
            acc, [&](int m, int s) { return ld4(Mm + (m0 + m) * C + s); },
            [&](int s, int nn) { return col4(Gs + s * LS + n0 + nn, LS); },
            g, t);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = m0 + g + 8 * hf;
          if (row < n) {
            float beta = Bp[row * NG];
#pragma unroll
            for (int e = 1; e < NG; ++e) beta += Bp[row * NG + e];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n0 + 2 * t + e;
              put(dv + row0 + (size_t)row * step + col,
                  fmaf(beta, G[row * LS + col], acc[2 * hf + e]));
            }
          }
        }
      } else {
        n0 = 8 * (x - 24);
        tile_mma<TC, DH>(
            acc, [&](int m, int kk) { return ld4(Gs + (m0 + m) * LS + kk); },
            [&](int kk, int nn) { return ld4(Vs + (n0 + nn) * LS + kk); }, g,
            t);
        out = Am, ldo = AS;
      }
      if (out != nullptr) {
        out += m0 * ldo + n0;
        out[g * ldo + 2 * t] = acc[0];
        out[g * ldo + 2 * t + 1] = acc[1];
        out[(g + 8) * ldo + 2 * t] = acc[2];
        out[(g + 8) * ldo + 2 * t + 1] = acc[3];
      }
    }
  }
  __syncthreads();

  // 4. a channel i a thread: dw (threads 0-63), dr (64-127), dk
  // (128-191), du's partial (192-255); p and q as running products
  const int i = tid & (DH - 1), role = tid / DH;
  float wr[C];
#pragma unroll
  for (int tau = 0; tau < C; ++tau) wr[tau] = W[tau * LS + i];
  const float ui = us[i];
  if (role == 3) {
    float y = 0.f;
#pragma unroll
    for (int tau = 0; tau < C; ++tau)
      y = fmaf(R[tau * LS + i] * K[tau * LS + i], Am[tau * AS + tau], y);
    du_part[((size_t)bh * NC + c) * DH + i] = y;
  } else if (role == 0) {
    float kr[C], rr[C];
#pragma unroll
    for (int tau = 0; tau < C; ++tau) {
      kr[tau] = K[tau * LS + i];
      rr[tau] = R[tau * LS + i];
    }
    // the pairs s' < t < s: T4[t] = sum_{s>t} D[t,s] r_s H[s,t], by
    // Horner over s from the last, with H[s,t] = sum_{s'<t} D[s',t]
    // k_s' A[s,s'] by Horner over t from the first
    float T4[C];
#pragma unroll
    for (int tau = 0; tau < C; ++tau) T4[tau] = 0.f;
#pragma unroll
    for (int s = C - 1; s >= 1; --s) {
      float hh = 0.f;
#pragma unroll
      for (int tp = 0; tp < s; ++tp) {
        T4[tp] = fmaf(wr[s], T4[tp], rr[s] * hh);
        hh = fmaf(wr[tp], hh, kr[tp] * Am[s * AS + tp]);
      }
    }
    // ascending: p_t and e1_t = p_t c0 + sum_{s<t} D[s,t] k_s X2_s
    float pr[C], e1[C], p = 1.f, a2 = 0.f;
    const float cc = c0[i];
#pragma unroll
    for (int tau = 0; tau < C; ++tau) {
      pr[tau] = p;
      e1[tau] = fmaf(p, cc, a2);
      a2 = fmaf(wr[tau], a2, kr[tau] * X2[tau * LD + i]);
      p *= wr[tau];
    }
    // descending: dw_t = q_t e1_t + p_t sum_{s>t} D[t,s] r_s X1_s + T4
    float q = 1.f, b3 = 0.f;
#pragma unroll
    for (int tau = C - 1; tau >= 0; --tau) {
      const float x = fmaf(q, e1[tau], fmaf(pr[tau], b3, T4[tau]));
      b3 = fmaf(wr[tau], b3, rr[tau] * X1[tau * LD + i]);
      q *= wr[tau];
      if (tau < n) put(dw + row0 + (size_t)tau * step + i, x);
    }
  } else if (role == 1) {
    float kr[C];
#pragma unroll
    for (int tau = 0; tau < C; ++tau) kr[tau] = K[tau * LS + i];
    float p = 1.f;
#pragma unroll
    for (int tau = 0; tau < C; ++tau) {
      float a = 0.f;  // sum_{s<t} D[s,t] k_s A[t,s]
#pragma unroll
      for (int s = 0; s < tau; ++s)
        a = fmaf(wr[s], a, kr[s] * Am[tau * AS + s]);
      const float x = fmaf(p, X1[tau * LD + i], a) +
                      ui * kr[tau] * Am[tau * AS + tau];
      if (tau < n) put(dr + row0 + (size_t)tau * step + i, x);
      p *= wr[tau];
    }
  } else {
    float rr[C];
#pragma unroll
    for (int tau = 0; tau < C; ++tau) rr[tau] = R[tau * LS + i];
    float q = 1.f;
#pragma unroll
    for (int tau = C - 1; tau >= 0; --tau) {
      float e = 0.f;  // sum_{s>t} D[t,s] r_s A[s,t]
#pragma unroll
      for (int s = C - 1; s > tau; --s)
        e = fmaf(wr[s], e, rr[s] * Am[s * AS + tau]);
      const float x = fmaf(q, X2[tau * LD + i], e) +
                      ui * rr[tau] * Am[tau * AS + tau];
      if (tau < n) put(dk + row0 + (size_t)tau * step + i, x);
      q *= wr[tau];
    }
  }
}

// ---------------------------------------------------------------------------
// 3. du[h][i] = sum over b, then chunks, in order, of the partials
// ---------------------------------------------------------------------------
__global__ void wkv6_bwd_du(const float* __restrict__ du_part,
                            float* __restrict__ du, int B, int H, int NC) {
  const int h = blockIdx.x, i = threadIdx.x;
  float x = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < NC; ++c)
      x += du_part[(((size_t)b * H + h) * NC + c) * DH + i];
  du[(size_t)h * DH + i] = x;
}

template <typename Tp, int C>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, const void* dout,
           const void* ds_last, void* dr, void* dk, void* dv, void* dw,
           void* du, void* ds0, void* du_part, void* ckpt, int B, int S,
           int H, cudaStream_t stream) {
  constexpr bool TC = sizeof(Tp) == 2;  // bf16: TF32 tensor cores
  const int NC = (S + C - 1) / C;
  float* ck_s = (float*)ckpt;
  float* ck_g = ck_s + (size_t)B * H * NC * DH * DH;
  wkv6_bwd_chains<Tp, C, TC><<<2 * B * H, CHAIN_NT, 0, stream>>>(
      (const Tp*)r, (const Tp*)k, (const Tp*)v, (const Tp*)w,
      (const Tp*)dout, (const float*)s0, (const float*)ds_last, ck_s, ck_g,
      (float*)ds0, S, H, NC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr size_t smem = ChunkSmem<Tp, C>::bytes;
  err = cudaFuncSetAttribute(wkv6_bwd_chunk<Tp, C, TC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_chunk<Tp, C, TC><<<B * H * NC, NT, smem, stream>>>(
      (const Tp*)r, (const Tp*)k, (const Tp*)v, (const Tp*)w,
      (const float*)u, (const Tp*)dout, ck_s, ck_g, (Tp*)dr, (Tp*)dk,
      (Tp*)dv, (Tp*)dw, (float*)du_part, S, H, NC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_du<<<H, DH, 0, stream>>>((const float*)du_part, (float*)du, B,
                                    H, NC);
  return (int)cudaGetLastError();
}

template <typename Tp>
int launch_chunk(int chunk, const void* r, const void* k, const void* v,
                 const void* w, const void* u, const void* s0,
                 const void* dout, const void* ds_last, void* dr, void* dk,
                 void* dv, void* dw, void* du, void* ds0, void* du_part,
                 void* ckpt, int B, int S, int H, cudaStream_t s) {
  switch (chunk) {
    case 16:
      return launch<Tp, 16>(r, k, v, w, u, s0, dout, ds_last, dr, dk, dv, dw,
                            du, ds0, du_part, ckpt, B, S, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, w, do and dr, dk, dv, dw (B, S, H, dh) contiguous and 16-byte
// aligned, all float32 (bf16 = 0) or all bfloat16 (bf16 = 1); u, du
// (H, dh) float32; s0, ds0 (B, H, dh, dh) float32; ds_last the same or
// null (zeros).  chunk is the caller's chunk length C (kernels/wkv6.py:
// BWD_CHUNK owns it; the kernels are built for 16).  With NC = ceil(S /
// C), ckpt is a float32 workspace of 2 x B x H x NC x dh x dh (S_c, then
// G_c), du_part one of B x H x NC x dh.  dh must be 64, S at least 1.
// Launches three kernels on `stream`; returns the first nonzero
// cudaGetLastError() (cudaErrorInvalidValue for another dh or chunk).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               const void* dout, const void* ds_last,
                               void* dr, void* dk, void* dv, void* dw,
                               void* du, void* ds0, void* du_part,
                               void* ckpt, int B, int S, int H, int dh,
                               int bf16, int chunk, void* stream) {
  if (dh != DH || S < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_chunk<__nv_bfloat16>(chunk, r, k, v, w, u, s0, dout,
                                       ds_last, dr, dk, dv, dw, du, ds0,
                                       du_part, ckpt, B, S, H, s);
  return launch_chunk<float>(chunk, r, k, v, w, u, s0, dout, ds_last, dr, dk,
                             dv, dw, du, ds0, du_part, ckpt, B, S, H, s);
}
