// Hopper (sm_90a) building blocks shared by the attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): mbarriers, TMA loads of
// 64-row tiles through 4-d tensor maps over the (B, S, heads, dh) bf16
// layout, wgmma matrix descriptors of the swizzled tiles, and the wgmma
// products both kernels run (SS m64n64k16 for scores; RS m64n{dh}k16
// with B read N-major through the transpose bit).  For float32 inputs
// (both attention kernels and the WKV backward): TF32 mma.sync m16n8k8,
// the split-TF32 product that keeps float32 accuracy on the tensor
// cores, cp.async staging and the swizzled float32 tile both attention
// directions read with 16-byte loads.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_ROWS = 64;  // rows of every TMA box and wgmma tile

// The shared-memory geometry of one 64-row bf16 tile of head dim DH,
// stored as NBOX = DH / COLS column blocks of 64 rows x SW bytes (one
// TMA box each): the swizzle is 128 bytes where DH is a multiple of 64,
// a dh-32 row's 64, and 32 bytes (boxes of 16 columns, one wgmma k-step
// each) for any other multiple of 16: stablelm's dh 80 is five 32-byte
// boxes (kernels/flash_attention.py: tile mirrors this)
template <int DH>
struct Tile {
  static_assert(DH % 16 == 0, "a head dim of whole 16-column k-steps");
  static constexpr int SW = DH % 64 == 0 ? 128 : DH == 32 ? 64 : 32;
  static constexpr int COLS = SW / 2;
  static constexpr int NBOX = DH / COLS;
  static constexpr int BOX = TILE_ROWS * SW;  // bytes of one box
  static constexpr int TILE = TILE_ROWS * DH * 2;
  // the wgmma descriptor's swizzle code: 1 for 128 bytes, 2 for 64, 3
  // for 32
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16 pair (lo in the low half) back to float32, exactly
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the barrier's phase of `parity` to complete.  A copy that
// never lands (a tensor map at fault) traps after 2^24 polls (a second
// or more), so the launch fails with an error instead of hanging the card.
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

// One box of a 4-d tensor map, {c0, c1, c2, c3} innermost first
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The wgmma matrix descriptor of a swizzled tile at shared address
// `addr`: start, leading and stride byte offsets in 16-byte units, and
// the swizzle code in bits 62-63
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | (layout << 62);
}

// 2^x on the special-function unit (relative error about 2^-22; 0 for
// x below -126, as for every masked key)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) for y = 2 x log2(e): 1 - 2 / (1 + 2^y), |y| held to 43 (tanh
// of 15, which rounds to 1 in float32), so 2^y stays finite
__device__ __forceinline__ float tanh_ex2(float y) {
  y = fminf(fmaxf(y, -43.f), 43.f);
  return 1.f - __fdividef(2.f, 1.f + ex2(y));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins accumulator registers at this point of the program: ordinary
// code may not touch them between an mma_async and its wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, float32) += A (64 x 16) B^T, A and B K-major in shared
// memory (descriptors da, db)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32, float32) += A (64 x 16, bf16 pairs in registers) B, B
// in shared memory with N contiguous (descriptor db, transpose bit set)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, float32) += A (64 x 16, bf16 pairs in registers) B, B
// in shared memory with N contiguous (descriptor db, transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 80, float32) += A (64 x 16, bf16 pairs in registers) B, B
// in shared memory with N contiguous (descriptor db, transpose bit set):
// stablelm's dh 80, five 16-column boxes of a 32-byte-swizzled V tile
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, float32) += A (64 x 16, bf16 pairs in registers) B, B
// in shared memory with N contiguous (descriptor db, transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, float32) += A (64 x 16, bf16 pairs in registers) B, B
// in shared memory with N contiguous (descriptor db, transpose bit set)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DH == 32) wgmma_rs_n32(d, a, db);
  if constexpr (DH == 64) wgmma_rs_n64(d, a, db);
  if constexpr (DH == 80) wgmma_rs_n80(d, a, db);
  if constexpr (DH == 128) wgmma_rs_n128(d, a, db);
  if constexpr (DH == 256) wgmma_rs_n256(d, a, db);
}

// ---------------------------------------------------------------------------
// float32 on the TF32 tensor cores
// ---------------------------------------------------------------------------
// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to
// nearest, ties away from zero, 10 mantissa bits; the low 13 bits of
// the pattern zero), as the .b32 pattern an mma operand takes: half a
// TF32 ulp added to the magnitude bits, then truncated.  Two integer
// operations, where ptxas lowers cvt.rna.tf32.f32 to about seven (its
// NaN and infinity cases included): the split-TF32 products convert
// every operand twice, and that count bounded them.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d (16 x 8) += a (16 x 8) b (8 x 8): mma.sync m16n8k8 in TF32 (the
// fragments: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (t, g), b1 (t + 4, g); d (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1), g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A float32 operand as two TF32 terms: big = tf32(x), small = tf32(x -
// big); big + small is x to about 2^-22 relative
struct Split {
  uint32_t big, small;
};
__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t big = tf32(x);
  return {big, tf32(x - __uint_as_float(big))};
}

// An A fragment's four values (slots a0-a3) split into TF32 terms
struct SplitA {
  uint32_t big[4], small[4];
};
__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2,
                                          float a3) {
  const float x[4] = {a0, a1, a2, a3};
  SplitA r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split_tf32(x[i]);
    r.big[i] = s.big, r.small[i] = s.small;
  }
  return r;
}

// d_i (16 x 8, the 4 floats at d + 4i) += a b_i for N n-tiles in
// float32 accuracy on the TF32 tensor cores (the split-TF32 product):
// small·big + big·small + big·big, the small terms first; the
// small·small term (about 2^-22 relative) is dropped.  b_i's k slots t
// and t + 4 hold b0[i] and b1[i].  Term by term across the N
// accumulators, so that consecutive mma's write different ones: a warp
// issues in order, and an mma that needs the last one's result waits out
// its latency.
template <int N>
__device__ __forceinline__ void mma_split(float* d, const SplitA& a,
                                          const float (&b0)[N],
                                          const float (&b1)[N]) {
  Split x[N], y[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    x[i] = split_tf32(b0[i]), y[i] = split_tf32(b1[i]);
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma_tf32(*reinterpret_cast<float(*)[4]>(d + 4 * i), a.small, x[i].big,
             y[i].big);
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma_tf32(*reinterpret_cast<float(*)[4]>(d + 4 * i), a.big, x[i].small,
             y[i].small);
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma_tf32(*reinterpret_cast<float(*)[4]>(d + 4 * i), a.big, x[i].big,
             y[i].big);
}

// 16 bytes from global to shared memory without the registers; zeros
// where !valid (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A float32 tile of head dim DH in shared memory: rows of PITCH floats
// (DH rounded up to 32: a row is whole 128-byte lines), each row's
// 16-byte chunks permuted within their group of 8 by XOR with
// swz(row).  Both ways the kernels read a tile are then free of bank
// conflicts:
//  - "row" reads (a score's operands, K-major): lane (g, t) loads chunk
//    4s + t of row r0 + g, 16 columns s a warp-wide load: rows g = 0, 1
//    of one 8-lane phase differ in bit 2 of swz;
//  - "column" reads (P·V's V, dV's dO, dK's Q, dQ's K, N-major): lane
//    (g, t) loads chunk 8c + g of rows 8j + 2t and 8j + 2t + 1: the
//    phase's four rows 2t + e differ in bits 1 and 2 of swz.
template <int DH>
struct F32Tile {
  static_assert(DH % 16 == 0, "a head dim of whole 16-column groups");
  static constexpr int PITCH = (DH + 31) / 32 * 32;
};
__device__ __forceinline__ int swz(int r) {
  return ((r & 1) << 2) ^ (((r >> 1) & 3) << 1);
}
// the float offset of chunk c4 (4 floats) of row r
template <int DH>
__device__ __forceinline__ int f32_at(int r, int c4) {
  return r * F32Tile<DH>::PITCH + 4 * (c4 ^ swz(r));
}

// Rows [r0, r0 + ROWS) of one head of a (B, S, heads, DH) float32
// tensor (`base` at the batch row's position 0 and the head's column 0,
// `row_step` floats a position) into a swizzled tile by cp.async, the
// CTA's NT threads a chunk each in turn; rows past S are zeros
template <int DH, int ROWS, int NT>
__device__ __forceinline__ void stage_f32(float* tile, const float* base,
                                          int r0, int S, size_t row_step) {
  constexpr int C4 = DH / 4;
  for (int i = threadIdx.x; i < ROWS * C4; i += NT) {
    const int r = i / C4, c = i % C4;
    const int s = r0 + r;
    const bool ok = s < S;
    cp_async16(smem_u32(tile + f32_at<DH>(r, c)),
               base + (size_t)(ok ? s : 0) * row_step + 4 * c, ok);
  }
}

// The split A fragments of k-steps 2s and 2s + 1 of a 16-row block of a
// swizzled tile (rows r0 + g and r0 + g + 8, columns 16s to 16s + 15):
// lane t's k slots are columns 16s + 4t + {0, 1} (k-step 2s) and
// 16s + 4t + {2, 3} (2s + 1), one 16-byte load a row
template <int DH>
__device__ __forceinline__ void row_a(const float* tile, int r0, int s,
                                      int g, int t, SplitA (&a)[2]) {
  const float4 x = *reinterpret_cast<const float4*>(
      tile + f32_at<DH>(r0 + g, 4 * s + t));
  const float4 y = *reinterpret_cast<const float4*>(
      tile + f32_at<DH>(r0 + g + 8, 4 * s + t));
  a[0] = split_a(x.x, y.x, x.y, y.y);
  a[1] = split_a(x.z, y.z, x.w, y.w);
}

// The tensor cores truncate as they accumulate (round toward zero), so
// a long chain of mma's onto one accumulator drifts by up to 2^-23 of it
// a step.  The float32 products therefore sum a short run of k-steps in
// fresh registers and add it to the running sum in float32 (rounded):
// row_mma a run of 32 columns (12 mma's), col_mma a run of one tile's
// rows (12 or 24).

// acc (16 x 8 NT) = A B^T over DH: A rows r0 + g, r0 + g + 8 of
// swizzled tile ta, B^T's columns rows 0..8 NT - 1 of swizzled tile tb
// (the scores S, S^T, dP, dP^T), both read as rows
template <int DH, int NT>
__device__ __forceinline__ void row_mma(float (&acc)[NT * 4], const float* ta,
                                        int r0, const float* tb, int g,
                                        int t) {
  float run[NT * 4];
#pragma unroll
  for (int s = 0; s < DH / 16; ++s) {
    if (s % 2 == 0) {
#pragma unroll
      for (int e = 0; e < NT * 4; ++e) run[e] = 0.f;
    }
    SplitA a[2];
    row_a<DH>(ta, r0, s, g, t, a);
    // n-tile j's B: rows 8j + g of tb, the k slots as row_a's
    float4 z[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      z[j] = *reinterpret_cast<const float4*>(
          tb + f32_at<DH>(8 * j + g, 4 * s + t));
    float b0[NT], b1[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) b0[j] = z[j].x, b1[j] = z[j].y;
    mma_split<NT>(run, a[0], b0, b1);
#pragma unroll
    for (int j = 0; j < NT; ++j) b0[j] = z[j].z, b1[j] = z[j].w;
    mma_split<NT>(run, a[1], b0, b1);
    if (s % 2 == 1 || s == DH / 16 - 1) {
#pragma unroll
      for (int e = 0; e < NT * 4; ++e)
        acc[e] = s < 2 ? run[e] : acc[e] + run[e];
    }
  }
}

// A score accumulator (rows g, g + 8; columns 2t, 2t + 1 of an 8-wide
// n-tile) as the A fragment of the next product's k-step over those 8
// columns, its k slots t and t + 4 standing for columns 2t and 2t + 1:
// no value leaves its lane
__device__ __forceinline__ SplitA acc_a(const float* c) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// acc (16 x NO, n-tiles of the output columns [c0, c0 + NO) of a
// swizzled (rows = k, DH) tile) += P B over the tile's 8 NK rows, P
// (16 x 8 NK) a score accumulator taken as A fragments (acc_a): lane
// (g, t) reads rows 8j + 2t and 8j + 2t + 1 a 16-byte chunk (8g..) of
// each 32-column group, so n-tile 4c + i's column g is d = 32c + 4g + i
// (a 16-column tail group, DH % 32 = 16: an 8-byte half chunk, d = 32c
// + 2g + i); col_store writes them back in order.  Each group's sum over
// the NK k-steps is made in fresh registers, then added to acc.
template <int DH, int NO, int NK>
__device__ __forceinline__ void col_mma(float (&acc)[NO / 2],
                                        const float* tile, int c0, int g,
                                        int t, const float (&p)[NK * 4]) {
  SplitA a[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) a[j] = acc_a(&p[4 * j]);
#pragma unroll
  for (int c = 0; c < NO / 32; ++c) {
    const int c4 = (c0 / 4) + 8 * c + g;
    float run[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) run[e] = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int r = 8 * j + 2 * t;
      const float4 u =
          *reinterpret_cast<const float4*>(tile + f32_at<DH>(r, c4));
      const float4 w =
          *reinterpret_cast<const float4*>(tile + f32_at<DH>(r + 1, c4));
      const float b0[4] = {u.x, u.y, u.z, u.w}, b1[4] = {w.x, w.y, w.z, w.w};
      mma_split<4>(run, a[j], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[16 * c + e] += run[e];
  }
  if constexpr (NO % 32 == 16) {
    constexpr int c = NO / 32;
    const int c4 = (c0 / 4) + 8 * c + g / 2;
    const int off = 2 * (g & 1);
    float run[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) run[e] = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int r = 8 * j + 2 * t;
      const float2 u = *reinterpret_cast<const float2*>(
          tile + f32_at<DH>(r, c4) + off);
      const float2 w = *reinterpret_cast<const float2*>(
          tile + f32_at<DH>(r + 1, c4) + off);
      const float b0[2] = {u.x, u.y}, b1[2] = {w.x, w.y};
      mma_split<2>(run, a[j], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[16 * c + e] += run[e];
  }
}

// Row `row` (half hf: accumulator slots 2 hf, 2 hf + 1) of col_mma's
// accumulator, times f, to `dst` (the row's column c0 in global
// memory): lane t holds columns 32c + 8t .. + 7 of each 32-column group
// (32c + 4t .. + 3 of a tail group), written by 16-byte stores
template <int NO>
__device__ __forceinline__ void col_store(float* dst,
                                          const float (&acc)[NO / 2], int hf,
                                          int t, float f) {
#pragma unroll
  for (int c = 0; c < NO / 32; ++c) {
    const float* a = acc + 16 * c + 2 * hf;
    *reinterpret_cast<float4*>(dst + 32 * c + 8 * t) =
        make_float4(a[0] * f, a[4] * f, a[8] * f, a[12] * f);
    *reinterpret_cast<float4*>(dst + 32 * c + 8 * t + 4) =
        make_float4(a[1] * f, a[5] * f, a[9] * f, a[13] * f);
  }
  if constexpr (NO % 32 == 16) {
    const float* a = acc + 16 * (NO / 32) + 2 * hf;
    *reinterpret_cast<float4*>(dst + 32 * (NO / 32) + 4 * t) =
        make_float4(a[0] * f, a[4] * f, a[1] * f, a[5] * f);
  }
}

// Makes the current device's primary context current on the calling
// thread, which cuTensorMapEncodeTiled needs: a thread that has made no
// CUDA runtime call yet has none (autograd's backward thread, when a
// kernel's backward is the first CUDA work it runs), and the encode then
// fails.  cudaSetDevice binds the primary context and does not wait on
// the device.
inline void bind_context() {
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaSetDevice(dev);
}

// cuTensorMapEncodeTiled, a driver-API call, found through the runtime
// so that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled find_encode_tiled() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess
             ? (EncodeTiled)p
             : nullptr;
}

// looked up once, by the first launcher to ask: a function-local static
// is initialised once however many host threads launch at once
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = find_encode_tiled();
  return fn;
}

// The 4-d map {dh, heads, S, B} of a contiguous (B, S, heads, dh) bf16
// tensor, boxes of {cols, 1, 64, 1}: one 64-row tile of one head, `cols`
// columns of it, swizzled as the wgmma descriptors read it.  Rows past S
// are zero-filled; a box never crosses into the next batch row.
bool tensor_map(CUtensorMap* map, const void* base, int B, int S, int heads,
                int dh, int cols, int swizzle_bytes) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * dh, 2ull * dh * heads,
                                 2ull * dh * heads * S};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)TILE_ROWS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                      : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
