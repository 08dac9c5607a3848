// Warp-level tensor-core helpers for sm_80+ (used on sm_90a): ldmatrix,
// mma.sync m16n8k16 bf16 x bf16 -> fp32 and m16n8k8 tf32 x tf32 -> fp32,
// cp.async, and the fragment layouts that tie them together.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for lane
// l of the warp, g = l / 4 and t = l % 4 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"):
//   A (16 x 16, row-major), 4 x b32, each two bf16 of adjacent columns:
//     a[0] (g, 2t..2t+1)   a[1] (g+8, 2t..2t+1)
//     a[2] (g, 2t+8..+9)   a[3] (g+8, 2t+8..+9)
//   B (16 x 8, k x n, given as its transpose n x k row-major), 2 x b32:
//     b[0] (k = 2t..2t+1, n = g)   b[1] (k = 2t+8..+9, n = g)
//   C/D (16 x 8, fp32), 4 floats:
//     c[0], c[1] (g, 2t..2t+1)   c[2], c[3] (g+8, 2t..2t+1)
// So the C fragments of two adjacent n-tiles (columns 0-7 and 8-15) hold
// exactly the A fragment of the 16 x 16 block they cover (`a_from_c_split`): a
// product's output feeds the next product from registers.
//
// Shared-memory tiles are bf16, row-major, with a row stride `ld` (elements)
// whose byte size is an odd multiple of 16 (`padded_ld`): the 8 rows of
// each 8 x 8 matrix that ldmatrix reads then start in 8 distinct 16-byte
// bank groups, so it reads without bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

// Row stride (elements) of a bf16 tile holding d columns: d rounded up to
// the mma depth 16, plus 8 (16 bytes), so the stride in 16-byte units is odd.
inline __host__ __device__ int padded_ld(int d) { return ((d + 15) / 16) * 16 + 8; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8. Without .trans lane l receives (row l / 4, columns 2 (l % 4)
// and +1) of each matrix; with .trans the same of its transpose.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b over one m16n8k16 block, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane addresses for the three ways a 16 x 16 block of a row-major tile
// (row stride ld) at (r0, c0) is read; `lane` is the lane in the warp.
// A operand: matrices (rows 0-7 | 8-15) x (columns 0-7 | 8-15) -> a[0..3].
__device__ __forceinline__ const __nv_bfloat16* a_addr(const __nv_bfloat16* t, int ld, int r0,
                                                       int c0, int lane) {
  return t + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
// B operand of two n-tiles from a tile stored n x k (rows are n): registers
// {b0, b1} of n-tile rows r0..r0+7, then of rows r0+8..r0+15; c0 is k.
__device__ __forceinline__ const __nv_bfloat16* bt_addr(const __nv_bfloat16* t, int ld, int r0,
                                                        int c0, int lane) {
  return t + (r0 + ((lane >> 4) & 1) * 8 + (lane & 7)) * ld + c0 + ((lane >> 3) & 1) * 8;
}
// B operand of two n-tiles from a tile stored k x n (rows are k), read with
// ldmatrix .trans: {b0, b1} of columns c0..c0+7, then of c0+8..c0+15.
__device__ __forceinline__ const __nv_bfloat16* b_addr(const __nv_bfloat16* t, int ld, int r0,
                                                       int c0, int lane) {
  return t + (r0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + c0 + ((lane >> 4) & 1) * 8;
}

// Two 8 x 8 b16 matrices (lanes 0-15 give the row addresses), as x4.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 for lane l,
// g = l / 4, t = l % 4 (PTX ISA, "Matrix fragments for mma.m16n8k8"):
//   A (16 x 8, row-major), 4 x b32: a[0] (g, t)  a[1] (g+8, t)  a[2] (g, t+4)
//     a[3] (g+8, t+4)
//   B (8 x 8, k x n), 2 x b32: b[0] (k = t, n = g)  b[1] (k = t+4, n = g)
//   C/D as m16n8k16's.
// An fp32 tile in shared memory read by ldmatrix (.b16, no .trans) gives
// exactly these: an 8 x 8 b16 matrix is 8 rows of 4 floats, and lane l
// receives word l % 4 of row l / 4. So A is ldmatrix_x4 of the 16 x 8 block
// (rows 0-7 | 8-15) x (columns 0-3 | 4-7), and B, for a tile X stored n x k
// (B = X^T, as in a Gram matrix X X^T), ldmatrix_x2 of rows n0..n0+7, columns
// k0..k0+3 | k0+4..k0+7.

// x as a TF32 pair: hi = x rounded to TF32's 10 mantissa bits (half an ulp
// added to the bits, then the low 13 bits cleared: two integer operations;
// cvt.rna.tf32.f32 does the same but at a fraction of the rate) and lo = x -
// hi, exact in fp32, which the MMA reads to TF32 (truncating). A product
// issued three times into one fp32 accumulator (lo hi, hi lo, hi hi;
// 3xTF32) keeps ~fp32 operands: what it drops, lo lo and lo's truncation, is
// ~2^-20 of the product.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// d += a b over one m16n8k8 block, tf32 operands, fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16x2, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments hi and lo of the 16 x 16 fp32 block held by C fragments
// c0 (columns 0-7) and c1 (columns 8-15): hi = bf16(x), lo = bf16(x - hi),
// so hi + lo carries x to ~2^-17 relative and a product issued twice (hi,
// then lo) into one fp32 accumulator keeps fp32-grade operands.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ void a_from_c_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&c0)[4], const float (&c1)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}

// cp.async of `bytes` (4, 8 or 16) from global to shared memory; with
// `fill` false nothing is read and the destination is zeroed.
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool fill) {
  const int n = fill ? Bytes : 0;
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(Bytes), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mma
