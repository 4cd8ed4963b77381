// Tensor-core building blocks of the flash kernels (flash_attn.cu): bf16
// mma.m16n8k16 for bfloat16 inputs, and TF32 mma.m16n8k8 in three
// products (3xTF32) for float32 inputs.
//
// Each helper is one small device function over one PTX instruction, so a
// CPU rehearsal can compile the kernels with g++ and put an emulation of
// the same instruction in its place (define FPS_MMA_EMULATION and provide
// functions of these names; see the port's verify notes).  Fragment
// layouts are those of the PTX ISA for mma.m16n8k16 with .bf16 inputs,
// with g = lane / 4 and t = lane % 4:
//
//   A (16 x 16, row-major), four registers of two bf16:
//     a0 = A[g][2t, 2t+1]   a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, +9]   a3 = A[g+8][2t+8, +9]
//   B (16 x 8, k x n), two registers:
//     b0 = B[2t, 2t+1][g]   b1 = B[2t+8, 2t+9][g]
//   C/D (16 x 8, float32), four floats:
//     c0, c1 = C[g][2t, 2t+1]   c2, c3 = C[g+8][2t, 2t+1]
//
// The lower half of a register holds the element of lower index.  For
// mma.m16n8k8 with .tf32 inputs, one element a register:
//
//   A (16 x 8, row-major): a0 = A[g][t]  a1 = A[g+8][t]  a2 = A[g][t+4]  a3 = A[g+8][t+4]
//   B (8 x 8, k x n):      b0 = B[t][g]  b1 = B[t+4][g]
//   C/D: as above.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fps {

#ifndef FPS_MMA_EMULATION

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously (cp.async.cg: not kept in L1).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

// Closes the group of copies issued by this thread since the last commit.
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory.  Lane l gives the address
// of row l % 8 of matrix l / 8; matrix i lands in r[i], lane l holding
// row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// The same, transposed: lane l holds rows 2 (l % 4) and 2 (l % 4) + 1 of
// column l / 4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(smem)));
}

// d += A B for one 16 x 8 x 16 tile: bf16 inputs, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero):
// half a TF32 unit added to the bits of its magnitude, the 13 low bits
// cleared, so the register also reads as that float.  What
// cvt.rna.tf32.f32 computes for finite x, in two integer instructions.
__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// d += A B for one 16 x 8 x 8 tile: TF32 inputs (the tensor cores read
// each register's top 19 bits), float32 sums.  Not volatile: the
// compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = A B, the same product from a zero sum.
__device__ __forceinline__ void mma_tf32_from_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                                   uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

#endif  // FPS_MMA_EMULATION

// Two floats rounded to nearest bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

// The low and high bf16 of a register, as floats.
__device__ __forceinline__ float bf16_lo(uint32_t r) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(r & 0xffffu)));
}
__device__ __forceinline__ float bf16_hi(uint32_t r) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(r >> 16)));
}

// The accumulators of two neighbouring 16 x 8 tiles (columns 0-7 in c0,
// 8-15 in c1) as the A operand of the next product, rounded to bf16: a
// product's result feeds the next one without passing through shared
// memory (FlashAttention-2's register reuse).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The same as two operands, hi + lo: hi is the bf16 rounding of each value
// and lo the bf16 rounding of what hi leaves over, so hi + lo carries the
// float32 value to about 2^-16 of itself.
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&c0)[4],
                                               const float (&c1)[4]) {
  acc_to_a(hi, c0, c1);
  lo[0] = pack_bf16(c0[0] - bf16_lo(hi[0]), c0[1] - bf16_hi(hi[0]));
  lo[1] = pack_bf16(c0[2] - bf16_lo(hi[1]), c0[3] - bf16_hi(hi[1]));
  lo[2] = pack_bf16(c1[0] - bf16_lo(hi[2]), c1[1] - bf16_hi(hi[2]));
  lo[3] = pack_bf16(c1[2] - bf16_lo(hi[3]), c1[3] - bf16_hi(hi[3]));
}

// ---- 3xTF32: float32 products on the TF32 tensor cores ----
//
// A float32 x splits into big = tf32(x) and small = x - big, exact in
// float32; the tensor cores read small to TF32 (its top 19 bits), so big
// + small carries x to about 2^-21 of itself.  A product takes three TF32
// products, small_a big_b + big_a small_b + big_a big_b (CUTLASS's "fast
// float32"); the dropped small_a small_b is at most 2^-22 of it.  A TF32
// product alone keeps 2^-11.
//
// The tensor cores add a product's terms with truncation, so a sum carried
// through their accumulator over many products drifts toward zero (about
// 2^-24 of it an add, all one way).  So each 3xTF32 product starts from
// zero and its result is added to the running sum in the CUDA cores,
// rounded to nearest like any float32 add.

// TF32 big / small halves of N operand registers.
template <int N>
struct Split {
  uint32_t big[N], small[N];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// The four registers of an ldmatrix_x4 of float32 tiles, split.
__device__ __forceinline__ Split<4> split4(const uint32_t (&r)[4]) {
  Split<4> s;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), s.big[i], s.small[i]);
  return s;
}

// The accumulators of one 16 x 8 tile as the A operand of the next
// product, split, with its k index permuted: k = t holds column 2t and
// k = t + 4 column 2t + 1, so the lane's own C registers are its A
// registers.  The product's B rows must be read in the same order.
__device__ __forceinline__ Split<4> acc_to_a_tf32(const float (&c)[4]) {
  Split<4> s;
  split_tf32(c[0], s.big[0], s.small[0]);  // (g, 2t)
  split_tf32(c[2], s.big[1], s.small[1]);  // (g + 8, 2t)
  split_tf32(c[1], s.big[2], s.small[2]);  // (g, 2t + 1)
  split_tf32(c[3], s.big[3], s.small[3]);  // (g + 8, 2t + 1)
  return s;
}

// sum[n + j] = A B_j (or += A B_j with kAdd) for J tiles in 3xTF32, B_j in
// registers 2j, 2j + 1 of b: cross terms first, the J chains interleaved,
// every add in the tensor cores.
template <bool kAdd, int J, int N>
__device__ __forceinline__ void mma_3xtf32_chain(float (&sum)[N][4], int n, const Split<4>& a,
                                                 const Split<2 * J>& b) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if constexpr (kAdd) mma_tf32(sum[n + j], a.small, b.big[2 * j], b.big[2 * j + 1]);
    else mma_tf32_from_zero(sum[n + j], a.small, b.big[2 * j], b.big[2 * j + 1]);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) mma_tf32(sum[n + j], a.big, b.small[2 * j], b.small[2 * j + 1]);
#pragma unroll
  for (int j = 0; j < J; ++j) mma_tf32(sum[n + j], a.big, b.big[2 * j], b.big[2 * j + 1]);
}

// sum[n + j] += A B_j: the product from zero, added to the running sum in
// the CUDA cores.
template <int J, int N>
__device__ __forceinline__ void mma_3xtf32(float (&sum)[N][4], int n, const Split<4>& a, const Split<2 * J>& b) {
  float t[J][4];
  mma_3xtf32_chain<false, J>(t, 0, a, b);
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[n + j][e] += t[j][e];
}

}  // namespace fps
