// Tensor-core building blocks of the bfloat16 flash kernels (flash_attn.cu).
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
// The lower half of a register holds the element of lower index.
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

}  // namespace fps
