// Shared helpers for the hand-written Hopper kernels of sd_tpu_torch.
//
// Every kernel here multiplies on the tensor cores through the warp-level
// `mma.sync.m16n8k16` bf16 instruction with fp32 accumulation. Fragment
// layout (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major) four .b32 registers of two bf16 each:
//     a0 = A[g][2t..2t+1]     a1 = A[g+8][2t..2t+1]
//     a2 = A[g][2t+8..2t+9]   a3 = A[g+8][2t+8..2t+9]
//   B (16x8, "col"): two .b32 registers, k-contiguous pairs:
//     b0 = B[2t..2t+1][g]     b1 = B[2t+8..2t+9][g]
//   C/D (16x8 fp32): c0,c1 = C[g][2t..2t+1]   c2,c3 = C[g+8][2t..2t+1]
// So a tile stored row-major with k contiguous feeds A, and a tile stored
// as [n][k] (k contiguous) feeds B, each register being one aligned 32-bit
// shared-memory load.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sdk {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one aligned 32-bit load of two neighbouring bf16 values
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows [r0, r0+16) and columns [c0, c0+16) of a row-major
// bf16 tile with row stride `ld` (elements).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base,
                                       int ld, int r0, int c0, int g, int t) {
  const bf16* p = base + (r0 + g) * ld + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// two fp32 values rounded to bf16 and packed low-first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void st32(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

// B fragments of two neighbouring n8 tiles read with `ldmatrix .trans` from
// a k16 slab stored row-major as [k][n] (n contiguous), so a product whose
// B operand lies that way needs no transposed copy. Lane l passes the
// address of slab row (l & 15), columns n0 + 8 * (l >> 4) (16-byte
// aligned); b[0], b[1] are then the b0, b1 of n tile n0 and b[2], b[3]
// those of n tile n0 + 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&b)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

}  // namespace sdk

// Host side: a launch that needs more than 48 KB of dynamic shared memory
// must raise the kernel's limit first; both calls report through the
// return code the C entry points hand back to Python.
#define SDK_SET_SMEM(kernel, bytes)                                          \
  do {                                                                       \
    cudaError_t _e = cudaFuncSetAttribute(                                   \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(bytes));  \
    if (_e != cudaSuccess) return (int)_e;                                   \
  } while (0)
