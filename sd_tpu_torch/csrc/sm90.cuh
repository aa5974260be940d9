// Hopper building blocks shared by the kernels written for sm_90a (the
// flash-attention forwards `flash_attention_sm90.cu`,
// `flash_attention_sm90_pv8.cu`, `flash_attention_wide.cu` and the direct
// 3x3 conv `conv2d_sm90.cu`): warpgroup products (wgmma, bf16 and int8),
// shared-memory matrix descriptors in the no-swizzle core-matrix layout,
// mbarriers, TMA tile loads over strided [B, S, H, D] views and NHWC
// windows, 1-D bulk copies, named barriers, and the int8 PV pre-pass
// that writes V's column scales and codes once per kv super-tile.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace {

using sdk::bf16;

// sd_tpu's jnp.exp2 on a bf16 operand: exp(bf16(bf16(x) * bf16(ln2))), in fp32
__device__ __forceinline__ float exp2_bf16(float x) {
  const float xb = __bfloat162float(__float2bfloat16_rn(x));
  return expf(__bfloat162float(__float2bfloat16_rn(__fmul_rn(xb, 0.69140625f))));
}

// 2^x on the special-function unit (ex2.approx, 2 ulp; results below 2^-126
// flush to 0, where they add nothing to a row sum of at least 1)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p_i8 = trunc(p * 127 + 0.5) (`_pv_int8`, p in [0, 1]) in the low byte of
// the result, with no float-to-int conversion: 2^23 + t rounded toward zero
// is 2^23 + trunc(t) for 0 <= t < 2^23, whose low mantissa bits are trunc(t)
__device__ __forceinline__ uint32_t q8_bits(float p) {
  return __float_as_uint(__fadd_rz(__fadd_rn(__fmul_rn(p, 127.f), 0.5f), 8388608.f));
}

// four p_i8 packed into one register, the first in the low byte
__device__ __forceinline__ uint32_t pack_q8(float p0, float p1, float p2, float p3) {
  return __byte_perm(__byte_perm(q8_bits(p0), q8_bits(p1), 0x0040),
                     __byte_perm(q8_bits(p2), q8_bits(p3), 0x0040), 0x5410);
}

// the k32 int8 A fragments of a warpgroup's P from its fp32 accumulator
// values p = s[0 .. 16 * KS) (exponentials taken, KS k32 steps): logical k
// 4t .. 4t + 3 of each 16 columns holds columns 2t, 2t + 1, 8 + 2t, 9 + 2t
// (the permutation the V codes carry, `perm16`); the integer row sums of
// p_i8 (rows g and g + 8) are added to isum_lo and isum_hi
template <int KS>
__device__ __forceinline__ void pack_p_i8(uint32_t (&a)[KS][4], const float* s, int& isum_lo,
                                          int& isum_hi) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const float* p = s + 16 * kk;
    a[kk][0] = pack_q8(p[0], p[1], p[4], p[5]);
    a[kk][1] = pack_q8(p[2], p[3], p[6], p[7]);
    a[kk][2] = pack_q8(p[8], p[9], p[12], p[13]);
    a[kk][3] = pack_q8(p[10], p[11], p[14], p[15]);
    isum_lo = __dp4a((int)a[kk][0], 0x01010101, __dp4a((int)a[kk][2], 0x01010101, isum_lo));
    isum_hi = __dp4a((int)a[kk][1], 0x01010101, __dp4a((int)a[kk][3], 0x01010101, isum_hi));
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// wgmma: D (64 x N per warpgroup) += A * B. The accumulator of thread (warp
// w, lane 4g + t), fp32 or int32, holds rows 16w + g and + 8, columns 8i + 2t
// and + 1 of each n8 group i (d[4i .. 4i + 3]). A register A operand is the
// mma.sync A fragment of the warp's 16 rows: bf16 k16 (m16n8k16: row g
// columns 2t, 2t + 1 | row g + 8 | row g, + 8 | row g + 8, + 8) or int8 k32
// (m16n8k32: row g columns 4t .. 4t + 3 | row g + 8 | row g, + 16 |
// row g + 8, + 16), four values per register, the lowest k in the low bits.

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // D[64x16] += A[64x16] (registers) * B[16x16] (shared, MN-major)
  __device__ static void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7},"
                 " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
                 : "memory");
  }
};

template <>
struct Wgmma<32> {
  // D[64x32] += A[64x16] (registers) * B[16x32] (shared, MN-major)
  __device__ static void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
                 " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
                 : "memory");
  }
};

template <>
struct Wgmma<48> {
  // D[64x48] += A[64x16] (registers) * B[16x48] (shared, MN-major)
  __device__ static void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23},"
                 " {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
                   "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
                   "+f"(d[22]), "+f"(d[23])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
                 : "memory");
  }
};

template <>
struct Wgmma<64> {
  // D[64x64] += A[64x16] (registers) * B[16x64] (shared, MN-major)
  __device__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
                 " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
                   "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
                   "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
                   "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
                 : "memory");
  }
  // D[64x64] (+)= A[64x16] (shared, K-major) * B[16x64] (shared, K-major)
  __device__ static void ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
                 " %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
                   "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
                   "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
                   "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
                 : "l"(desc_a), "l"(desc_b), "r"(accumulate)
                 : "memory");
  }
};

template <>
struct Wgmma<80> {
  // D[64x80] += A[64x16] (registers) * B[16x80] (shared, MN-major)
  __device__ static void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39},"
                 " {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
                   "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
                   "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
                   "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
                   "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
                 : "memory");
  }
};

template <>
struct Wgmma<96> {
  // D[64x96] += A[64x16] (registers) * B[16x96] (shared, MN-major)
  __device__ static void rs(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
                 "%47},"
                 " {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
                   "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
                   "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
                   "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
                   "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
                   "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
                   "+f"(d[47])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
                 : "memory");
  }
};

template <>
struct Wgmma<112> {
  // D[64x112] += A[64x16] (registers) * B[16x112] (shared, MN-major)
  __device__ static void rs(float (&d)[56], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
                 "%47, %48, %49, %50, %51, %52, %53, %54, %55},"
                 " {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
                   "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
                   "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
                   "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
                   "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
                   "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
                   "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
                   "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
                 : "memory");
  }
};

template <>
struct Wgmma<128> {
  // D[64x128] += A[64x16] (registers) * B[16x128] (shared, MN-major)
  __device__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
                 "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
                 "%62, %63},"
                 " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
                   "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
                   "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
                   "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
                   "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
                   "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
                   "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
                   "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
                   "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
                   "+f"(d[62]), "+f"(d[63])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
                 : "memory");
  }
  // D[64x128] (+)= A[64x16] (shared, K-major) * B[16x128] (shared, K-major)
  __device__ static void ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
                 "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
                 "%62, %63},"
                 " %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
                   "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
                   "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
                   "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
                   "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
                   "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
                   "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
                   "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
                   "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
                   "+f"(d[62]), "+f"(d[63])
                 : "l"(desc_a), "l"(desc_b), "r"(accumulate)
                 : "memory");
  }
};

template <>
struct Wgmma<256> {
  // D[64x256] += A[64x16] (registers) * B[16x256] (shared, MN-major)
  __device__ static void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
                 "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
                 "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76,"
                 "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91,"
                 "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104,"
                 "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116,"
                 "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
                 " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
                   "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
                   "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
                   "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
                   "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
                   "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                   "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
                   "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
                   "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
                   "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
                   "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
                   "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
                   "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
                   "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
                   "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
                   "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]),
                   "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]),
                   "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
                   "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
                   "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
                   "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
                   "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
                   "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
                   "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
                   "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
                   "+f"(d[127])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
                 : "memory");
  }
};

template <int N>
struct Wgmma8;

template <>
struct Wgmma8<16> {
  // D[64x16] (+)= A[64x32] (registers) * B[32x16] (shared, K-major), int32
  __device__ static void rs(int (&d)[8], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7},"
                 " {%8, %9, %10, %11}, %12, p;\n}\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
                   "+r"(d[6]), "+r"(d[7])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
                 : "memory");
  }
};

template <>
struct Wgmma8<32> {
  // D[64x32] (+)= A[64x32] (registers) * B[32x32] (shared, K-major), int32
  __device__ static void rs(int (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
                 " {%16, %17, %18, %19}, %20, p;\n}\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
                   "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
                   "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
                 : "memory");
  }
};

template <>
struct Wgmma8<48> {
  // D[64x48] (+)= A[64x32] (registers) * B[32x48] (shared, K-major), int32
  __device__ static void rs(int (&d)[24], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23},"
                 " {%24, %25, %26, %27}, %28, p;\n}\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
                   "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
                   "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
                   "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
                   "+r"(d[22]), "+r"(d[23])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
                 : "memory");
  }
};

template <>
struct Wgmma8<64> {
  // D[64x64] (+)= A[64x32] (registers) * B[32x64] (shared, K-major), int32
  __device__ static void rs(int (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
                 " {%32, %33, %34, %35}, %36, p;\n}\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
                   "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
                   "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
                   "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
                   "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
                   "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
                 : "memory");
  }
};

template <>
struct Wgmma8<80> {
  // D[64x80] (+)= A[64x32] (registers) * B[32x80] (shared, K-major), int32
  __device__ static void rs(int (&d)[40], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39},"
                 " {%40, %41, %42, %43}, %44, p;\n}\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
                   "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
                   "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
                   "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
                   "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
                   "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
                   "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
                   "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
                 : "memory");
  }
};

template <>
struct Wgmma8<96> {
  // D[64x96] (+)= A[64x32] (registers) * B[32x96] (shared, K-major), int32
  __device__ static void rs(int (&d)[48], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
                 "%47},"
                 " {%48, %49, %50, %51}, %52, p;\n}\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
                   "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
                   "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
                   "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
                   "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
                   "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
                   "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
                   "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
                   "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]),
                   "+r"(d[47])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
                 : "memory");
  }
};

template <>
struct Wgmma8<112> {
  // D[64x112] (+)= A[64x32] (registers) * B[32x112] (shared, K-major), int32
  __device__ static void rs(int (&d)[56], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
                 "%47, %48, %49, %50, %51, %52, %53, %54, %55},"
                 " {%56, %57, %58, %59}, %60, p;\n}\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
                   "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
                   "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
                   "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
                   "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
                   "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
                   "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
                   "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
                   "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]),
                   "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
                   "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
                 : "memory");
  }
};

template <>
struct Wgmma8<128> {
  // D[64x128] (+)= A[64x32] (registers) * B[32x128] (shared, K-major), int32
  __device__ static void rs(int (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
                 "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
                 "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
                 "%62, %63},"
                 " {%64, %65, %66, %67}, %68, p;\n}\n"
                 : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
                   "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
                   "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
                   "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
                   "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
                   "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
                   "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
                   "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
                   "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]),
                   "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
                   "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
                   "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
                   "+r"(d[62]), "+r"(d[63])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate)
                 : "memory");
  }
};

// element offset of (row r, column c) in a core-matrix tile of R rows: 8-column
// chunks of R rows x 16 bytes, so each 8x8 core matrix is 128 contiguous bytes
template <int R>
__device__ __forceinline__ int cm_off(int r, int c) {
  return (c >> 3) * (R * 8) + r * 8 + (c & 7);
}

// shared-memory matrix descriptor, no swizzle: leading / stride byte offsets.
// K-major operands (Q, K, int8 V codes): lbo = the 16-byte chunk stride
// along K (R * 16), sbo = 8 rows (128). MN-major V (N = head dim): lbo = 8
// kv rows (128), sbo = the chunk stride (BK * 16).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the most recent committed group of products done
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// generic-proxy writes (zeroed pad chunks) made visible to TMA and wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier of `count` threads (a multiple of 32) on hardware barrier `id`
// (0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(b)), "r"(count));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  uint32_t ok;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(a), "r"(parity) : "memory");
  } while (!ok);
}
// one box of a 4-D tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
// `bytes` (a multiple of 16) of contiguous global memory into shared memory,
// counted on `bar`; both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(smem_u32(bar))
      : "memory");
}

// A tensor map over a strided [B, S, H, D] view as 4-D (d, then s and h in
// order of stride, b), boxes of 8 columns x R rows of one head; `hfirst`
// says h comes before s.
struct ViewMap {
  CUtensorMap map;
  int hfirst;
};

// TMA boxes of rows [r0, r0 + R) of head (b, h) of a view, one per 8-column
// chunk, chunks c = c0, c0 + step, ... below dv, into a core-matrix tile of
// R rows (rows past the end arrive as zeros)
__device__ __forceinline__ void load_rows_tma(const ViewMap& m, bf16* dst, int R, int r0, int b,
                                              int h, int dv, int c0, int step, uint64_t* bar) {
  for (int c = c0; c < dv; c += step)
    tma_load_4d(dst + c * R * 8, &m.map, 8 * c, m.hfirst ? h : r0, m.hfirst ? r0 : h, b, bar);
}

inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// the tensor map of a strided [B, S, H, D] bf16 view (strides in elements),
// boxes of 8 columns x `rows` rows of one head; 0 or an error code
inline int make_view_map(ViewMap* m, const bf16* base, int B, int S, int H, int D, long long sb,
                         long long ss, long long sh, int rows) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  m->hfirst = sh <= ss;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)(m->hfirst ? H : S),
                              (cuuint64_t)(m->hfirst ? S : H), (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(m->hfirst ? sh : ss) * 2,
                                 (cuuint64_t)(m->hfirst ? ss : sh) * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {8u, m->hfirst ? 1u : (cuuint32_t)rows,
                             m->hfirst ? (cuuint32_t)rows : 1u, 1u};
  const cuuint32_t estr[4] = {1u, 1u, 1u, 1u};
  const CUresult r = encode(&m->map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<bf16*>(base), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The input tensor map of the direct 3x3 conv (`conv2d_sm90.cu`); 0 or an
// error code. It reads a contiguous NHWC [B, H, W, C] bf16 tensor as
// 4-D (c, x, y, b) in boxes of 8 channels x `box_w` pixels x `box_h` rows:
// each pixel's 8 channels land as 16 contiguous bytes, pixel after pixel and
// row after row, and coordinates outside the image (-1 included) arrive as
// zeros, so one box is a zero-padded window with its halo.
inline int make_nhwc_window_map(CUtensorMap* m, const bf16* x, int B, int H, int W, int C,
                                int box_w, int box_h) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {8u, (cuuint32_t)box_w, (cuuint32_t)box_h, 1u};
  const cuuint32_t estr[4] = {1u, 1u, 1u, 1u};
  const CUresult r = encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(x), dims,
                            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The int8 PV pre-pass (the TPU kernels' `_pv_int8`, V's half). Per T-row kv
// super-tile st and head bh, over rows [st*T, min(st*T + T, Skv)):
//   vs = max|v| / 127 per head-dim column, v_i8 = round-half-even(v / max(vs,
//   1e-30)); vmul[bh][st][c] = vs / 127 (the factor of the int32 product),
//   0 on pad columns;
//   codes: for each 16-row kv group, DP rows (head-dim columns, zeros past D)
//   of 16 bytes, so the tile of kv rows [r, r + BK) at byte
//   (bh * n_st * T + r) * DP is the K-major core-matrix layout of the B
//   operand (V_i8^T) of an int8 wgmma, whatever BK; within a group, byte p of
//   a row holds kv row perm16(p) (zeros past Skv).
// perm16 matches the order in which a thread finds its P values in an fp32
// accumulator (columns 2t, 2t + 1, 8 + 2t, 9 + 2t of each 16) to the order the
// int8 A fragment wants them (k = 4t .. 4t + 3), so P is packed in registers
// with no shuffle; the contraction does not depend on the order.
__host__ __device__ constexpr int perm16(int p) {
  return ((p & 2) << 2) | ((p >> 2) << 1) | (p & 1);
}

template <int DP>
__global__ void __launch_bounds__(256)
v_codes_kernel(const bf16* __restrict__ v, int8_t* __restrict__ codes, float* __restrict__ vmul,
               int H, int Skv, int D, int T, long long v_sb, long long v_ss, long long v_sh) {
  __shared__ unsigned colmax[DP];   // max|v| per column as bits (non-negative floats order as ints)
  __shared__ float den[DP];
  const int st = blockIdx.x, n_st = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const int r0 = st * T, r1 = min(r0 + T, Skv);
  const int ncg = D / 8;            // 8-column groups, one 16-byte load each
  for (int c = threadIdx.x; c < DP; c += 256) colmax[c] = 0u;
  __syncthreads();
  // the column max: thread (row phase, 8-column group) over the super-tile's rows
  const int phases = 256 / ncg;
  if (threadIdx.x < phases * ncg) {
    const int cg = threadIdx.x % ncg;
    float mx[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = r0 + threadIdx.x / ncg; r < r1; r += phases) {
      const uint4 u = *reinterpret_cast<const uint4*>(vb + (long long)r * v_ss + 8 * cg);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) mx[j] = fmaxf(mx[j], fabsf(__bfloat162float(e[j])));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) atomicMax(&colmax[8 * cg + j], __float_as_uint(mx[j]));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < DP; c += 256) {
    const float vs = __uint_as_float(colmax[c]) / 127.f;
    den[c] = fmaxf(vs, 1e-30f);
    vmul[((long long)bh * n_st + st) * DP + c] = vs / 127.f;
  }
  __syncthreads();
  // the codes: thread (16-row group, 8-column group) reads the group's rows
  // in perm16 order and writes 16 bytes for each of its 8 columns
  int8_t* out = codes + ((long long)bh * n_st * T + r0) * DP;
  for (int idx = threadIdx.x; idx < (T / 16) * ncg; idx += 256) {
    const int cc = idx / ncg, cg = idx - cc * ncg;
    float dn[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) dn[j] = den[8 * cg + j];
    uint32_t w[8][4] = {};
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int r = r0 + 16 * cc + perm16(p);
      if (r < Skv) {
        const uint4 u = *reinterpret_cast<const uint4*>(vb + (long long)r * v_ss + 8 * cg);
        const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int q = __float2int_rn(__bfloat162float(e[j]) / dn[j]);
          w[j][p >> 2] |= (uint32_t)(q & 0xff) << (8 * (p & 3));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint4*>(out + (long long)cc * DP * 16 + (8 * cg + j) * 16) =
          make_uint4(w[j][0], w[j][1], w[j][2], w[j][3]);
  }
  // zero codes for the pad columns [D, DP)
  for (int idx = threadIdx.x; idx < (T / 16) * (DP - D); idx += 256) {
    const int cc = idx / (DP - D), d = D + idx % (DP - D);
    *reinterpret_cast<uint4*>(out + (long long)cc * DP * 16 + d * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// the pre-pass launch over a [B, S, H, D] view (v strides in elements)
template <int DP>
int launch_v_codes(const bf16* v, int8_t* codes, float* vmul, int B, int H, int Skv, int D,
                   int T, const long long* v_st, cudaStream_t stream) {
  const int n_st = (Skv + T - 1) / T;
  v_codes_kernel<DP><<<dim3(n_st, B * H), 256, 0, stream>>>(v, codes, vmul, H, Skv, D, T,
                                                            v_st[0], v_st[1], v_st[2]);
  return (int)cudaGetLastError();
}

}  // namespace
