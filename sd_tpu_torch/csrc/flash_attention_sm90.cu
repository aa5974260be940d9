// Flash-attention inference forward for Hopper at head dims up to 128
// (bf16 in, bf16 out, fp32 softmax state): warpgroup products (wgmma) on
// tiles that arrive by TMA.
//
// Replaces, at the UNet's head dims, the TPU kernels `_flash_kernel`
// (sd_tpu/kernels/flash_attention.py:66, the [B*H, S, D] forward behind
// `flash_attention`) and `_flash_hpacked_kernel` (:293, the projection-native
// [B, S, H*D] forward behind `flash_attention_hpacked`), both read here
// through strided [B, S, H, D] views (head stride D and row stride H*D for a
// head-packed projection), serial sweep, with the fp32 exponential or the
// bf16 one (EXPB, `p_dtype = bfloat16`: exp(bf16(bf16(x) * bf16(ln 2))) in
// fp32, as XLA lowers jnp.exp2 on a bf16 operand). The pipelined sweep, the
// int8 PV product, the LSE forward and head dims above 128 stay on
// `flash_attention.cu`.
//
// Math (the TPU kernel's): non-causal softmax(q k^T * scale) v in base 2
// (log2(e) folded into the scale), running max m, running sum l and the
// output accumulator in fp32, p rounded to bf16 before the p v product, kv
// columns past Skv masked out, the output divided by max(l, 1e-30). Two
// roundings differ from the TPU kernel's: s * scale - m is one FFMA, and
// 2^x is ex2.approx (2 ulp).
//
// What bounds it on the H100: at the UNet shapes the work is 4*S^2*d
// tensor-core flops and S^2 exponentials per head against 8*S*d bytes, far
// above the ridge. At d = 80 the tensor-core products bound it (989 TFLOP/s);
// at d = 40 the exponentials do: one exp2 per 4*d = 160 flops, and the
// special-function units give ~3.9e12 results/s (16 per clock per SM), so
// the exponentials alone take 1.6x the products' time.
// What the design does about it:
//   * a block of two warpgroups owns 128 q rows, 64 each; S = Q K^T is one
//     wgmma m64n{BK}k16 chain per warpgroup with Q and K from shared memory,
//     and S stays in the accumulators: row max and row sum are quad shuffles
//     (each row lives in 4 lanes), the exponentials are taken in place;
//   * P never leaves the registers: the accumulator layout of two
//     neighbouring n8 column groups is the register-A layout of one k16
//     step, so O += P V is wgmma with A from registers and B = V from shared
//     memory in the transposed (MN-major) mode, no transposed copy of V;
//   * K and V tiles arrive by TMA into a 4-stage ring, each stage with a
//     "full" mbarrier (transaction bytes) and an "empty" one (one arrival
//     per warp); thread 0 refills the stage of tile j - 2 at step j, so the
//     two warpgroups drift apart freely and one's softmax runs under the
//     other's products, with no block-wide barrier in the sweep;
//   * tiles sit in shared memory in the no-swizzle core-matrix layout (8
//     columns x R rows x 16 bytes per chunk): each TMA box is one 8-column
//     chunk of R rows of a 4-D view (d, s and h by stride, b), so a
//     head-packed row's next head is never read; the head dim is padded to
//     a multiple of 16 (40 -> 48: one chunk of zeros, written once), which
//     costs the products 20% at d = 40 and nothing in exponentials;
//   * BK = 128 kv rows per step at d <= 48 (fewer row reductions and O
//     rescales per exponential), 64 above (registers); the O rescale is
//     skipped where no row of the warp moved its max.
// A ping-pong schedule of the two warpgroups' products (named barriers)
// and 1-block-per-warpgroup layouts were tried and not kept (PERF.md).
#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace {

using sdk::bf16;

constexpr int BQ = 128;        // q rows per block: two warpgroups of 64
constexpr int STAGES = 4;      // K/V ring depth
constexpr int THREADS = 256;

template <int DP>
struct Cfg90 {
  static constexpr int BK = DP <= 48 ? 128 : 64;      // kv rows per step
  static constexpr int MINB = DP <= 80 ? 2 : 1;       // blocks per SM
  static constexpr int TILE = BK * DP;                // elements of a K or V tile
  static constexpr size_t SMEM =
      (size_t)(BQ * DP + STAGES * 2 * TILE) * 2 + (2 * STAGES + 1) * 8;
  static_assert(DP % 16 == 0 && DP <= 128, "head tiling");
};

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// wgmma: D (fp32, 64 x N per warpgroup) += A (64 x 16) * B (16 x N). The
// accumulator of thread (warp w, lane 4g + t) holds rows 16w + g and + 8,
// columns 8i + 2t and + 1 of each n8 group i (d[4i .. 4i + 3]); a register
// A operand is the mma.sync m16n8k16 A fragment of the warp's 16 rows.

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // D[64x16] += A[64x16] (registers) * B[16x16] (shared, MN-major)
  __device__ static void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
        "}\n"
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
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
        "}\n"
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
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23},"
        " {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<64> {
  // D[64x64] += A[64x16] (registers) * B[16x64] (shared, MN-major)
  __device__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
        : "memory");
  }
  // D[64x64] (+)= A[64x16] (shared, K-major) * B[16x64] (shared, K-major)
  __device__ static void ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate)
        : "memory");
  }
};

template <>
struct Wgmma<80> {
  // D[64x80] += A[64x16] (registers) * B[16x80] (shared, MN-major)
  __device__ static void rs(float (&d)[40], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39},"
        " {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<96> {
  // D[64x96] += A[64x16] (registers) * B[16x96] (shared, MN-major)
  __device__ static void rs(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47},"
        " {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<112> {
  // D[64x112] += A[64x16] (registers) * B[16x112] (shared, MN-major)
  __device__ static void rs(float (&d)[56], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55},"
        " {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<128> {
  // D[64x128] += A[64x16] (registers) * B[16x128] (shared, MN-major)
  __device__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
        : "memory");
  }
  // D[64x128] (+)= A[64x16] (shared, K-major) * B[16x128] (shared, K-major)
  __device__ static void ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate)
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
// K-major operands (Q, K): lbo = the chunk stride (R * 16), sbo = 8 rows
// (128). MN-major V (N = head dim): lbo = 8 kv rows (128), sbo = the chunk
// stride (BK * 16).
__device__ __forceinline__ uint64_t gmma_desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
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
// generic-proxy writes (the zeroed pad chunks) made visible to TMA and wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(b)), "r"(count));
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

// A tensor map over a strided [B, S, H, D] view as 4-D (d, then s and h in
// order of stride, b), boxes of 8 columns x R rows of one head; `hfirst`
// says h comes before s.
struct ViewMap {
  CUtensorMap map;
  int hfirst;
};

template <int DP, bool EXPB>
__global__ void __launch_bounds__(THREADS, Cfg90<DP>::MINB)
flash_fwd_sm90_kernel(const __grid_constant__ ViewMap mq, const __grid_constant__ ViewMap mk,
                      const __grid_constant__ ViewMap mv, bf16* __restrict__ o, int H, int Sq,
                      int Skv, int D, long long o_sb, long long o_ss, long long o_sh,
                      float scale_log2) {
  using C = Cfg90<DP>;
  constexpr int BK = C::BK, TILE = C::TILE, ST = STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KV = Qs + BQ * DP;                    // stage i: K at KV + 2i*TILE, V after
  uint64_t* full = reinterpret_cast<uint64_t*>(KV + ST * 2 * TILE);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int dv = D / 8;
  const int n_kv = (Skv + BK - 1) / BK;
  bf16* ob = o + b * o_sb + h * o_sh;

  // pad chunks [D/8, DP/8) of every tile, zeroed once (no copy writes them;
  // Q K^T reads them)
  const int padc = (DP - D) / 8;
  for (int idx = tid; idx < padc * BQ; idx += THREADS) {
    const int c = dv + idx / BQ, r = idx % BQ;
    *reinterpret_cast<uint4*>(Qs + c * BQ * 8 + r * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int idx = tid; idx < padc * BK * 2 * ST; idx += THREADS) {
    const int tile = idx / (padc * BK), rem = idx % (padc * BK);
    const int c = dv + rem / BK, r = rem % BK;
    *reinterpret_cast<uint4*>(KV + tile * TILE + c * BK * 8 + r * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, THREADS / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_smem();
  __syncthreads();

  // rows [r0, r0 + R) of this head of a view, one TMA box per 8-column chunk
  // (rows past the end arrive as zeros)
  auto load = [&](const ViewMap& m, bf16* dst, int R, int r0, uint64_t* bar) {
    for (int c = 0; c < dv; ++c)
      tma_load_4d(dst + c * R * 8, &m.map, 8 * c, m.hfirst ? h : r0, m.hfirst ? r0 : h, b, bar);
  };
  auto issue_kv = [&](int j) {
    bf16* Ks = KV + (j % ST) * 2 * TILE;
    mbar_expect_tx(full + j % ST, 2u * dv * BK * 16);
    load(mk, Ks, BK, j * BK, full + j % ST);
    load(mv, Ks + TILE, BK, j * BK, full + j % ST);
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, (uint32_t)dv * BQ * 16);
    load(mq, Qs, BQ, q0, qbar);
    for (int j = 0; j < ST && j < n_kv; ++j) issue_kv(j);
  }

  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  uint32_t a[BK / 16][4];
  float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;   // rows g and g + 8
  mbar_wait(qbar, 0);

  for (int j = 0; j < n_kv; ++j) {
    // refill the stage tile j - 2 used, once every warp is done with it
    if (tid == 0 && j >= 2 && j - 2 + ST < n_kv) {
      mbar_wait(empty + (j - 2) % ST, ((j - 2) / ST) & 1);
      issue_kv(j - 2 + ST);
    }
    __syncwarp();
    mbar_wait(full + j % ST, (j / ST) & 1);
    const bf16* Ks = KV + (j % ST) * 2 * TILE;
    const bf16* Vs = Ks + TILE;

    // ---- S = Q K^T: this warpgroup's 64 rows x BK ----------------------------
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<BK>::ss(s, gmma_desc(Qs + cm_off<BQ>(64 * wg, 16 * kk), BQ * 16, 128),
                    gmma_desc(Ks + cm_off<BK>(0, 16 * kk), BK * 16, 128), kk > 0);
    wg_commit();
    wg_wait_all();

    // ---- online softmax: the max over the raw logits (the scale is
    // positive), the ragged last tile's columns past Skv at -inf, and
    // x = s * scale - m in one FFMA ---------------------------------------------
    const int valid = Skv - j * BK;
    if (valid < BK) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if ((i >> 2) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 4) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[i], s[i + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[i + 2], s[i + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2);
    const float mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
    const float c_lo = fast_exp2(m_lo - mn_lo), c_hi = fast_exp2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float x = fmaf(s[i], scale_log2, -((i & 2) ? mn_hi : mn_lo));
      s[i] = EXPB ? exp2_bf16(x) : fast_exp2(x);
      if (i & 2)
        sum_hi += s[i];
      else
        sum_lo += s[i];
    }
    // the row sum is kept per lane and folded across the quad at the end
    l_lo = c_lo * l_lo + sum_lo;
    l_hi = c_hi * l_hi + sum_hi;
    if (__any_sync(0xffffffffu, c_lo != 1.f || c_hi != 1.f)) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) oacc[i] *= (i & 2) ? c_hi : c_lo;
    }

    // ---- O += P V: P (bf16) from the registers, V MN-major from shared memory
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      a[kk][0] = sdk::pack_bf16(s[8 * kk], s[8 * kk + 1]);
      a[kk][1] = sdk::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = sdk::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = sdk::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<DP>::rs(oacc, a[kk], gmma_desc(Vs + cm_off<BK>(16 * kk, 0), 128, BK * 16));
    wg_commit();
    wg_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + j % ST);
  }

  // ---- l across the quad, O / l, bf16, strided store -------------------------
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  const int r_lo = q0 + 64 * wg + 16 * wl + g, r_hi = r_lo + 8;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (col < D) {
      if (r_lo < Sq)
        sdk::st32(ob + (long long)r_lo * o_ss + col, oacc[4 * nt] * inv_lo,
                  oacc[4 * nt + 1] * inv_lo);
      if (r_hi < Sq)
        sdk::st32(ob + (long long)r_hi * o_ss + col, oacc[4 * nt + 2] * inv_hi,
                  oacc[4 * nt + 3] * inv_hi);
    }
  }
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
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
int make_view_map(ViewMap* m, const bf16* base, int B, int S, int H, int D, long long sb,
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

template <int DP, bool EXPB>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int Sq,
           int Skv, int D, const long long* st, float scale_log2, cudaStream_t stream) {
  using C = Cfg90<DP>;
  ViewMap mq, mk, mv;
  int e = make_view_map(&mq, q, B, Sq, H, D, st[0], st[1], st[2], BQ);
  if (!e) e = make_view_map(&mk, k, B, Skv, H, D, st[3], st[4], st[5], C::BK);
  if (!e) e = make_view_map(&mv, v, B, Skv, H, D, st[6], st[7], st[8], C::BK);
  if (e) return e;
  auto kern = flash_fwd_sm90_kernel<DP, EXPB>;
  SDK_SET_SMEM(kern, C::SMEM);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, C::SMEM, stream>>>(mq, mk, mv, o, H, Sq, Skv, D, st[9], st[10], st[11],
                                           scale_log2);
  return (int)cudaGetLastError();
}

template <bool EXPB>
int fwd(const bf16* Q, const bf16* K, const bf16* V, bf16* O, int B, int H, int Sq, int Skv,
        int D, const long long* strides, float scale_log2, cudaStream_t s) {
  switch ((D + 15) / 16 * 16) {
#define SDK_DP(DPV) \
  case DPV:         \
    return launch<DPV, EXPB>(Q, K, V, O, B, H, Sq, Skv, D, strides, scale_log2, s);
    SDK_DP(16)
    SDK_DP(32)
    SDK_DP(48)
    SDK_DP(64)
    SDK_DP(80)
    SDK_DP(96)
    SDK_DP(112)
    SDK_DP(128)
#undef SDK_DP
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [B, S, H, D] bf16 views with unit stride along D, D a multiple
// of 8 up to 128, 16-byte aligned, strides multiples of 8 elements; `strides`
// holds (batch, row, head) strides in elements for q, k, v, o in that order.
// exp_bf16 = 1 takes the bf16 softmax exponential. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int sd_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                 int B, int H, int Sq, int Skv, int D,
                                 const long long* strides, float scale_log2, int exp_bf16,
                                 void* stream) {
  if (D % 8 || D > 128 || D <= 0) return (int)cudaErrorInvalidValue;
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return exp_bf16 ? fwd<true>(Q, K, V, O, B, H, Sq, Skv, D, strides, scale_log2, s)
                  : fwd<false>(Q, K, V, O, B, H, Sq, Skv, D, strides, scale_log2, s);
}

// Dynamic shared memory (bytes) of the launch for head dim D (the build report).
extern "C" int sd_flash_fwd_sm90_smem(int D) {
  switch ((D + 15) / 16 * 16) {
    case 16: return (int)Cfg90<16>::SMEM;
    case 32: return (int)Cfg90<32>::SMEM;
    case 48: return (int)Cfg90<48>::SMEM;
    case 64: return (int)Cfg90<64>::SMEM;
    case 80: return (int)Cfg90<80>::SMEM;
    case 96: return (int)Cfg90<96>::SMEM;
    case 112: return (int)Cfg90<112>::SMEM;
    case 128: return (int)Cfg90<128>::SMEM;
    default: return -1;
  }
}
