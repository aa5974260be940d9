// GroupNorm -> SiLU -> 3x3 SAME convolution for Hopper over NHWC bf16
// activations: y = conv3x3(bf16(silu(x * a + c))) + bias with zero padding,
// where a = rsqrt(var + eps) * scale and c = gn_bias - mean * a per (batch
// row, channel) fold GroupNorm's fp32 statistics and affine. The normalized
// tensor never reaches device memory.
//
// Replaces the TPU kernel `_conv3x3_prologue_kernel` (sd_tpu/kernels/
// conv2d.py:38, impl :51, behind `gn_silu_conv3x3` :315), which transforms
// each DMA'd window in VMEM and re-zeroes its SAME halo, and the statistics
// it takes from `_gn_stats_affine` (:297, one XLA reduction over x). No model
// path calls it, in sd_tpu or here: sd_tpu/nn/resnet.py records that wiring
// it measured neutral for decode on the TPU.
//
// What bounds it on the H100: the conv's tensor operations, 18 * C * O
// flops a pixel (0.313 ms at [2, 256^2, 512 -> 256]); the statistics need a
// whole read of x before the first output (0.040 ms there at 3.35 TB/s).
// Fusing can save at most the normalized tensor's write and read, about
// 0.08 ms at that shape: some 10% of the conv.
// What the design does about it:
//   * the statistics pass reads x once in two launches, with no atomics, so
//     its bits are the same every run. Blocks of 256 threads: a thread sums
//     8 channels over 32 pixels in order (8 16-byte loads in flight), then a
//     block adds its pixel lanes in order and each group's channels in
//     order into per-(batch row, block, group) partials. A finalize launch,
//     one warp per batch row and group, adds the blocks' partials (strided
//     over the lanes in order, then a fixed shuffle tree) and writes a and
//     c. `kernels/conv2d.py _gn_stats_tiled_ref` follows that order;
//   * the conv is `conv2d_sm90.cu`'s (`conv3x3_sm90.cuh`): the 4-D window
//     map, the 4-stage ring of 16-channel chunks with full and empty
//     mbarriers, the packed weights by bulk copy, two consumer warpgroups of
//     wgmma m64n128k16 over 2 rows x 128 pixels x 128 output channels. Each
//     stage also takes its chunk's 16 values of a and of c (128 bytes);
//   * two transform warpgroups take each chunk as it lands and rewrite its
//     window in place, one 8-channel box (4 rows x 130 pixels) each: once per
//     value, not per tap, bf16(silu(x * a + c)) in fp32 (one ex2 and one rcp
//     on the SFU), and 0 outside the image (TMA fills the halo with zeros,
//     but silu(c) is not 0). A proxy fence, then a third mbarrier ("ready",
//     one arrival a thread) hands the stage to the consumers, which return it
//     to the producer after its products as before. The producer warpgroup
//     and the transform warpgroups give their registers to the consumers
//     (setmaxnreg 24 / 56 / 168; 640 threads enter with 96);
//   * why apart: the window's 8,320 values a chunk cost about as long as the
//     chunk's products (the transform alone ran at ~1.5 us a chunk on an H100
//     beside 1.7 us of products), and in the consumer warpgroups, between a
//     chunk's landing and its first product, the two overlapped little: that
//     form took 0.76 ms at [2, 256^2, 512 -> 256] against 0.64 here (PERF.md);
//   * at O > 128 each of a window's O / 128 blocks transforms it again (4x
//     at O = 512).
// The `PRO` form of `conv2d.cu` stays as this kernel's yardstick.
#include "conv3x3_sm90.cuh"

namespace {

constexpr int ST_THREADS = 256;   // threads of a statistics block
constexpr int ST_STEPS = 32;      // pixels a thread sums, in order

// threads across one pixel's 8-channel vectors (the rest of a block's
// threads are its pixel lanes: ST_THREADS / vpl)
__host__ __device__ inline int stats_vpl(int C) {
  return C / 8 < ST_THREADS ? C / 8 : ST_THREADS;
}

// dynamic shared memory of a statistics block: [lanes][C] (sum, sum of squares)
__host__ __device__ inline int stats_smem(int C) {
  return (ST_THREADS / stats_vpl(C)) * C * 8;
}

// block (p, b): pixels [p * lanes * ST_STEPS, + lanes * ST_STEPS) of batch
// row b; thread (lane, v) sums pixels lane, lane + lanes, ... (ST_STEPS of
// them, zeros past HW) of its 8-channel vectors v, v + vpl, ...
__global__ void __launch_bounds__(ST_THREADS)
gnc_partials_kernel(const bf16* __restrict__ x, float2* __restrict__ part, int HW, int C,
                    int G) {
  extern __shared__ float2 red[];   // [lanes][C]; row 0 then holds the block's sums
  const int cv = C / 8, vpl = stats_vpl(C), lanes = ST_THREADS / vpl;
  const int tid = threadIdx.x, lane = tid / vpl, v0 = tid - lane * vpl;
  const int p = blockIdx.x, P = gridDim.x, b = blockIdx.y;
  const bf16* xb = x + (long long)b * HW * C;
  const long long px0 = (long long)p * lanes * ST_STEPS + lane;
  if (lane < lanes) {
    for (int v = v0; v < cv; v += vpl) {
      float s[8], q[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) s[u] = q[u] = 0.f;
      for (int k0 = 0; k0 < ST_STEPS; k0 += 8) {
        uint4 raw[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const long long px = px0 + (long long)(k0 + j) * lanes;
          raw[j] = px < HW ? __ldg(reinterpret_cast<const uint4*>(xb + px * C + 8 * v))
                           : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bf16* e = reinterpret_cast<const bf16*>(&raw[j]);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const float f = __bfloat162float(e[u]);
            s[u] += f;
            q[u] += f * f;   // exact in fp32: f has 8 significant bits
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) red[lane * C + 8 * v + u] = make_float2(s[u], q[u]);
    }
  }
  __syncthreads();
  // each channel over the block's lanes, in order
  for (int c = tid; c < C; c += ST_THREADS) {
    float2 t = red[c];
    for (int l = 1; l < lanes; ++l) {
      const float2 r = red[l * C + c];
      t.x += r.x;
      t.y += r.y;
    }
    red[c] = t;
  }
  __syncthreads();
  // each group over its channels, in order
  const int cg = C / G;
  for (int gg = tid; gg < G; gg += ST_THREADS) {
    float2 t = red[gg * cg];
    for (int j = 1; j < cg; ++j) {
      const float2 r = red[gg * cg + j];
      t.x += r.x;
      t.y += r.y;
    }
    part[((long long)b * P + p) * G + gg] = t;
  }
}

// one warp per (b, g): the P blocks' partials, lane j adding blocks j, j + 32,
// ... in order, then a shuffle tree (offsets 16, 8, 4, 2, 1) into lane 0; the
// fast variance clamped at 0, a = rsqrt(var + eps) * scale and c = gn_bias -
// mean * a per channel, each operation rounded on its own (no contraction)
__global__ void __launch_bounds__(256)
gnc_finalize_kernel(const float2* __restrict__ part, const float* __restrict__ scale,
                    const float* __restrict__ gbias, float* __restrict__ ga,
                    float* __restrict__ gc, int B, int P, int HW, int C, int G, float eps) {
  const int wid = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (wid >= B * G) return;
  const int b = wid / G, g = wid - b * G, cg = C / G;
  float sx = 0.f, sy = 0.f;
#pragma unroll 8
  for (int p = lane; p < P; p += 32) {
    const float2 v = part[((long long)b * P + p) * G + g];
    sx += v.x;
    sy += v.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sx += __shfl_down_sync(0xffffffffu, sx, off);
    sy += __shfl_down_sync(0xffffffffu, sy, off);
  }
  sx = __shfl_sync(0xffffffffu, sx, 0);
  sy = __shfl_sync(0xffffffffu, sy, 0);
  const float n = (float)((long long)HW * cg);
  const float mean = __fdiv_rn(sx, n), mean2 = __fdiv_rn(sy, n);
  const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.f);
  const float rinv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  for (int j = lane; j < cg; j += 32) {
    const int ch = g * cg + j;
    const float av = __fmul_rn(rinv, scale[ch]);
    ga[(long long)b * C + ch] = av;
    gc[(long long)b * C + ch] = __fsub_rn(gbias[ch], __fmul_rn(mean, av));
  }
}

int stats_blocks(int HW, int C) {
  const int pixels = (ST_THREADS / stats_vpl(C)) * ST_STEPS;
  return (HW + pixels - 1) / pixels;
}

int launch_stats(const void* x, const float* scale, const float* gbias, float2* part, float* ga,
                 float* gc, int B, int HW, int C, int G, float eps, cudaStream_t s) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || C % 8 || G <= 0 || C % G)
    return (int)cudaErrorInvalidValue;
  const int P = stats_blocks(HW, C), smem = stats_smem(C);
  if (smem > 48 * 1024) SDK_SET_SMEM(gnc_partials_kernel, smem);
  gnc_partials_kernel<<<dim3(P, B), ST_THREADS, smem, s>>>(static_cast<const bf16*>(x), part,
                                                           HW, C, G);
  const int warps = B * G;
  gnc_finalize_kernel<<<(warps + 7) / 8, 256, 0, s>>>(part, scale, gbias, ga, gc, B, P, HW, C,
                                                      G, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// The statistics pass alone: x [B, H * W, C] contiguous 16-byte aligned
// bf16, scale and gn_bias [C] fp32; part scratch of B * blocks * G float2
// (`sd_gn_stats_sm90_blocks`); writes a and c [B, C] fp32. Needs C % 8 == 0
// and C % G == 0. The CUDA error code of the launches (0 on success).
extern "C" int sd_gn_stats_sm90(const void* x, const void* scale, const void* gbias, void* part,
                                void* a, void* c, int B, int HW, int C, int G, float eps,
                                void* stream) {
  return launch_stats(x, static_cast<const float*>(scale), static_cast<const float*>(gbias),
                      static_cast<float2*>(part), static_cast<float*>(a), static_cast<float*>(c),
                      B, HW, C, G, eps, static_cast<cudaStream_t>(stream));
}

// Statistics blocks per batch row at H * W pixels and C channels.
extern "C" int sd_gn_stats_sm90_blocks(int HW, int C) { return stats_blocks(HW, C); }

// The conv with the prologue, once the statistics pass has written a and c:
// the weights' pre-pass, then the conv. x [B, H, W, C], w [O, 3, 3, C],
// bias [O], y [B, H, W, O] contiguous bf16; a, c [B, C] fp32; wpack scratch
// of 9 * C * O bf16; x, w and wpack 16-byte aligned. Needs C % 32 == 0 and
// O % 128 == 0 (any H, W). The CUDA error code of the launches.
extern "C" int sd_gn_silu_conv3x3_fwd_sm90(const void* x, const void* w, const void* bias,
                                           const void* a, const void* c, void* y, void* wpack,
                                           int B, int H, int W, int C, int O, void* stream) {
  return launch_conv3x3_sm90<true>(x, w, bias, static_cast<const float*>(a),
                                   static_cast<const float*>(c), y, wpack, B, H, W, C, O,
                                   static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) of the conv launch (the build report).
extern "C" int sd_gn_silu_conv3x3_fwd_sm90_smem() { return (int)conv_smem(true); }
