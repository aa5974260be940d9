// Direct 3x3 SAME convolution for Hopper over NHWC bf16 activations:
// y[b, i, j, o] = bias[o] + sum_{dy, dx, c} x[b, i+dy-1, j+dx-1, c] * w[o, dy, dx, c]
// with zero padding, fp32 accumulation and one bf16 rounding of the output.
//
// Replaces the TPU kernel `_conv3x3_kernel` (sd_tpu/kernels/conv2d.py:30, impl
// :51, behind `conv3x3_same`), which streams input rows HBM->VMEM with the
// one-pixel halo assembled on chip and runs the 9 taps as 9 matmuls.
//
// What bounds it on the H100: at the VAE decoder shapes (128^2 x 512 -> 512,
// 256^2 x 512/256 -> 256, 512^2 x 256/128 -> 128) a conv does 18*C*O flops
// per output pixel against 2*(C + O) bytes, hundreds of flops per byte, so
// it is bound by operations on the tensor cores. The XLA lowering the TPU
// kernel replaced materialized im2col patches (9x the input traffic); this
// kernel never forms them.
// What the design does about it: implicit GEMM. A block computes a tile of
// TH x TW = 4 x 32 output pixels by TO = 128 output channels; the fp32
// accumulator lives in registers (8 warps x 16 pixels x 128 channels). For
// each chunk of KC = 32 input channels it loads the (TH+2) x (TW+2) input
// window, halo included, into shared memory, writing zeros for pixels
// outside the image (no padded copy in device memory), loads the chunk's
// 9 x TO x KC weights, and runs the 9 tap products as mma.sync m16n8k16 on
// the tensor cores. The input is read from device memory once per block
// (plus the halo); weights are re-read from L2 once per pixel tile. No
// cp.async/TMA pipelining or wgmma yet (later work).
//
// Weights are the torch OIHW tensor in channels_last memory format, i.e.
// physically [O][3][3][C]: each (tap, o) row is c-contiguous, which is the
// layout the B operand wants.
//
// Compiled with PRO = true the same kernel replaces `_conv3x3_prologue_kernel`
// (sd_tpu/kernels/conv2d.py:38, behind `gn_silu_conv3x3`): each input value
// of the window becomes bf16(silu(x * a[b, c] + c[b, c])) in fp32 as it lands
// in shared memory, where a and c ([B, C] fp32, computed outside the kernel)
// fold GroupNorm's statistics and affine. Pixels outside the image stay
// zeros, written after (instead of) the transform: silu(c) is not 0, so
// transforming the SAME halo would be wrong (the TPU kernel re-zeroes it).
// Its bound is the conv's (the prologue adds ~6 fp32 ops per input value,
// against 18 * O tensor-core flops); what it saves is the normalized
// tensor's write and read in device memory.
#include "common.cuh"

namespace {

using sdk::bf16;

constexpr int TH = 4, TW = 32;     // output pixels per block
constexpr int TO = 128;            // output channels per block
constexpr int KC = 32;             // input channels per chunk
constexpr int THREADS = 256;
constexpr int WH = TH + 2, WW = TW + 2;
constexpr int XS = KC + 8;         // row stride of a window pixel / weight row
constexpr int NT = TO / 8;         // n8 tiles per warp
constexpr size_t SMEM = (size_t)(WH * WW * XS + 9 * TO * XS) * 2;

template <bool PRO>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const bf16* __restrict__ bias, const float* __restrict__ pa,
               const float* __restrict__ pc, bf16* __restrict__ y, int H,
               int W, int C, int O) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Ws = Xs + WH * WW * XS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_w = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int o0 = blockIdx.y * TO;
  const int b = blockIdx.z;
  const bf16* xb = x + (long long)b * H * W * C;

  // this warp's 16 pixels: row ty of the tile, columns tx .. tx+15
  const int ty = warp / (TW / 16);
  const int tx = (warp % (TW / 16)) * 16;

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int c0 = 0; c0 < C; c0 += KC) {
    // input window with its halo; outside the image -> zeros
    for (int idx = tid; idx < WH * WW * (KC / 8); idx += THREADS) {
      const int pix = idx / (KC / 8), v = idx - pix * (KC / 8);
      const int py = pix / WW, px = pix - py * WW;
      const int gy = y0 - 1 + py, gx = x0 - 1 + px;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        val = *reinterpret_cast<const uint4*>(xb + ((long long)gy * W + gx) * C + c0 + v * 8);
        if (PRO) {
          // silu(x * a + c) in fp32, one bf16 rounding
          const float* ab = pa + (long long)b * C + c0 + v * 8;
          const float* cb = pc + (long long)b * C + c0 + v * 8;
          const bf16* e = reinterpret_cast<const bf16*>(&val);
          uint32_t packed[4];
#pragma unroll
          for (int u = 0; u < 8; u += 2) {
            float f0 = __bfloat162float(e[u]) * ab[u] + cb[u];
            float f1 = __bfloat162float(e[u + 1]) * ab[u + 1] + cb[u + 1];
            f0 = f0 / (1.f + __expf(-f0));
            f1 = f1 / (1.f + __expf(-f1));
            packed[u / 2] = sdk::pack_bf16(f0, f1);
          }
          val = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        }
      }
      *reinterpret_cast<uint4*>(Xs + pix * XS + v * 8) = val;
    }
    // weights of this chunk: Ws[tap][o][c]
    for (int idx = tid; idx < 9 * TO * (KC / 8); idx += THREADS) {
      const int r = idx / (KC / 8), v = idx - r * (KC / 8);
      const int tap = r / TO, o = r - tap * TO;
      *reinterpret_cast<uint4*>(Ws + r * XS + v * 8) =
          *reinterpret_cast<const uint4*>(w + ((long long)(o0 + o) * 9 + tap) * C + c0 + v * 8);
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const bf16* xrow = Xs + ((ty + dy) * WW + tx + dx) * XS;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[4];
        sdk::load_a(a, xrow, XS, 0, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const bf16* p = Ws + (tap * TO + nt * 8 + g) * XS + kk * 16 + 2 * t;
          sdk::mma_16816(acc[nt], a, sdk::ld32(p), sdk::ld32(p + 8));
        }
      }
    }
    __syncthreads();
  }

  const int oy = y0 + ty, ox_lo = x0 + tx + g, ox_hi = ox_lo + 8;
  if (oy >= H) return;
  bf16* yrow = y + ((long long)b * H + oy) * W * O;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = o0 + nt * 8 + 2 * t;
    const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
    if (ox_lo < W) sdk::st32(yrow + (long long)ox_lo * O + col, acc[nt][0] + b0, acc[nt][1] + b1);
    if (ox_hi < W) sdk::st32(yrow + (long long)ox_hi * O + col, acc[nt][2] + b0, acc[nt][3] + b1);
  }
}

template <bool PRO>
int launch(const void* x, const void* w, const void* bias, const float* a,
           const float* c, void* y, int B, int H, int W, int C, int O,
           void* stream) {
  if (C % KC != 0 || O % TO != 0) return (int)cudaErrorInvalidValue;
  SDK_SET_SMEM(conv3x3_kernel<PRO>, SMEM);
  dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), O / TO, B);
  conv3x3_kernel<PRO><<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), a, c, static_cast<bf16*>(y), H, W, C, O);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, C], w [O, 3, 3, C], bias [O], y [B, H, W, O]: contiguous bf16.
// Needs C % 32 == 0 and O % 128 == 0. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int sd_conv3x3_fwd(const void* x, const void* w, const void* bias,
                              void* y, int B, int H, int W, int C, int O,
                              void* stream) {
  return launch<false>(x, w, bias, nullptr, nullptr, y, B, H, W, C, O, stream);
}

// As sd_conv3x3_fwd, with the input taken as silu(x * a + c): a, c [B, C]
// contiguous fp32 (GroupNorm folded per batch row and channel).
extern "C" int sd_gn_silu_conv3x3_fwd(const void* x, const void* w,
                                      const void* bias, const void* a,
                                      const void* c, void* y, int B, int H,
                                      int W, int C, int O, void* stream) {
  return launch<true>(x, w, bias, static_cast<const float*>(a),
                      static_cast<const float*>(c), y, B, H, W, C, O, stream);
}
