// Direct 3x3 SAME convolution for Hopper over NHWC bf16 activations:
// y[b, i, j, o] = bias[o] + sum_{dy, dx, c} x[b, i+dy-1, j+dx-1, c] * w[o, dy, dx, c]
// with zero padding, fp32 accumulation over the nine taps, the bias added in
// fp32 and one bf16 rounding of the output (`conv2d.cu`'s function).
//
// Replaces the TPU kernel `_conv3x3_kernel` (sd_tpu/kernels/conv2d.py:30, impl
// :51, behind `conv3x3_same`), which streams input rows HBM->VMEM with the
// one-pixel halo assembled on chip and runs the 9 taps as 9 matmuls. The
// plain `mma.sync` form in `conv2d.cu` stays as this kernel's yardstick, its
// `PRO` form as the yardstick of the fused form (`conv2d_gn_sm90.cu`).
//
// What bounds it on the H100: an implicit GEMM of M = output pixels, N =
// output channels, K = 9 taps x C. At the KL-f8 decoder's shapes (128^2 x
// 512 -> 512, 256^2 x 512/256 -> 256, 512^2 x 256/128 -> 128) it does
// 18*C*O flops per pixel against 2*(C + O) bytes of device memory, so the
// tensor cores bound it (0.156 ms at [2, 128^2, 512 -> 512]). Inside the
// SM the loads come close: every block reads its weights (9 x C x 128 x 2
// bytes) and its input window from L2, about 53 KB per 16 channels for
// 590 kflop (~5.6 TB/s of L2 reads across the card at 989 TFLOP/s), and
// each product reads both operands from shared memory.
// What the design does about it:
//   * a block owns 2 output rows x 128 pixels x 128 output channels; two
//     consumer warpgroups each take one row as two wgmma m64n128k16 chains
//     (128 fp32 accumulators a thread), a producer warp issues the loads.
//     The 2-row tile halves the halo against a 1-row tile (4 input rows for
//     2 output rows) and reads each weight once per 256 pixels;
//   * the input arrives by TMA: per 8-channel slice one box of (8 channels,
//     130 pixels, 4 rows) from a 4-D map (c, x, y, b) at (c0, x0 - 1, y0 - 1,
//     b). TMA writes zeros outside the image, -1 included, so the zero
//     padding costs nothing. The box lands as [row][pixel][8 channels]: 16
//     bytes per pixel, pixel after pixel, which is the no-swizzle K-major
//     core-matrix layout with 8-row groups 128 bytes apart. The A operand of
//     tap (dy, dx) for 64 output pixels of row r starting at x is therefore
//     the same box at byte offset ((r + dy) * 130 + x + dx) * 16: one
//     descriptor per tap, no shifted copies (a no-swizzle descriptor needs
//     only 16-byte alignment);
//   * the weights arrive by one bulk copy per chunk: a pre-pass launch
//     writes the OIHW weight (channels_last: [O][3][3][C]) once per call in
//     the order the stages read it, [O/128][C/16][tap][8-channel box][128 o]
//     [8], so one chunk's 9 x 2 K-major B tiles (128 rows x 16 bytes each)
//     are 36 KB of contiguous memory. Read as TMA boxes of 8 channels, a
//     16-byte row per output channel, the same weights took 18 boxes and
//     2,304 16-byte requests per chunk, and the loads, not the products,
//     set the pace;
//   * a 4-stage ring of 16-channel chunks (53.5 KB each, 214 KB in all) with
//     a "full" mbarrier (transaction bytes) and an "empty" one (one arrival
//     per consumer warp): a warpgroup keeps one chunk's products in flight
//     (wgmma.wait_group 1) and frees the chunk before it, so the loads of the
//     next three chunks run under the products;
//   * the epilogue adds the bias in fp32 to the registers, rounds once to
//     bf16 and stores NHWC, masked at the right and bottom edges.
// A 2-block cluster sharing each weight chunk by multicast halved the
// weights' L2 reads and ran slower (the blocks wait on each other at every
// stage; PERF.md). Both operands of every product come from shared memory
// (6 KB per m64n128k16, about 3/4 of what it delivers over the product's
// time at full rate): a wider N per product is the next lever.
//
// The kernel, its tile and the pre-pass are in `conv3x3_sm90.cuh`, shared
// with the fused GroupNorm -> SiLU -> conv (`conv2d_gn_sm90.cu`).
#include "conv3x3_sm90.cuh"

// x [B, H, W, C], w [O, 3, 3, C], bias [O], y [B, H, W, O]: contiguous bf16,
// x, w and wpack 16-byte aligned; wpack is scratch of 9 * C * O bf16 for the
// pre-pass. Needs C % 32 == 0 and O % 128 == 0 (any H, W). Returns the CUDA
// error code of the launches (0 on success).
extern "C" int sd_conv3x3_fwd_sm90(const void* x, const void* w, const void* bias, void* y,
                                   void* wpack, int B, int H, int W, int C, int O, void* stream) {
  return launch_conv3x3_sm90<false>(x, w, bias, nullptr, nullptr, y, wpack, B, H, W, C, O,
                                    static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) of the launch (the build report).
extern "C" int sd_conv3x3_fwd_sm90_smem() { return (int)conv_smem(false); }
