// Direct 3x3 SAME convolution for Hopper over NHWC bf16 activations:
// y[b, i, j, o] = bias[o] + sum_{dy, dx, c} x[b, i+dy-1, j+dx-1, c] * w[o, dy, dx, c]
// with zero padding, fp32 accumulation over the nine taps, the bias added in
// fp32 and one bf16 rounding of the output (`conv2d.cu`'s function).
//
// Replaces the TPU kernel `_conv3x3_kernel` (sd_tpu/kernels/conv2d.py:30, impl
// :51, behind `conv3x3_same`), which streams input rows HBM->VMEM with the
// one-pixel halo assembled on chip and runs the 9 taps as 9 matmuls. The
// plain `mma.sync` form in `conv2d.cu` stays as this kernel's yardstick and
// as the GroupNorm -> SiLU prologue form (`PRO`).
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
#include "sm90.cuh"

namespace {

constexpr int TW = 128, TH = 2;        // output pixels of a block: 2 rows x 128
constexpr int TO = 128;                // output channels of a block
constexpr int WW = TW + 2, WH = TH + 2;  // the input window, halo included
constexpr int KC = 16;                 // input channels per chunk (one k16 step)
constexpr int SUB = KC / 8;            // 8-channel boxes per chunk
constexpr int ST = 4;                  // ring depth
constexpr int CHB = WH * WW * 16;      // bytes of one window box
constexpr int WBOX = TO * 16;          // bytes of one weight box
constexpr int WCHUNK = 9 * SUB * WBOX;   // bytes of one chunk's weights
constexpr int STAGE = SUB * CHB + WCHUNK;
constexpr int CONSUMER_WARPS = 8;      // two warpgroups
constexpr int THREADS = CONSUMER_WARPS * 32 + 32;   // + the producer warp
constexpr size_t SMEM = (size_t)ST * STAGE + 2 * ST * 8;
static_assert(CHB % 128 == 0 && WBOX % 128 == 0 && STAGE % 128 == 0,
              "TMA boxes land 128-byte aligned");
static_assert(KC == 16 && TW == 128 && TH == 2, "two warpgroups of 2 x m64 rows");

// the pre-pass: w [O][9][C] into wp [O/TO][C/KC][9][SUB][TO][8], one 16-byte
// vector (8 channels of one output channel and tap) per thread
__global__ void __launch_bounds__(256)
pack_weights_kernel(const bf16* __restrict__ w, bf16* __restrict__ wp, int C, int O) {
  const int c8s = C / 8;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;   // (o, tap, c8), c8 fastest
  if (i >= (long long)O * 9 * c8s) return;
  const int c8 = (int)(i % c8s), tap = (int)(i / c8s % 9), o = (int)(i / (c8s * 9));
  const long long dst =
      (((((long long)(o / TO) * (C / KC) + c8 / SUB) * 9 + tap) * SUB + c8 % SUB) * TO + o % TO) * 8;
  *reinterpret_cast<uint4*>(wp + dst) = *reinterpret_cast<const uint4*>(w + i * 8);
}

__global__ void __launch_bounds__(THREADS, 1)
conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap mx, const bf16* __restrict__ wp,
                    const bf16* __restrict__ bias, bf16* __restrict__ y, int H, int W, int C,
                    int O) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * STAGE);
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_w = (W + TW - 1) / TW;
  const int o0 = blockIdx.x * TO;
  const int y0 = (blockIdx.y / tiles_w) * TH, x0 = (blockIdx.y % tiles_w) * TW;
  const int b = blockIdx.z;
  const int n_ch = C / KC;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // ---- the producer: chunk ch into stage ch % ST once its last use is done
    if (lane == 0) {
      for (int ch = 0; ch < n_ch; ++ch) {
        const int s = ch % ST;
        if (ch >= ST) mbar_wait(empty + s, (ch / ST - 1) & 1);
        unsigned char* win = smem + s * STAGE;
        unsigned char* wt = win + SUB * CHB;
        mbar_expect_tx(full + s, (uint32_t)STAGE);
        for (int j = 0; j < SUB; ++j)
          tma_load_4d(win + j * CHB, &mx, ch * KC + 8 * j, x0 - 1, y0 - 1, b, full + s);
        bulk_load(wt, wp + ((long long)blockIdx.x * n_ch + ch) * (WCHUNK / 2), WCHUNK, full + s);
      }
    }
    return;
  }

  // ---- the consumers: warpgroup wg computes output row y0 + wg ---------------
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  float acc[2][64];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;

  for (int ch = 0; ch < n_ch; ++ch) {
    const int s = ch % ST;
    mbar_wait(full + s, (ch / ST) & 1);
    const unsigned char* win = smem + s * STAGE;
    const unsigned char* wt = win + SUB * CHB;
    wg_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint64_t db = gmma_desc(wt + tap * SUB * WBOX, WBOX, 128);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        Wgmma<128>::ss(acc[mt],
                       gmma_desc(win + ((wg + dy) * WW + 64 * mt + dx) * 16, CHB, 128), db, 1);
    }
    wg_commit();
    // the products of chunk ch - 1 are done: its stage goes back to the producer
    wg_wait_one();
    if (ch > 0 && lane == 0) mbar_arrive(empty + (ch - 1) % ST);
  }
  wg_wait_all();

  // ---- bias in fp32, one bf16 rounding, NHWC store masked at the edges -------
  const int oy = y0 + wg;
  if (oy >= H) return;
  bf16* yrow = y + ((long long)b * H + oy) * W * O + o0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * t;
    const float b0 = __bfloat162float(bias[o0 + col]), b1 = __bfloat162float(bias[o0 + col + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int px_lo = x0 + 64 * mt + 16 * wl + g, px_hi = px_lo + 8;
      if (px_lo < W)
        sdk::st32(yrow + (long long)px_lo * O + col, acc[mt][4 * i] + b0, acc[mt][4 * i + 1] + b1);
      if (px_hi < W)
        sdk::st32(yrow + (long long)px_hi * O + col, acc[mt][4 * i + 2] + b0,
                  acc[mt][4 * i + 3] + b1);
    }
  }
}

}  // namespace

// x [B, H, W, C], w [O, 3, 3, C], bias [O], y [B, H, W, O]: contiguous bf16,
// x, w and wpack 16-byte aligned; wpack is scratch of 9 * C * O bf16 for the
// pre-pass. Needs C % 32 == 0 and O % 128 == 0 (any H, W). Returns the CUDA
// error code of the launches (0 on success).
extern "C" int sd_conv3x3_fwd_sm90(const void* x, const void* w, const void* bias, void* y,
                                   void* wpack, int B, int H, int W, int C, int O, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 32 || O <= 0 || O % TO)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx;
  const int e = make_nhwc_window_map(&mx, static_cast<const bf16*>(x), B, H, W, C, WW, WH);
  if (e) return e;
  dim3 grid(O / TO, ((H + TH - 1) / TH) * ((W + TW - 1) / TW), B);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long vecs = (long long)O * 9 * (C / 8);
  pack_weights_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(w), static_cast<bf16*>(wpack), C, O);
  SDK_SET_SMEM(conv3x3_sm90_kernel, SMEM);
  conv3x3_sm90_kernel<<<grid, THREADS, SMEM, s>>>(mx, static_cast<const bf16*>(wpack),
                                                  static_cast<const bf16*>(bias),
                                                  static_cast<bf16*>(y), H, W, C, O);
  return (int)cudaGetLastError();
}

// Dynamic shared memory (bytes) of the launch (the build report).
extern "C" int sd_conv3x3_fwd_sm90_smem() { return (int)SMEM; }
