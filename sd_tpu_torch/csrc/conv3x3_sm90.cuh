// The direct 3x3 SAME conv for Hopper, shared by its two sources: the plain
// conv (`conv2d_sm90.cu`, PRO = false) and the fused GroupNorm -> SiLU -> conv
// (`conv2d_gn_sm90.cu`, PRO = true). The design, and what bounds it, are in
// those sources' notes; this header holds the tile, the weights' pre-pass,
// the kernel and its launch.
//
// A block owns TH x TW output pixels x TO output channels of one batch row.
// A producer streams 16-channel chunks into a ring of ST stages: per chunk
// two TMA boxes of the input window (8 channels x WW pixels x WH rows, zeros
// outside the image) and one bulk copy of the packed weights; with PRO also
// the chunk's 16 fp32 values of a and of c (GroupNorm folded per batch row
// and channel). Two consumer warpgroups each run output row y0 + wg as two
// wgmma m64n128k16 chains over the nine taps. With PRO, two transform
// warpgroups stand between them: once a chunk lands they rewrite its window
// in place, once per value, bf16(silu(x * a + c)) in fp32 inside the image
// and 0 outside it (the SAME halo, which TMA fills with zeros, but silu(c) is
// not 0), one 8-channel box each, and hand the stage to the consumers on a
// third mbarrier. The producer and the transform warpgroups give their
// registers to the consumers (setmaxnreg).
#pragma once

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
constexpr int ACB = 2 * KC * 4;        // bytes of one chunk's a and c (PRO)
constexpr int CONSUMER_WARPS = 8;      // two warpgroups
// threads of a block: the consumers, the producer warp (PRO: two transform
// warpgroups, then a producer warpgroup)
__host__ __device__ constexpr int conv_threads(bool pro) {
  return CONSUMER_WARPS * 32 + (pro ? 384 : 32);
}
// PRO's registers a thread after setmaxnreg (640 threads enter with 96):
// the producer, the transform warpgroups, the consumers (64,512 in all)
constexpr int PRO_REGS_PRODUCER = 24, PRO_REGS_TRANSFORM = 56, PRO_REGS_CONSUMER = 168;
// ... which the block's registers at entry must cover, or the consumers'
// setmaxnreg.inc would wait for ever (the launch checks ptxas's count)
constexpr int PRO_REGS_TOTAL =
    128 * PRO_REGS_PRODUCER + 256 * PRO_REGS_TRANSFORM + 256 * PRO_REGS_CONSUMER;
static_assert(PRO_REGS_TOTAL <= 65536, "the register file of an SM");
// bytes of one ring stage, and the block's dynamic shared memory
__host__ __device__ constexpr int conv_stage(bool pro) {
  return SUB * CHB + WCHUNK + (pro ? ACB : 0);
}
__host__ __device__ constexpr size_t conv_smem(bool pro) {
  return (size_t)ST * conv_stage(pro) + (pro ? 3 : 2) * ST * 8;   // + full, empty (ready)
}
static_assert(CHB % 128 == 0 && WBOX % 128 == 0 && conv_stage(false) % 128 == 0 &&
                  conv_stage(true) % 128 == 0,
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

constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bf16(silu(v)) of the 8 values of `raw`, v = x * a + c, in fp32 from an =
// -a log2(e) and cn = -c log2(e): t = -v log2(e), silu(v) = (-ln2 t) / (1 +
// 2^t), one exponential and one reciprocal on the SFU (1 + 2^t = inf gives
// -0 for v far below 0, 2^t = 0 gives v far above it)
__device__ __forceinline__ uint4 gn_silu8(uint4 raw, const float (&an)[8], const float (&cn)[8]) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
  uint32_t packed[4];
#pragma unroll
  for (int u = 0; u < 8; u += 2) {
    const float t0 = fmaf(__bfloat162float(e[u]), an[u], cn[u]);
    const float t1 = fmaf(__bfloat162float(e[u + 1]), an[u + 1], cn[u + 1]);
    packed[u / 2] = sdk::pack_bf16((-LN2 * t0) * rcp_ftz(1.f + ex2_ftz(t0)),
                                   (-LN2 * t1) * rcp_ftz(1.f + ex2_ftz(t1)));
  }
  return make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

template <bool PRO>
__global__ void __launch_bounds__(conv_threads(PRO), 1)
conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap mx, const bf16* __restrict__ wp,
                    const bf16* __restrict__ bias, const float* __restrict__ ga,
                    const float* __restrict__ gc, bf16* __restrict__ y, int H, int W, int C,
                    int O) {
  constexpr int STAGE = conv_stage(PRO);
  constexpr int PRODUCER_WARP = PRO ? CONSUMER_WARPS + 8 : CONSUMER_WARPS;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * STAGE);
  uint64_t* empty = full + ST;
  uint64_t* ready = empty + ST;   // PRO: the chunk's window transformed

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
      if (PRO) mbar_init(ready + i, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= PRODUCER_WARP) {
    // ---- the producer: chunk ch into stage ch % ST once its last use is done
    if constexpr (PRO)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRO_REGS_PRODUCER));
    if (warp == PRODUCER_WARP && lane == 0) {
      for (int ch = 0; ch < n_ch; ++ch) {
        const int s = ch % ST;
        if (ch >= ST) mbar_wait(empty + s, (ch / ST - 1) & 1);
        unsigned char* win = smem + s * STAGE;
        unsigned char* wt = win + SUB * CHB;
        mbar_expect_tx(full + s, (uint32_t)STAGE);
        for (int j = 0; j < SUB; ++j)
          tma_load_4d(win + j * CHB, &mx, ch * KC + 8 * j, x0 - 1, y0 - 1, b, full + s);
        bulk_load(wt, wp + ((long long)blockIdx.x * n_ch + ch) * (WCHUNK / 2), WCHUNK, full + s);
        if constexpr (PRO) {
          const long long ac = (long long)b * C + ch * KC;
          bulk_load(wt + WCHUNK, ga + ac, ACB / 2, full + s);
          bulk_load(wt + WCHUNK + ACB / 2, gc + ac, ACB / 2, full + s);
        }
      }
    }
    return;
  }

  if constexpr (PRO) {
    if (warp >= CONSUMER_WARPS) {
      // ---- the transform warpgroups: warpgroup j rewrites box j of each chunk
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRO_REGS_TRANSFORM));
      const int tt = tid - CONSUMER_WARPS * 32, j = tt >> 7;
      for (int ch = 0; ch < n_ch; ++ch) {
        const int s = ch % ST;
        mbar_wait(full + s, (ch / ST) & 1);
        unsigned char* win = smem + s * STAGE;
        const float* ac = reinterpret_cast<const float*>(win + SUB * CHB + WCHUNK);
        float an[8], cn[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          an[u] = -LOG2E * ac[8 * j + u];
          cn[u] = -LOG2E * ac[KC + 8 * j + u];
        }
        uint4* box = reinterpret_cast<uint4*>(win + j * CHB);
#pragma unroll 3
        for (int q = tt & 127; q < WH * WW; q += 128) {
          const int r = q / WW, gy = y0 - 1 + r, gx = x0 - 1 + (q - r * WW);
          box[q] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? gn_silu8(box[q], an, cn)
                                                             : make_uint4(0u, 0u, 0u, 0u);
        }
        // the generic-proxy writes made visible to wgmma (the async proxy),
        // then released to the consumers
        fence_async_smem();
        mbar_arrive(ready + s);
      }
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(PRO_REGS_CONSUMER));
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
    mbar_wait((PRO ? ready : full) + s, (ch / ST) & 1);
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

// The weights' pre-pass and the conv on `s`: x [B, H, W, C], w [O, 3, 3, C],
// bias [O], y [B, H, W, O] contiguous bf16, x, w and wpack 16-byte aligned;
// wpack is scratch of 9 * C * O bf16; with PRO, ga and gc are [B, C] fp32.
// Needs C % 32 == 0 and O % 128 == 0 (any H, W). The CUDA error code of the
// launches (0 on success).
template <bool PRO>
int launch_conv3x3_sm90(const void* x, const void* w, const void* bias, const float* ga,
                        const float* gc, void* y, void* wpack, int B, int H, int W, int C, int O,
                        cudaStream_t s) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 32 || O <= 0 || O % TO)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx;
  const int e = make_nhwc_window_map(&mx, static_cast<const bf16*>(x), B, H, W, C, WW, WH);
  if (e) return e;
  dim3 grid(O / TO, ((H + TH - 1) / TH) * ((W + TW - 1) / TW), B);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  if constexpr (PRO) {
    static int entry_regs = 0;
    if (entry_regs == 0) {
      cudaFuncAttributes fa;
      const cudaError_t ea = cudaFuncGetAttributes(&fa, conv3x3_sm90_kernel<true>);
      if (ea != cudaSuccess) return (int)ea;
      entry_regs = fa.numRegs;
    }
    if (entry_regs * conv_threads(true) < PRO_REGS_TOTAL)
      return (int)cudaErrorInvalidConfiguration;
  }
  const long long vecs = (long long)O * 9 * (C / 8);
  pack_weights_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(w), static_cast<bf16*>(wpack), C, O);
  SDK_SET_SMEM(conv3x3_sm90_kernel<PRO>, conv_smem(PRO));
  conv3x3_sm90_kernel<PRO><<<grid, conv_threads(PRO), conv_smem(PRO), s>>>(
      mx, static_cast<const bf16*>(wpack), static_cast<const bf16*>(bias), ga, gc,
      static_cast<bf16*>(y), H, W, C, O);
  return (int)cudaGetLastError();
}

}  // namespace
