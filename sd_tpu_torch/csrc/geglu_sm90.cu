// Fused GEGLU feed-forward for Hopper: out = (a * gelu(g)) W2^T + b2 with
// [a | g] = x W1^T + b1, bf16 in and out, fp32 accumulation (`geglu.cu`'s
// function).
//
// Replaces the TPU kernel `_geglu_kernel` (sd_tpu/kernels/geglu.py:48, behind
// `geglu_ff`). Same rounding points: both products accumulate in fp32, the
// biases are added in fp32, the gate is the exact erf gelu in fp32, y = a *
// gelu(g) is rounded to bf16 before the second product, and the output is
// rounded once. The [N, 2I] intermediate never reaches device memory. The
// `mma.sync` form in `geglu.cu` stays as this kernel's yardstick.
//
// What bounds it on the H100: 6 * N * C * I tensor flops against 2 * (2NC +
// 3CI) bytes of device memory, over 1000 flops per byte at the UNet shapes
// ([16384, 320 -> 1280] and [4096, 640 -> 2560], 40.3 GFLOP each: 0.041 ms at
// 989 TFLOP/s), so the tensor cores bound it. Inside the SM shared memory
// comes close: each block of 64 tokens reads all of W1 and W2 (2.46 / 9.83
// MB, 630 MB per call from L2), and a chunk of 64 inner columns at C = 320
// moves about 336 KB through shared memory (the weights written, both
// operands of every product read), some 2,600 cycles at 128 bytes a cycle
// against 1,900 cycles of tensor work.
// What the design does about it:
//   * a block owns 64 tokens (one wgmma M) and keeps its x tile [64, C]
//     resident (TMA, 8-column boxes, the no-swizzle core-matrix layout). It
//     walks I in chunks of 64: two consumer warpgroups each form [a | g] for
//     32 of the chunk's columns as one m64n64 product chain over C (B = 32 a
//     rows and 32 g rows of W1), take y = a * gelu(g) in registers, and write
//     it to shared memory as bf16; after a named barrier each adds y W2^T into
//     its own half of the output columns (m64n{C/2} chains, or two of
//     m64n{C/4} above C = 384: 80 fp32 accumulator registers a thread at C =
//     320, 160 at 640, where one warpgroup holding all of C would need 320). Two y tiles alternate, so one barrier per chunk
//     orders the writes of one chunk against the reads of the one before;
//   * the weights stream straight from their torch layout through a ring
//     of TMA boxes in the 128-byte swizzle (64 columns, 128 bytes a row;
//     `make_matrix_map(..., true)`, `gmma_desc_sw128`, as the cross-attention
//     GEMM loads its operands): a first-product stage holds, for each
//     warpgroup, 32 a rows and the 32 matching g rows of W1 over 64 columns
//     of C (four boxes), as many such steps over C as fit the stage (2 at
//     C = 320 and 640); a second-product stage holds, for each warpgroup,
//     the chunk's 64 inner columns of NW rows of W2 (two boxes). One thread
//     of a producer warpgroup issues every load (the warpgroup gives its
//     registers to the consumers: setmaxnreg 40 / 232, so the accumulators
//     of C = 640 do not spill); a warpgroup keeps one step's products in
//     flight and frees the stage before it (wgmma.wait_group 1), so the
//     loads run under the products;
//   * where the token tiles alone leave the card short of a wave
//     ([4096, 640 -> 2560]: 64 tiles), I is split over a cluster of 2 or 4
//     blocks (`geglu_plan` in kernels/geglu.py picks the split that gives the
//     shortest critical path, waves x chunks per block). Each block leaves its
//     fp32 partial [64, C] in its shared memory; after a cluster barrier block
//     r sums column slice r of every partial in rank order through
//     distributed shared memory, adds b2 and stores: no atomics, the same bits
//     on every run.
// Weights are in torch Linear layout: W1 [2I, C], W2 [C, I].
#include "sm90.cuh"

namespace {

constexpr int BT = 64;                 // tokens of a block (one wgmma M)
constexpr int IC = 64;                 // inner columns of a chunk: 32 per warpgroup
constexpr int KC = 64;                 // columns of C per first-product step
constexpr int CONSUMER_WARPS = 8;      // two warpgroups
constexpr int THREADS = CONSUMER_WARPS * 32 + 128;  // + the producer warpgroup
constexpr int MAX_SPLIT = 4;
constexpr size_t MAX_SMEM = 232448;
constexpr int ROW = 128;               // bytes of a swizzled weight row: 64 bf16

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

template <int C>
struct Cfg {
  static constexpr int NI = C / 2 > 192 ? 2 : 1;         // second-product stages of a chunk
  static constexpr int NW = C / 2 / NI;                  // ... and their rows of W2 per warpgroup
  static constexpr int XB = BT * C * 2;                  // the x tile
  static constexpr int YB = BT * IC * 2;                 // one y tile
  static constexpr int W1STEP = 2 * 64 * ROW;            // [warpgroup][32 a rows, 32 g rows]
  static constexpr int W2STEP = 2 * NW * ROW;            // [warpgroup][NW rows]
  static constexpr int STAGE = W1STEP > W2STEP ? W1STEP : W2STEP;
  static constexpr int K1 = C / KC;                      // 64-column steps over C
  static constexpr int KS = STAGE / W1STEP;              // ... that a first-product stage holds
  static constexpr int S1 = (K1 + KS - 1) / KS;          // first-product stages of a chunk
  static constexpr size_t RING = XB + 2 * YB;
  // + the slack to align the ring to 1024 bytes (the swizzle's atoms)
  static constexpr int ST = imin(8, (int)((MAX_SMEM - 1024 - RING - 8 * 17) / STAGE));
  static constexpr size_t BARS = RING + (size_t)ST * STAGE;
  static constexpr size_t SMEM = BARS + (2 * ST + 1) * 8 + 1024;
  static constexpr int PS = C + 8;                       // row stride of the fp32 partial
  static_assert(C % KC == 0 && ST >= 3 && RING % 1024 == 0 && STAGE % 1024 == 0, "tiling");
  static_assert((size_t)BT * PS * 4 <= BARS, "the partial fits over x, y and the ring");
};

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// mx: x [N, C] in 8-column boxes of BT rows; ma, mg: the a and g halves of
// W1 ([I, C] each) in swizzled boxes of 32 rows; mw2: W2 [C, I] in swizzled
// boxes of NW rows
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
geglu_sm90_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap ma,
                  const __grid_constant__ CUtensorMap mg, const __grid_constant__ CUtensorMap mw2,
                  const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                  bf16* __restrict__ out, int N, int I, int split) {
  using G = Cfg<C>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ys = reinterpret_cast<bf16*>(smem + G::XB);       // two [BT x IC] tiles
  unsigned char* ring = smem + G::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BARS);
  uint64_t* empty = full + G::ST;
  uint64_t* xbar = empty + G::ST;
  float* part = reinterpret_cast<float*>(smem);            // [BT][PS], after the sweep

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster_rank();
  const int n0 = (blockIdx.x / split) * BT;
  const int n_ch = (I + IC - 1) / IC;
  const int ch0 = rank * n_ch / split, ch1 = (rank + 1) * n_ch / split;

  if (tid == 0) {
    for (int i = 0; i < G::ST; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMER_WARPS);
    }
    mbar_init(xbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int cs = C / split;   // the column slice this block finishes
  if (warp >= CONSUMER_WARPS) {
    // ---- the producer warpgroup (its first lane issues every load): the x
    //      tile once, then every step of the block's chunks; boxes past I
    //      arrive as zeros
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMER_WARPS * 32) {
      mbar_expect_tx(xbar, (uint32_t)G::XB);
      for (int c = 0; c < C / 8; ++c) tma_load_2d(xs + c * BT * 8, &mx, 8 * c, n0, xbar);
      int q = 0;
      for (int ch = ch0; ch < ch1; ++ch) {
        const int i0 = ch * IC;
        for (int step = 0; step < G::S1 + G::NI; ++step, ++q) {
          const int s = q % G::ST;
          if (q >= G::ST) mbar_wait(empty + s, (q / G::ST - 1) & 1);
          unsigned char* st = ring + (size_t)s * G::STAGE;
          if (step < G::S1) {
            const int k0 = step * G::KS, nk = imin(G::KS, G::K1 - k0);
            mbar_expect_tx(full + s, (uint32_t)(nk * G::W1STEP));
            for (int kk = 0; kk < nk; ++kk)
              for (int wg = 0; wg < 2; ++wg) {
                unsigned char* d = st + kk * G::W1STEP + wg * 64 * ROW;
                tma_load_2d(d, &ma, (k0 + kk) * KC, i0 + 32 * wg, full + s);
                tma_load_2d(d + 32 * ROW, &mg, (k0 + kk) * KC, i0 + 32 * wg, full + s);
              }
          } else {
            const int j = step - G::S1;
            mbar_expect_tx(full + s, (uint32_t)G::W2STEP);
            for (int wg = 0; wg < 2; ++wg)
              tma_load_2d(st + wg * G::NW * ROW, &mw2, i0, wg * (C / 2) + j * G::NW, full + s);
          }
        }
      }
    }
    __syncwarp();
    // the cluster's two barriers of the epilogue below
    cluster_sync();
    cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // ---- the consumers: warpgroup wg, inner columns [32 wg, 32 wg + 32) of
    //      each chunk and output columns [wg C / 2, (wg + 1) C / 2)
    const int wg = warp >> 2, wl = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int row = 16 * wl + g;
    float acc[G::NI][G::NW / 2];   // set by the block's first product (scale-d 0)
    float h[32];
    mbar_wait(xbar, 0);
    int q = 0, prev = -1;
    for (int ch = ch0; ch < ch1; ++ch) {
      const int i0 = ch * IC;
      // [a | g]: x [BT, C] against this warpgroup's 64 W1 rows of the chunk
      for (int k0 = 0; k0 < G::K1; k0 += G::KS, ++q) {
        const int s = q % G::ST;
        mbar_wait(full + s, (q / G::ST) & 1);
        const unsigned char* w = ring + (size_t)s * G::STAGE + wg * 64 * ROW;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < G::KS; ++kk) {
          if (k0 + kk >= G::K1) break;
#pragma unroll
          for (int k = 0; k < KC / 16; ++k)
            Wgmma<64>::ss(h,
                          gmma_desc(xs + cm_off<BT>(0, (k0 + kk) * KC + 16 * k), BT * 16, 128),
                          gmma_desc_sw128(w + kk * G::W1STEP + 32 * k), k0 + kk > 0 || k > 0);
        }
        wg_commit();
        // the step before is done: its stage goes back to the producer
        wg_wait_one();
        if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
        prev = s;
      }
      wg_wait_all();
      if (lane == 0) mbar_arrive(empty + prev);
      prev = -1;

      // y = (a + b1) * gelu(g + b1) in fp32, rounded to bf16 into y tile ch & 1;
      // columns 8i + 2t (+1) of the warpgroup's 32: a in h[4i ..], g in h[4i + 16 ..]
      bf16* y = ys + (ch & 1) * (BT * IC);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 32 * wg + 8 * i + 2 * t;
        float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
        if (i0 + col < I) {   // I % 32 == 0: both columns or neither
          const float ba0 = __bfloat162float(b1[i0 + col]);
          const float ba1 = __bfloat162float(b1[i0 + col + 1]);
          const float bg0 = __bfloat162float(b1[I + i0 + col]);
          const float bg1 = __bfloat162float(b1[I + i0 + col + 1]);
          y0 = (h[4 * i] + ba0) * gelu_erf(h[4 * i + 16] + bg0);
          y1 = (h[4 * i + 1] + ba1) * gelu_erf(h[4 * i + 17] + bg1);
          y2 = (h[4 * i + 2] + ba0) * gelu_erf(h[4 * i + 18] + bg0);
          y3 = (h[4 * i + 3] + ba1) * gelu_erf(h[4 * i + 19] + bg1);
        }
        sdk::st32(y + cm_off<BT>(row, col), y0, y1);
        sdk::st32(y + cm_off<BT>(row + 8, col), y2, y3);
      }
      fence_async_smem();
      named_sync(1, CONSUMER_WARPS * 32);

      // out[:, this warpgroup's half] += y W2^T over the chunk's 64 columns,
      // NW output columns a stage
#pragma unroll
      for (int j = 0; j < G::NI; ++j, ++q) {
        const int s = q % G::ST;
        mbar_wait(full + s, (q / G::ST) & 1);
        const unsigned char* w = ring + (size_t)s * G::STAGE + wg * G::NW * ROW;
        wg_fence();
#pragma unroll
        for (int k = 0; k < IC / 16; ++k)
          Wgmma<G::NW>::ss(acc[j], gmma_desc(y + cm_off<BT>(0, 16 * k), BT * 16, 128),
                           gmma_desc_sw128(w + 32 * k), ch > ch0 || k > 0);
        wg_commit();
        wg_wait_one();
        if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
        prev = s;
      }
    }
    wg_wait_all();

    // the fp32 partial over the block's shared memory (x, y and the ring are
    // done with: every load issued was waited for)
    named_sync(1, CONSUMER_WARPS * 32);
#pragma unroll
    for (int j = 0; j < G::NI; ++j)
#pragma unroll
      for (int i = 0; i < G::NW / 8; ++i) {
        const int col = wg * (C / 2) + j * G::NW + 8 * i + 2 * t;
        *reinterpret_cast<float2*>(part + row * G::PS + col) =
            make_float2(acc[j][4 * i], acc[j][4 * i + 1]);
        *reinterpret_cast<float2*>(part + (row + 8) * G::PS + col) =
            make_float2(acc[j][4 * i + 2], acc[j][4 * i + 3]);
      }

    // ---- block `rank` of the cluster finishes column slice `rank` of the
    //      tile: the partials summed in rank order, b2 in fp32, one rounding
    cluster_sync();
    for (int idx = tid; idx < BT * cs / 4; idx += CONSUMER_WARPS * 32) {
      const int r = idx / (cs / 4), col = rank * cs + idx % (cs / 4) * 4;
      const float* p = part + r * G::PS + col;
      float4 v = ld_cluster_f4(p, 0);
      for (int o = 1; o < split; ++o) {
        const float4 u = ld_cluster_f4(p, o);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      if (n0 + r < N) {
        uint2 o;
        o.x = sdk::pack_bf16(v.x + __bfloat162float(b2[col]),
                           v.y + __bfloat162float(b2[col + 1]));
        o.y = sdk::pack_bf16(v.z + __bfloat162float(b2[col + 2]),
                             v.w + __bfloat162float(b2[col + 3]));
        *reinterpret_cast<uint2*>(out + (long long)(n0 + r) * C + col) = o;
      }
    }
    // no block leaves while another still reads its shared memory
    cluster_sync();
  }
}

template <int C>
int launch(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2, const bf16* b2,
           bf16* out, int N, int I, int split, cudaStream_t s) {
  using G = Cfg<C>;
  const int n_ch = (I + IC - 1) / IC;
  if (split < 1 || split > MAX_SPLIT || split > n_ch) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, ma, mg, mw2;
  if (const int e = make_matrix_map(&mx, x, N, C, BT)) return e;
  if (const int e = make_matrix_map(&ma, w1, I, C, 32, true)) return e;
  if (const int e = make_matrix_map(&mg, w1 + (size_t)I * C, I, C, 32, true)) return e;
  if (const int e = make_matrix_map(&mw2, w2, C, I, G::NW, true)) return e;
  auto kern = geglu_sm90_kernel<C>;
  SDK_SET_SMEM(kern, G::SMEM);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((N + BT - 1) / BT) * split));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, mx, ma, mg, mw2, b1, b2, out, N, I, split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, C], w1 [2I, C], b1 [2I], w2 [C, I], b2 [C], out [N, C]: contiguous
// bf16, 16-byte aligned. Needs C in {128, 256, 320, 384, 512, 640}, I % 32 ==
// 0, N >= 1 and `split` (blocks of a cluster sharing one token tile's inner
// columns) in 1..4, at most the chunks of 64 inner columns. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int sd_geglu_fwd_sm90(const void* x, const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* out, int N, int C, int I, int split,
                                 void* stream) {
  if (N < 1 || I < 32 || I % 32 != 0) return (int)cudaErrorInvalidValue;
  const bf16* X = static_cast<const bf16*>(x);
  const bf16* W1 = static_cast<const bf16*>(w1);
  const bf16* B1 = static_cast<const bf16*>(b1);
  const bf16* W2 = static_cast<const bf16*>(w2);
  const bf16* B2 = static_cast<const bf16*>(b2);
  bf16* O = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return launch<128>(X, W1, B1, W2, B2, O, N, I, split, s);
    case 256: return launch<256>(X, W1, B1, W2, B2, O, N, I, split, s);
    case 320: return launch<320>(X, W1, B1, W2, B2, O, N, I, split, s);
    case 384: return launch<384>(X, W1, B1, W2, B2, O, N, I, split, s);
    case 512: return launch<512>(X, W1, B1, W2, B2, O, N, I, split, s);
    case 640: return launch<640>(X, W1, B1, W2, B2, O, N, I, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory (bytes) of the launch at width C (the build report).
extern "C" int sd_geglu_fwd_sm90_smem(int C) {
  switch (C) {
    case 128: return (int)Cfg<128>::SMEM;
    case 256: return (int)Cfg<256>::SMEM;
    case 320: return (int)Cfg<320>::SMEM;
    case 384: return (int)Cfg<384>::SMEM;
    case 512: return (int)Cfg<512>::SMEM;
    case 640: return (int)Cfg<640>::SMEM;
    default: return -1;
  }
}
