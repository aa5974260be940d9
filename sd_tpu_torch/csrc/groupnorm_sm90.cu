// GroupNorm for Hopper over [B, S, C] bf16 activations: fp32 statistics,
// y = x * a + c with a = rsqrt(var + eps) * scale and c = bias - mean * a per
// (batch, channel), an optional fp32 SiLU, one bf16 rounding of the output.
//
// Replaces the TPU kernel `_gn_kernel` (sd_tpu/kernels/groupnorm.py:31,
// behind `group_norm`). Same numerics: per-group sum and sum of squares in
// fp32, the "fast" variance E[x^2] - mean^2 clamped at 0, the affine folded
// per channel, scale and bias in fp32 or bf16.
//
// What bounds it on the H100: about 10 flops per element against 4 bytes
// (x read once, y written once), so bytes: 6.3 us at [4, 4096, 320]. The TPU
// grid ran one step per batch row with the whole [S, C] slab in VMEM; here
// that would put 4 blocks on 132 SMs, and a block cannot hold a slab.
// What the design does about it: one launch, no workspace, x read once.
//   * A block owns a tile of `rows` rows x `cs` channels of one batch row:
//     whole groups, a multiple of 8 channels (`kernels/groupnorm.py
//     gn_plan` picks the slice, the rows and the cluster from the shape). It
//     holds the tile in shared memory, loaded by TMA as boxes of box_c
//     channels x box_r rows of a 3-D map over (c, s, b): rows past S arrive
//     as zeros (they add nothing to the sums) and are not stored.
//   * Per-lane fp32 sums of 8 channels over the tile's rows, then each
//     group's over all 256 threads (a fixed shuffle tree in each warp, the
//     warps in order).
//   * The blocks that share a slice of a batch row (the row blocks, at most
//     8) form a thread-block cluster. Each writes its per-group partial sum
//     and sum of squares to its shared memory; after a cluster barrier every
//     block reads all of them through distributed shared memory in rank
//     order, so every block gets the same statistics, the same bits every
//     run, with no atomics and no second launch.
//   * y is computed from the tile in shared memory and stored from the
//     registers, 16 bytes a thread (TMA stores of the tile normalized in
//     place were 4-20% slower on an H100); the cluster's last
//     barrier (a block's shared memory must outlive the others' reads of
//     it) is split around that work.
#include "sm90.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float param(const void* p, int i, int is_f32) {
  return is_f32 ? static_cast<const float*>(p)[i]
                : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

// Dynamic shared memory of a block (bytes), in the order the kernel lays it
// out: the tile (bf16), the per-lane partial sums and sums of squares
// ([lanes][cs] fp32 each), the per-group partials (float4 each, read by the
// cluster), the per-(group, warp) sums (float2), the per-channel a and c,
// the per-group mean and 1/sigma, the mbarrier. `kernels/groupnorm.py
// _gn_smem` is the same sum.
__host__ __device__ inline int gn_smem(int cs, int cg, int rows) {
  const int lanes = THREADS / (cs / 8), gs = cs / cg;
  return 2 * rows * cs + 8 * lanes * cs + 16 * gs + 8 * (THREADS / 32) * gs + 8 * cs + 8 * gs +
         8;
}

template <bool SILU>
__global__ void __launch_bounds__(THREADS)
gn_sm90_kernel(const __grid_constant__ CUtensorMap mx, bf16* __restrict__ y,
               const void* __restrict__ scale, const void* __restrict__ bias, int param_f32,
               int S, int C, int G, int cs, int rows, int box_c, int box_r, float eps) {
  constexpr int NW = THREADS / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  const int cl = gridDim.x;                    // the cluster: the row blocks of (b, slice)
  const int rank = blockIdx.x, b = blockIdx.z;
  const int c0 = blockIdx.y * cs, r0 = rank * rows;
  const int cg = C / G, gs = cs / cg, cv = cs / 8, lanes = THREADS / cv;
  const int nrb = rows / box_r, ncb = cs / box_c;
  bf16* tile = reinterpret_cast<bf16*>(smem);   // box (cb, rb) at (cb * rows + rb * box_r) * box_c
  float* red_s = reinterpret_cast<float*>(smem + 2 * rows * cs);
  float* red_q = red_s + lanes * cs;
  float4* part = reinterpret_cast<float4*>(red_q + lanes * cs);
  float2* wsum = reinterpret_cast<float2*>(part + gs);     // [gs][NW]
  float* a_s = reinterpret_cast<float*>(wsum + gs * NW);
  float* c_s = a_s + cs;
  float* mu_s = c_s + cs;
  float* ri_s = mu_s + gs;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ri_s + gs);

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (uint32_t)rows * cs * 2);
    for (int cb = 0; cb < ncb; ++cb)
      for (int rb = 0; rb < nrb; ++rb)
        tma_load_3d(tile + (cb * rows + rb * box_r) * box_c, &mx, c0 + cb * box_c,
                    r0 + rb * box_r, b, bar);
  }
  // the slice's scale and bias while the tile arrives
  for (int ch = tid; ch < cs; ch += THREADS) {
    a_s[ch] = param(scale, c0 + ch, param_f32);
    c_s[ch] = param(bias, c0 + ch, param_f32);
  }
  mbar_wait(bar, 0);

  // per-lane sums of 8 channels over rows lane, lane + lanes, ...
  const int lane = tid / cv, v = tid - lane * cv;
  if (lane < lanes) {
    const int cb = 8 * v / box_c;
    const bf16* col = tile + cb * rows * box_c + (8 * v - cb * box_c);
    float sa[8], sq[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) sa[u] = sq[u] = 0.f;
    for (int r = lane; r < rows; r += lanes) {
      const uint4 raw = *reinterpret_cast<const uint4*>(col + r * box_c);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float f = __bfloat162float(e[u]);
        sa[u] += f;
        sq[u] += f * f;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      red_s[lane * cs + 8 * v + u] = sa[u];
      red_q[lane * cs + 8 * v + u] = sq[u];
    }
  }
  __syncthreads();
  // a group's lanes x cg partials over all threads in order, each warp's in
  // a fixed shuffle tree, the warps' in order
  for (int g = 0; g < gs; ++g) {
    float sa = 0.f, sq = 0.f;
    for (int i = tid; i < lanes * cg; i += THREADS) {
      const int l = i / cg, ch = g * cg + (i - l * cg);
      sa += red_s[l * cs + ch];
      sq += red_q[l * cs + ch];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    if (wl == 0) wsum[g * NW + warp] = make_float2(sa, sq);
  }
  __syncthreads();
  for (int g = tid; g < gs; g += THREADS) {
    float sa = 0.f, sq = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      sa += wsum[g * NW + w].x;
      sq += wsum[g * NW + w].y;
    }
    part[g] = make_float4(sa, sq, 0.f, 0.f);
  }
  cluster_sync();   // every block's partials are written
  // the group's statistics over the cluster's blocks, in rank order
  const float cnt = (float)S * (float)cg;
  for (int g = tid; g < gs; g += THREADS) {
    float4 p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < cl) p[k] = ld_cluster_f4(part + g, (uint32_t)k);
    float sa = 0.f, sq = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < cl) {
        sa += p[k].x;
        sq += p[k].y;
      }
    const float mu = sa / cnt;
    const float var = fmaxf(sq / cnt - mu * mu, 0.f);
    mu_s[g] = mu;
    ri_s[g] = rsqrtf(var + eps);
  }
  cluster_arrive();   // this block is done reading the others' partials
  __syncthreads();
  for (int ch = tid; ch < cs; ch += THREADS) {
    const int g = ch / cg;
    const float a = ri_s[g] * a_s[ch];
    c_s[ch] = c_s[ch] - mu_s[g] * a;
    a_s[ch] = a;
  }
  __syncthreads();

  // y = x * a + c (+ SiLU): thread (lane, v) as in the sums, its 8
  // channels' a and c in registers, rows lane, lane + lanes, ... below S,
  // stored from the registers
  if (lane < lanes) {
    const int cb = 8 * v / box_c;
    const bf16* col = tile + cb * rows * box_c + (8 * v - cb * box_c);
    float a[8], c[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      a[u] = a_s[8 * v + u];
      c[u] = c_s[8 * v + u];
    }
    bf16* yb = y + ((long long)b * S + r0) * C + c0 + 8 * v;
    const int rmax = min(rows, S - r0);
    for (int r = lane; r < rmax; r += lanes) {
      const uint4 raw = *reinterpret_cast<const uint4*>(col + r * box_c);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      uint32_t packed[4];
#pragma unroll
      for (int u = 0; u < 8; u += 2) {
        float f0 = __bfloat162float(e[u]) * a[u] + c[u];
        float f1 = __bfloat162float(e[u + 1]) * a[u + 1] + c[u + 1];
        if (SILU) {
          f0 = f0 / (1.f + __expf(-f0));
          f1 = f1 / (1.f + __expf(-f1));
        }
        packed[u / 2] = sdk::pack_bf16(f0, f1);
      }
      *reinterpret_cast<uint4*>(yb + (long long)r * C) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
  }
  cluster_wait();
}

// The plan's checks: whole groups of 8-channel multiples, boxes that tile
// the slice and the rows, the cluster covering S, the shared memory
int plan_ok(int B, int S, int C, int G, int cs, int rows, int box_c, int box_r, int cluster) {
  if (B < 1 || S < 1 || C % 8 || G < 1 || C % G || cs < 8 || cs % 8 || C % cs ||
      cs % (C / G) || cs / 8 > THREADS)
    return 0;
  if (box_c < 8 || box_c % 8 || box_c > 256 || cs % box_c) return 0;
  if (box_r < 8 || box_r % 8 || box_r > 256 || rows % box_r) return 0;
  if (cluster < 1 || cluster > 8 || (long long)cluster * rows < S ||
      (long long)(cluster - 1) * rows >= S)
    return 0;
  return gn_smem(cs, C / G, rows) <= 232448;
}

template <bool SILU>
int launch(const bf16* x, const void* scale, const void* bias, bf16* y, int B, int S, int C,
           int G, int cs, int rows, int box_c, int box_r, int cluster, float eps, int param_f32,
           cudaStream_t s) {
  CUtensorMap mx;
  if (const int e = make_bsc_map(&mx, x, B, S, C, box_c, box_r)) return e;
  const int smem = gn_smem(cs, C / G, rows);
  auto kern = gn_sm90_kernel<SILU>;
  SDK_SET_SMEM(kern, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster, (unsigned)(C / cs), (unsigned)B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, mx, y, scale, bias, param_f32, S, C, G,
                                           cs, rows, box_c, box_r, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// x, y [B, S, C] contiguous bf16 (16-byte aligned); scale, bias [C] in fp32
// (param_f32 = 1) or bf16. The plan (`kernels/groupnorm.py gn_plan`): slices
// of cs channels (whole groups of C / G, a multiple of 8), blocks of `rows`
// rows loaded as box_c x box_r boxes, `cluster` row blocks per (b, slice)
// covering S. Returns the CUDA error code of the launch (0 on success),
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int sd_group_norm_sm90(const void* x, const void* scale, const void* bias, void* y,
                                  int B, int S, int C, int G, int cs, int rows, int box_c,
                                  int box_r, int cluster, float eps, int silu, int param_f32,
                                  void* stream) {
  if (!plan_ok(B, S, C, G, cs, rows, box_c, box_r, cluster)) return (int)cudaErrorInvalidValue;
  const bf16* X = static_cast<const bf16*>(x);
  bf16* Y = static_cast<bf16*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return silu ? launch<true>(X, scale, bias, Y, B, S, C, G, cs, rows, box_c, box_r, cluster, eps,
                             param_f32, s)
              : launch<false>(X, scale, bias, Y, B, S, C, G, cs, rows, box_c, box_r, cluster,
                              eps, param_f32, s);
}

// Dynamic shared memory (bytes) of a block of the plan (the build report).
extern "C" int sd_group_norm_sm90_smem(int C, int G, int cs, int rows) {
  if (G < 1 || C % G || cs < 8 || cs % 8 || cs % (C / G) || cs / 8 > THREADS) return -1;
  return gn_smem(cs, C / G, rows);
}
