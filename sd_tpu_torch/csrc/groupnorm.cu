// GroupNorm for Hopper over [B, S, C] bf16 activations: fp32 statistics,
// y = x * a + c with a = rsqrt(var + eps) * scale and c = bias - mean * a per
// (batch, channel), an optional fp32 SiLU, one bf16 rounding of the output.
//
// Replaces the TPU kernel `_gn_kernel` (sd_tpu/kernels/groupnorm.py:31, behind
// `group_norm`). Same numerics: per-group sum and sum of squares in fp32, the
// "fast" variance E[x^2] - mean^2 clamped at 0, the affine folded per channel.
//
// What bounds it on the H100: about 10 flops per element against 4 bytes
// (one bf16 read, one bf16 write), so it is bound by bytes; at the UNet
// shapes ([4, 4096, 320] is 10.5 MB in and out) the bound is a few
// microseconds. The TPU grid ran one step per batch row with the whole [S, C]
// slab in VMEM; here that would put 4 blocks on 132 SMs.
// What the design does about it: two launches, both with a grid of
// (row chunks, B), about 264 blocks in all. The first reads x once and writes
// per-(chunk, group) fp32 partial sums; the second folds the partials of its
// batch row into per-group statistics (in a fixed order: the same bits every
// run, no atomics), then reads x a second time (from L2 for the UNet shapes)
// and writes y. Loads and stores are 16 bytes (8 channels) per thread along
// whole rows of C, so a group's channels need not be 16-byte aligned (at
// C = 320 a group is 10 channels).
#include "common.cuh"

namespace {

using sdk::bf16;

constexpr int THREADS = 256;

// Thread layout over a chunk of rows: CVT threads cover the C/8 vector
// columns (each thread loops over several when C/8 > THREADS), R row lanes
// stride over the rows.
struct Lanes {
  int cv, cvt, r;
  __host__ __device__ explicit Lanes(int C)
      : cv(C / 8), cvt(C / 8 < THREADS ? C / 8 : THREADS), r(THREADS / cvt) {}
};

__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const bf16* __restrict__ x, float* __restrict__ part, int S,
                int C, int G, int rows) {
  extern __shared__ __align__(16) float sm[];
  const Lanes L(C);
  float* ps = sm;              // [R][C] partial sums
  float* pq = ps + L.r * C;    // [R][C] partial sums of squares
  const int tid = threadIdx.x;
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int s0 = chunk * rows, s1 = min(S, s0 + rows);
  const bf16* xb = x + (long long)b * S * C;

  const int lc = tid % L.cvt, r = tid / L.cvt;
  if (r < L.r) {
    for (int vc = lc; vc < L.cv; vc += L.cvt) {
      float a[8], q[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) a[u] = q[u] = 0.f;
      for (int s = s0 + r; s < s1; s += L.r) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xb + (long long)s * C + vc * 8);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float f = __bfloat162float(e[u]);
          a[u] += f;
          q[u] += f * f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        ps[r * C + vc * 8 + u] = a[u];
        pq[r * C + vc * 8 + u] = q[u];
      }
    }
  }
  __syncthreads();
  // per channel over the row lanes, then per group over its channels
  for (int ch = tid; ch < C; ch += THREADS) {
    float a = 0.f, q = 0.f;
    for (int i = 0; i < L.r; ++i) {
      a += ps[i * C + ch];
      q += pq[i * C + ch];
    }
    ps[ch] = a;
    pq[ch] = q;
  }
  __syncthreads();
  const int cg = C / G;
  for (int g = tid; g < G; g += THREADS) {
    float a = 0.f, q = 0.f;
    for (int i = 0; i < cg; ++i) {
      a += ps[g * cg + i];
      q += pq[g * cg + i];
    }
    float* o = part + (((long long)b * gridDim.x + chunk) * G + g) * 2;
    o[0] = a;
    o[1] = q;
  }
}

__device__ __forceinline__ float param(const void* p, int i, int is_f32) {
  return is_f32 ? static_cast<const float*>(p)[i]
                : __bfloat162float(static_cast<const bf16*>(p)[i]);
}

template <bool SILU>
__global__ void __launch_bounds__(THREADS)
gn_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ part,
               const void* scale, const void* bias, int param_f32,
               bf16* __restrict__ y, int S, int C, int G, int rows, float eps) {
  extern __shared__ __align__(16) float sm[];
  float* a_s = sm;           // [C]
  float* c_s = a_s + C;      // [C]
  float* mu_s = c_s + C;     // [G]
  float* ri_s = mu_s + G;    // [G]
  const int tid = threadIdx.x;
  const int b = blockIdx.y, chunk = blockIdx.x, nchunk = gridDim.x;
  const int cg = C / G;
  const float cnt = (float)S * (float)cg;

  for (int g = tid; g < G; g += THREADS) {
    const float* p = part + ((long long)b * nchunk * G + g) * 2;
    float a = 0.f, q = 0.f;
    for (int k = 0; k < nchunk; ++k) {
      a += p[(long long)k * G * 2];
      q += p[(long long)k * G * 2 + 1];
    }
    const float mu = a / cnt;
    const float var = fmaxf(q / cnt - mu * mu, 0.f);
    mu_s[g] = mu;
    ri_s[g] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int ch = tid; ch < C; ch += THREADS) {
    const int g = ch / cg;
    const float a = ri_s[g] * param(scale, ch, param_f32);
    a_s[ch] = a;
    c_s[ch] = param(bias, ch, param_f32) - mu_s[g] * a;
  }
  __syncthreads();

  const int cv = C / 8;
  const int s0 = chunk * rows, s1 = min(S, s0 + rows);
  const long long base = ((long long)b * S + s0) * C;
  const int n = (s1 - s0) * cv;
  for (int idx = tid; idx < n; idx += THREADS) {
    const int s = idx / cv, c = (idx - s * cv) * 8;
    const long long off = base + (long long)s * C + c;
    const uint4 raw = *reinterpret_cast<const uint4*>(x + off);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    uint32_t packed[4];
#pragma unroll
    for (int u = 0; u < 8; u += 2) {
      float f0 = __bfloat162float(e[u]) * a_s[c + u] + c_s[c + u];
      float f1 = __bfloat162float(e[u + 1]) * a_s[c + u + 1] + c_s[c + u + 1];
      if (SILU) {
        f0 = f0 / (1.f + __expf(-f0));
        f1 = f1 / (1.f + __expf(-f1));
      }
      packed[u / 2] = sdk::pack_bf16(f0, f1);
    }
    *reinterpret_cast<uint4*>(y + off) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

}  // namespace

// x, y [B, S, C] contiguous bf16 (16-byte aligned); scale, bias [C] in fp32
// (param_f32 = 1) or bf16; part a [B, nchunk, G, 2] fp32 workspace; rows the
// rows per chunk, nchunk = ceil(S / rows). Needs C % 8 == 0 and C % G == 0.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int sd_group_norm_fwd(const void* x, const void* scale,
                                 const void* bias, void* y, void* part, int B,
                                 int S, int C, int G, int rows, int nchunk,
                                 float eps, int silu, int param_f32,
                                 void* stream) {
  if (C % 8 != 0 || G < 1 || C % G != 0 || rows < 1 ||
      (long long)nchunk * rows < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* X = static_cast<const bf16*>(x);
  float* P = static_cast<float*>(part);
  const Lanes L(C);
  const size_t smem1 = (size_t)2 * L.r * C * sizeof(float);
  SDK_SET_SMEM(gn_stats_kernel, smem1);
  dim3 grid(nchunk, B);
  gn_stats_kernel<<<grid, THREADS, smem1, s>>>(X, P, S, C, G, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem2 = (size_t)(2 * C + 2 * G) * sizeof(float);
  bf16* Y = static_cast<bf16*>(y);
  if (silu) {
    SDK_SET_SMEM(gn_norm_kernel<true>, smem2);
    gn_norm_kernel<true><<<grid, THREADS, smem2, s>>>(X, P, scale, bias, param_f32, Y,
                                                      S, C, G, rows, eps);
  } else {
    SDK_SET_SMEM(gn_norm_kernel<false>, smem2);
    gn_norm_kernel<false><<<grid, THREADS, smem2, s>>>(X, P, scale, bias, param_f32, Y,
                                                       S, C, G, rows, eps);
  }
  return (int)cudaGetLastError();
}
