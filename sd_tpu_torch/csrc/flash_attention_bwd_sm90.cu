// Flash-attention backward for Hopper at head dims up to 128: the dQ kernel
// and the dK/dV kernel (bf16 in and out, fp32 accumulation) as warpgroup
// products (wgmma) on tiles that arrive by TMA.
//
// Replaces, at the UNet's head dims, the TPU kernels `_flash_bwd_dq_kernel`
// (sd_tpu/kernels/flash_attention.py:465) and `_flash_bwd_dkv_kernel` (:511)
// behind the `jax.custom_vjp` of `flash_attention` (`_bwd` :743). Head dims
// 129-512 stay on `flash_attention_bwd.cu`'s wide kernels; its d <= 128
// instantiations are the yardstick these kernels are timed against.
//
// Math (the TPU kernels'), with s2 = q k^T * scale * log2(e):
//   p     = exp2(s2 - lse2)              (0 where lse2 <= NEG/2)
//   delta = rowsum(dO * O)               (fp32, written by the dQ kernel)
//   dS    = p * (dO v^T - delta)
//   dQ    = scale * bf16(dS) k           dV = bf16(p)^T dO
//   dK    = scale * bf16(dS)^T q
// The split is the TPU package's and has no atomics: every output row is
// written by exactly one block, so dQ, dK and dV are the same bits on every
// run. 2^x is ex2.approx (the fp32 exponential, 2 ulp).
//
// What bounds it on the H100: per head the dQ kernel does 6*Sq*Skv*d and
// the dK/dV kernel 8*Sq*Skv*d tensor-core flops, each one exp2 per (q, kv)
// pair, against O((Sq + Skv) * d) bytes: far above the ridge. At d = 40 the
// exponentials bound the dQ kernel (3.9e12 results/s against one exp2 per
// 240 flops) and the products the dK/dV kernel; at d = 80 the products both.
// What the design does about it:
//   * one body for both kernels (`bwd_body`): a block owns NWG 64-row slabs
//     of its own rows (kv rows for dK/dV, q rows for dQ), one per consumer
//     warpgroup, resident in shared memory (K and V; Q and dO), and sweeps the
//     other side's 64-row tiles (Q and dO with their lse2 and delta slices;
//     K and V) through a 3-stage ring that a producer warp fills by TMA, each
//     stage with a "full" mbarrier (transaction bytes) and an "empty" one
//     (one arrival per consumer warp);
//   * S^T = K Q^T and dP^T = V dO^T (dQ: S = Q K^T, dP = dO V^T) are wgmma
//     m64n64k16 chains with both operands K-major from shared memory; P and
//     dS are formed in the accumulators and rounded to bf16 in place into the
//     register A operand of the next products (the accumulator layout of two
//     neighbouring n8 groups is the A layout of one k16 step);
//   * dV += bf16(P^T) dO and dK += bf16(dS^T) Q (dQ += bf16(dS) K) take B =
//     the same streamed tile read MN-major through a second descriptor, so
//     no transposed copy is ever stored;
//   * tiles sit in the no-swizzle core-matrix layout (8 columns x 64 rows x
//     16 bytes per chunk), one TMA box per chunk of a 4-D view of a strided
//     [B, S, H, D] tensor; the head dim pads to a multiple of 16 (40 -> 48:
//     one chunk of zeros per tile, written once);
//   * rows per block: 128 (two consumer warpgroups sharing every streamed
//     tile) at padded head dims up to 48 where that grid fills a wave of the
//     card, else 64 (kernels/flash_attention.py `bwd_rows`); a sweep is never
//     split;
//   * masks by index: TMA fills rows past Sq and Skv with zeros, and a zero
//     row gives p = exp2(-lse2), not 0, so kv columns past Skv (dQ's last
//     tile) and q columns past Sq (dK/dV) take lse2 = +1e30 and delta 0 by
//     their index, which makes p = dS = 0 with no select per element; the lse2
//     and delta slices of a q tile arrive by one bulk copy each where their
//     rows are 16-byte aligned (Sq a multiple of 4), else the producer warp
//     stages them with plain loads (-1e30 and 0 past Sq).
#include "sm90.cuh"

namespace {

constexpr int R = 64;             // rows of every tile and slab
constexpr int ST = 3;             // ring depth
constexpr float NEG = -1e30f;     // lse2 of a row whose sum is 0 (`NEG_INF`)

template <int DP, int NWG, bool DKV>
struct BwdCfg {
  static constexpr int TILE = R * DP;                    // elements of a tile
  static constexpr int CONSUMERS = NWG * 4;              // consumer warps
  static constexpr int THREADS = CONSUMERS * 32 + 32;    // + the producer warp
  // a stage: the two streamed tiles, and for dK/dV their lse2 and delta
  static constexpr int STAGE = 2 * TILE * 2 + (DKV ? 2 * R * 4 : 0);
  static constexpr size_t SMEM =
      (size_t)2 * NWG * TILE * 2 + (size_t)ST * STAGE + (2 * ST + 1) * 8;
  static_assert(DP % 16 == 0 && DP <= 128 && STAGE % 128 == 0, "head tiling");
};

// what the body reads besides its four tensor maps
struct BwdArgs {
  const bf16* o;          // dQ: delta's inputs O and dO
  const bf16* dout;
  const float* lse;       // [B*H, Sq]
  const float* delta_in;  // dK/dV: [B*H, Sq]
  float* delta_out;       // dQ: [B*H, Sq]
  bf16* out1;             // dQ or dK
  bf16* out2;             // dV
  long long st[12];       // (batch, row, head) strides of o, dO, out1, out2
  int H, Sq, Skv, D;
  int bulk;               // dK/dV: lse2 and delta slices by bulk copy
  float scale_log2, scale;
};

// P = 2^(s * scale_log2 - lse2) and dS = P (dP - delta) in place over one
// 64-column tile of the dQ kernel: x holds S and y dP (rows g and g + 8 of
// the thread's warp, columns 8n + 2t and + 1 of each n8 group n), lse2 and
// delta are per row; with EDGE, columns at or past `lim` (kv rows past Skv)
// take lse2 = +1e30 and delta 0, so P and dS are 0 there
template <bool EDGE>
__device__ __forceinline__ void p_ds_rows(float (&x)[R / 2], float (&y)[R / 2], float l_lo,
                                          float l_hi, float d_lo, float d_hi, int lim, int t,
                                          float scale_log2) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    float l = (i & 2) ? l_hi : l_lo, dd = (i & 2) ? d_hi : d_lo;
    if (EDGE && 8 * (i >> 2) + 2 * t + (i & 1) >= lim) {
      l = -NEG;
      dd = 0.f;
    }
    const float p = fast_exp2(fmaf(x[i], scale_log2, -l));
    x[i] = p;
    y[i] = p * (y[i] - dd);
  }
}

// ... of the dK/dV kernel: x holds S^T and y dP^T, lse2 and delta are per
// column from the stage (`rl`: 64 lse2, then 64 delta); columns at or past
// `valid` (q rows past Sq) or whose lse2 marks a zero sum take lse2 = +1e30
// and delta 0, so P and dS are 0 there whatever the stage holds
__device__ __forceinline__ void p_ds_cols(float (&x)[R / 2], float (&y)[R / 2], const float* rl,
                                          int valid, int t, float scale_log2) {
#pragma unroll
  for (int n = 0; n < R / 8; ++n) {
    const int cl = 8 * n + 2 * t;
    const float2 lc = *reinterpret_cast<const float2*>(rl + cl);
    const float2 dc = *reinterpret_cast<const float2*>(rl + R + cl);
    const bool v0 = cl < valid && lc.x > NEG / 2, v1 = cl + 1 < valid && lc.y > NEG / 2;
    const float l[2] = {v0 ? lc.x : -NEG, v1 ? lc.y : -NEG};
    const float dd[2] = {v0 ? dc.x : 0.f, v1 ? dc.y : 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * n + e;
      const float p = fast_exp2(fmaf(x[i], scale_log2, -l[e & 1]));
      x[i] = p;
      y[i] = p * (y[i] - dd[e & 1]);
    }
  }
}

// mr1, mr2: the resident tensors (K, V for dK/dV; Q, dO for dQ); ms1, ms2:
// the streamed ones (Q, dO; K, V)
template <int DP, int NWG, bool DKV>
__device__ __forceinline__ void bwd_body(const ViewMap& mr1, const ViewMap& mr2,
                                         const ViewMap& ms1, const ViewMap& ms2,
                                         const BwdArgs& a) {
  using C = BwdCfg<DP, NWG, DKV>;
  constexpr int TILE = C::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* res = reinterpret_cast<bf16*>(smem);   // tensor 1's NWG slabs, then tensor 2's
  unsigned char* ring = smem + 2 * NWG * TILE * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * C::STAGE);
  uint64_t* empty = full + ST;
  uint64_t* rbar = empty + ST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int own = DKV ? a.Skv : a.Sq, other = DKV ? a.Sq : a.Skv;
  const int r0 = blockIdx.x * NWG * R;         // the block's first own row
  const int dv = a.D / 8;
  const int n_t = (other + R - 1) / R;

  // pad chunks [D/8, DP/8) of every tile, zeroed once (no copy writes them;
  // the first products contract over them)
  const int padc = DP / 8 - dv;
  for (int idx = tid; idx < padc * R * (2 * NWG + 2 * ST); idx += C::THREADS) {
    const int tile = idx / (padc * R), rem = idx % (padc * R);
    const int rt = tile - 2 * NWG;
    bf16* base = rt < 0 ? res + tile * TILE
                        : reinterpret_cast<bf16*>(ring + (rt >> 1) * C::STAGE) + (rt & 1) * TILE;
    *reinterpret_cast<uint4*>(base + (dv + rem / R) * R * 8 + (rem % R) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, 32);                 // every producer lane arrives
      mbar_init(empty + i, C::CONSUMERS);
    }
    mbar_init(rbar, 1);
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();

  if (warp == C::CONSUMERS) {
    // ---- the producer: the resident slabs once, then tile j into stage
    // j % ST once its last use is done ------------------------------------------
    if (lane == 0) {
      mbar_expect_tx(rbar, 2u * NWG * dv * R * 16);
      for (int w = 0; w < NWG; ++w) {
        load_rows_tma(mr1, res + w * TILE, R, r0 + w * R, b, h, dv, 0, 1, rbar);
        load_rows_tma(mr2, res + (NWG + w) * TILE, R, r0 + w * R, b, h, dv, 0, 1, rbar);
      }
    }
    for (int j = 0; j < n_t; ++j) {
      const int s = j % ST;
      if (j >= ST) mbar_wait(empty + s, (j / ST - 1) & 1);
      bf16* t1 = reinterpret_cast<bf16*>(ring + s * C::STAGE);
      float* rl = reinterpret_cast<float*>(t1 + 2 * TILE);   // lse2, then delta
      const int i0 = j * R, valid = min(R, other - i0);
      const long long row0 = (long long)bh * a.Sq + i0;
      if (DKV && !a.bulk) {
        for (int i = lane; i < R; i += 32) {
          rl[i] = i < valid ? a.lse[row0 + i] : NEG;
          rl[R + i] = i < valid ? a.delta_in[row0 + i] : 0.f;
        }
      }
      if (lane == 0) {
        const bool bulk = DKV && a.bulk;
        mbar_expect_tx(full + s, 2u * dv * R * 16 + (bulk ? 8u * valid : 0u));
        load_rows_tma(ms1, t1, R, i0, b, h, dv, 0, 1, full + s);
        load_rows_tma(ms2, t1 + TILE, R, i0, b, h, dv, 0, 1, full + s);
        if (bulk) {
          bulk_load(rl, a.lse + row0, 4u * valid, full + s);
          bulk_load(rl + R, a.delta_in + row0, 4u * valid, full + s);
        }
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // ---- the consumers: warpgroup wg owns rows [r0 + 64 wg, + 64) ----------------
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const bf16* R1 = res + wg * TILE;
  const bf16* R2 = res + (NWG + wg) * TILE;
  const int row_lo = r0 + wg * R + 16 * wl + g, row_hi = row_lo + 8;
  float l_lo = NEG, l_hi = NEG, d_lo = 0.f, d_hi = 0.f;
  if constexpr (!DKV) {
    // delta = rowsum(dO * O) for the warp's 16 rows, two lanes a row (row
    // 16 wl + i on lanes 2i, 2i + 1), read from device memory while the
    // slabs arrive; the thread's own rows g and g + 8 are on lanes 2g and
    // 2g + 16 of its warp
    const int rr = r0 + wg * R + 16 * wl + (lane >> 1), half = lane & 1;
    float sum = 0.f;
    if (rr < a.Sq) {
      const bf16* orow = a.o + b * a.st[0] + (long long)rr * a.st[1] + h * a.st[2];
      const bf16* drow = a.dout + b * a.st[3] + (long long)rr * a.st[4] + h * a.st[5];
      for (int c = half * 8; c < a.D; c += 16) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dw = *reinterpret_cast<const uint4*>(drow + c);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* de = reinterpret_cast<const bf16*>(&dw);
#pragma unroll
        for (int u = 0; u < 8; ++u) sum += __bfloat162float(oe[u]) * __bfloat162float(de[u]);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0 && rr < a.Sq) a.delta_out[(long long)bh * a.Sq + rr] = sum;
    d_lo = __shfl_sync(0xffffffffu, sum, 2 * g);
    d_hi = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
    if (row_lo < a.Sq) l_lo = a.lse[(long long)bh * a.Sq + row_lo];
    if (row_hi < a.Sq) l_hi = a.lse[(long long)bh * a.Sq + row_hi];
  }
  // a row whose lse2 marks a zero sum (or lies past Sq) takes lse2 = +1e30:
  // its p is then 0 with no select per element
  if (!(l_lo > NEG / 2)) l_lo = -NEG;
  if (!(l_hi > NEG / 2)) l_hi = -NEG;

  float acc1[DP / 2], acc2[DKV ? DP / 2 : 1];   // dQ or dK; dV
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DKV ? DP / 2 : 1); ++i) acc2[i] = 0.f;
  float x[R / 2], y[R / 2];                     // S (S^T) and dP (dP^T), then P and dS
#pragma unroll
  for (int i = 0; i < R / 2; ++i) x[i] = y[i] = 0.f;
  uint32_t ap[R / 16][4], ads[R / 16][4];
  mbar_wait(rbar, 0);

  for (int j = 0; j < n_t; ++j) {
    const int s = j % ST;
    mbar_wait(full + s, (j / ST) & 1);
    const bf16* T1 = reinterpret_cast<const bf16*>(ring + s * C::STAGE);
    const bf16* T2 = T1 + TILE;
    const float* rl = reinterpret_cast<const float*>(T2 + TILE);

    // ---- the first products, both operands K-major from shared memory --------
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<R>::ss(x, gmma_desc(R1 + cm_off<R>(0, 16 * kk), R * 16, 128),
                   gmma_desc(T1 + cm_off<R>(0, 16 * kk), R * 16, 128), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<R>::ss(y, gmma_desc(R2 + cm_off<R>(0, 16 * kk), R * 16, 128),
                   gmma_desc(T2 + cm_off<R>(0, 16 * kk), R * 16, 128), kk > 0);
    wg_commit();
    wg_wait_all();

    // ---- P and dS in place, the masks by index ------------------------------
    const int c0 = j * R;
    if constexpr (DKV)
      p_ds_cols(x, y, rl, a.Sq - c0, t, a.scale_log2);
    else if (c0 + R <= a.Skv)
      p_ds_rows<false>(x, y, l_lo, l_hi, d_lo, d_hi, R, t, a.scale_log2);
    else
      p_ds_rows<true>(x, y, l_lo, l_hi, d_lo, d_hi, a.Skv - c0, t, a.scale_log2);
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      if constexpr (DKV) {
        ap[kk][0] = sdk::pack_bf16(x[8 * kk], x[8 * kk + 1]);
        ap[kk][1] = sdk::pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
        ap[kk][2] = sdk::pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
        ap[kk][3] = sdk::pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
      }
      ads[kk][0] = sdk::pack_bf16(y[8 * kk], y[8 * kk + 1]);
      ads[kk][1] = sdk::pack_bf16(y[8 * kk + 2], y[8 * kk + 3]);
      ads[kk][2] = sdk::pack_bf16(y[8 * kk + 4], y[8 * kk + 5]);
      ads[kk][3] = sdk::pack_bf16(y[8 * kk + 6], y[8 * kk + 7]);
    }
    // the next step's first products overwrite x and y (scale-d 0); zeros
    // here end their values' lives, so they take no registers across the
    // second products
#pragma unroll
    for (int i = 0; i < R / 2; ++i) x[i] = y[i] = 0.f;

    // ---- the second products: A from registers, B the streamed tile MN-major
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      if constexpr (DKV)
        Wgmma<DP>::rs(acc2, ap[kk], gmma_desc(T2 + cm_off<R>(16 * kk, 0), 128, R * 16));
      Wgmma<DP>::rs(acc1, ads[kk], gmma_desc(T1 + cm_off<R>(16 * kk, 0), 128, R * 16));
    }
    wg_commit();
    wg_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

  // ---- dQ * scale (dK * scale, dV), bf16, strided store ------------------------
  bf16* o1 = a.out1 + b * a.st[6] + h * a.st[8];
  bf16* o2 = DKV ? a.out2 + b * a.st[9] + h * a.st[11] : nullptr;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (col >= a.D) continue;
    if (row_lo < own) {
      sdk::st32(o1 + (long long)row_lo * a.st[7] + col, acc1[4 * nt] * a.scale,
                acc1[4 * nt + 1] * a.scale);
      if constexpr (DKV)
        sdk::st32(o2 + (long long)row_lo * a.st[10] + col, acc2[4 * nt], acc2[4 * nt + 1]);
    }
    if (row_hi < own) {
      sdk::st32(o1 + (long long)row_hi * a.st[7] + col, acc1[4 * nt + 2] * a.scale,
                acc1[4 * nt + 3] * a.scale);
      if constexpr (DKV)
        sdk::st32(o2 + (long long)row_hi * a.st[10] + col, acc2[4 * nt + 2], acc2[4 * nt + 3]);
    }
  }
}

template <int DP, int NWG>
__global__ void __launch_bounds__(BwdCfg<DP, NWG, false>::THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ ViewMap mq, const __grid_constant__ ViewMap mdo,
                         const __grid_constant__ ViewMap mk, const __grid_constant__ ViewMap mv,
                         const __grid_constant__ BwdArgs a) {
  bwd_body<DP, NWG, false>(mq, mdo, mk, mv, a);
}

template <int DP, int NWG>
__global__ void __launch_bounds__(BwdCfg<DP, NWG, true>::THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ ViewMap mk, const __grid_constant__ ViewMap mv,
                          const __grid_constant__ ViewMap mq, const __grid_constant__ ViewMap mdo,
                          const __grid_constant__ BwdArgs a) {
  bwd_body<DP, NWG, true>(mk, mv, mq, mdo, a);
}

template <int DP, int NWG, bool DKV>
int launch(const ViewMap& m1, const ViewMap& m2, const ViewMap& m3, const ViewMap& m4,
           const BwdArgs& a, int B, cudaStream_t stream) {
  using C = BwdCfg<DP, NWG, DKV>;
  const int own = DKV ? a.Skv : a.Sq;
  dim3 grid((own + NWG * R - 1) / (NWG * R), B * a.H);
  if constexpr (DKV) {
    auto kern = flash_bwd_dkv_sm90_kernel<DP, NWG>;
    SDK_SET_SMEM(kern, C::SMEM);
    kern<<<grid, C::THREADS, C::SMEM, stream>>>(m1, m2, m3, m4, a);
  } else {
    auto kern = flash_bwd_dq_sm90_kernel<DP, NWG>;
    SDK_SET_SMEM(kern, C::SMEM);
    kern<<<grid, C::THREADS, C::SMEM, stream>>>(m1, m2, m3, m4, a);
  }
  return (int)cudaGetLastError();
}

// 128-row blocks (NWG 2) only up to this padded head dim: above it a 128-row
// dK/dV block needs more registers than 288 threads leave each (at 80 it
// spilled); kernels/flash_attention.py `BWD_ROWS_128_MAX_D`
constexpr int DP_128_MAX = 48;

template <bool DKV>
int dispatch(int D, int rows, const ViewMap& m1, const ViewMap& m2, const ViewMap& m3,
             const ViewMap& m4, const BwdArgs& a, int B, cudaStream_t s) {
  switch ((D + 15) / 16 * 16) {
#define SDK_DP2(DPV)                                                        \
  case DPV:                                                                 \
    return rows == 2 * R ? launch<DPV, 2, DKV>(m1, m2, m3, m4, a, B, s)     \
                         : launch<DPV, 1, DKV>(m1, m2, m3, m4, a, B, s);
#define SDK_DP(DPV) \
  case DPV:         \
    return launch<DPV, 1, DKV>(m1, m2, m3, m4, a, B, s);
    SDK_DP2(16)
    SDK_DP2(32)
    SDK_DP2(48)
    SDK_DP(64)
    SDK_DP(80)
    SDK_DP(96)
    SDK_DP(112)
    SDK_DP(128)
#undef SDK_DP
#undef SDK_DP2
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int H, int Sq, int Skv, int D, int rows) {
  return B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D % 8 || D > 128 ||
         (rows != R && !(rows == 2 * R && (D + 15) / 16 * 16 <= DP_128_MAX)) || B * H > 65535;
}

}  // namespace

// dQ and delta at head dims up to 128 (multiples of 8), `rows` (64, or 128
// up to head dim 48) q rows per block. The other arguments are sd_flash_bwd_dq's
// (flash_attention_bwd.cu): q, k, v, o, dO, dq are [B, S, H, D] bf16 views
// with unit stride along D, 16-byte aligned, strides multiples of 8
// elements; `strides` holds (batch, row, head) for q, k, v, o, dO, dq in
// that order; lse2 (in) and delta (out) are [B*H, Sq] fp32. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int sd_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const void* lse, void* dq, void* delta,
                                    int B, int H, int Sq, int Skv, int D,
                                    const long long* st, float scale_log2, float scale,
                                    int rows, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D, rows)) return (int)cudaErrorInvalidValue;
  ViewMap mq, mk, mv, mdo;
  int e = make_view_map(&mq, static_cast<const bf16*>(q), B, Sq, H, D, st[0], st[1], st[2], R);
  if (!e) e = make_view_map(&mk, static_cast<const bf16*>(k), B, Skv, H, D, st[3], st[4], st[5], R);
  if (!e) e = make_view_map(&mv, static_cast<const bf16*>(v), B, Skv, H, D, st[6], st[7], st[8], R);
  if (!e)
    e = make_view_map(&mdo, static_cast<const bf16*>(dout), B, Sq, H, D, st[12], st[13], st[14], R);
  if (e) return e;
  BwdArgs a{static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
            static_cast<const float*>(lse), nullptr, static_cast<float*>(delta),
            static_cast<bf16*>(dq), nullptr,
            {st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17], 0, 0, 0},
            H, Sq, Skv, D, 0, scale_log2, scale};
  return dispatch<false>(D, rows, mq, mdo, mk, mv, a, B, static_cast<cudaStream_t>(stream));
}

// dK and dV at head dims up to 128, `rows` (64, or 128 up to head dim 48)
// kv rows per block.
// The other arguments are sd_flash_bwd_dkv's: q, k, v, dO, dk, dv views;
// `strides`: (batch, row, head) for q, k, v, dO, dk, dv in that order; lse2
// and delta (from sd_flash_bwd_dq_sm90): [B*H, Sq] fp32. Returns the CUDA
// error code of the launch.
extern "C" int sd_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int H, int Sq, int Skv, int D,
                                     const long long* st, float scale_log2, float scale,
                                     int rows, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D, rows)) return (int)cudaErrorInvalidValue;
  ViewMap mq, mk, mv, mdo;
  int e = make_view_map(&mq, static_cast<const bf16*>(q), B, Sq, H, D, st[0], st[1], st[2], R);
  if (!e) e = make_view_map(&mk, static_cast<const bf16*>(k), B, Skv, H, D, st[3], st[4], st[5], R);
  if (!e) e = make_view_map(&mv, static_cast<const bf16*>(v), B, Skv, H, D, st[6], st[7], st[8], R);
  if (!e)
    e = make_view_map(&mdo, static_cast<const bf16*>(dout), B, Sq, H, D, st[9], st[10], st[11], R);
  if (e) return e;
  // a bulk copy needs 16-byte aligned rows of lse2 and delta
  const int bulk = Sq % 4 == 0 && ((reinterpret_cast<uintptr_t>(lse) |
                                    reinterpret_cast<uintptr_t>(delta)) & 15) == 0;
  BwdArgs a{nullptr, nullptr, static_cast<const float*>(lse), static_cast<const float*>(delta),
            nullptr, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
            {0, 0, 0, 0, 0, 0, st[12], st[13], st[14], st[15], st[16], st[17]},
            H, Sq, Skv, D, bulk, scale_log2, scale};
  return dispatch<true>(D, rows, mk, mv, mq, mdo, a, B, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) of a launch at head dim D with `rows` rows
// per block, of the dK/dV kernel (dkv = 1) or the dQ kernel (the build
// report); -1 where that form is not built.
extern "C" int sd_flash_bwd_sm90_smem(int D, int rows, int dkv) {
  if (bad_shape(1, 1, 1, 1, D, rows)) return -1;
  switch ((D + 15) / 16 * 16) {
#define SDK_DP(DPV)                                                                   \
  case DPV:                                                                           \
    if (dkv) return (int)(rows == 2 * R ? BwdCfg<DPV, 2, true>::SMEM : BwdCfg<DPV, 1, true>::SMEM); \
    return (int)(rows == 2 * R ? BwdCfg<DPV, 2, false>::SMEM : BwdCfg<DPV, 1, false>::SMEM);
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
      return -1;
  }
}
