// Flash-attention backward for Hopper: the dQ kernel and the dK/dV kernel
// (bf16 in and out, fp32 accumulation), head dims up to 128.
//
// Replace the TPU kernels `_flash_bwd_dq_kernel`
// (sd_tpu/kernels/flash_attention.py:465) and `_flash_bwd_dkv_kernel` (:511)
// behind the `jax.custom_vjp` of `flash_attention` (:602, `_bwd` :743). The
// split is the TPU package's: a dQ kernel with kv innermost and a dK/dV
// kernel with q innermost, both recomputing the probabilities from the
// forward's base-2 row log-sum-exp, so no [Sq, Skv] tensor reaches device
// memory and no block adds into another's output (no atomics: the gradients
// are the same bits run to run).
//
// Math (the TPU kernels'), with s2 = q k^T * scale * log2(e):
//   p     = exp2(s2 - lse2)              (0 where lse2 <= NEG/2: padded q rows)
//   delta = rowsum(dO * O)               (fp32, from the bf16 O and dO)
//   dS    = p * (dO v^T - delta)
//   dQ    = scale * bf16(dS) k           dV = bf16(p)^T dO
//   dK    = scale * bf16(dS)^T q
// The dQ kernel computes delta for its rows before its kv sweep (the TPU
// kernel fused it into its first kv step) and writes it for the dK/dV kernel.
//
// What bounds it on the H100: at the UNet shapes (S = 4096 / 1024, d = 40 /
// 80) the dQ kernel does 6*S^2*d and the dK/dV kernel 8*S^2*d flops per head
// against O(S*d) bytes, so both are bound by operations (tensor-core products,
// and at d = 40 the exp2 of every (q, kv) pair, once in each kernel). What the
// design does about it: every product runs on the tensor cores (mma.sync
// m16n8k16, fp32 accumulate); S and dP stay in registers and are turned into
// the A operand of the next product in place (the m16n8 accumulator layout of
// two neighbouring n8 tiles is the m16k16 A layout), so p and dS never touch
// shared memory. Operands that a product needs with the other dimension
// contiguous (K for dS k; Q and dO for dS^T q and p^T dO) are transposed once
// per tile while they are stored to shared memory. The head dim is
// zero-padded to a multiple of 16 in shared memory only. It is the simple
// form: no cp.async/TMA pipelining and no wgmma (later work, see PERF.md).
//
// Layouts: q, k, v, o, dO, dq, dk, dv are strided [B, S, H, D] views (unit
// stride along D); lse2 and delta are [B*H, Sq] fp32 (row b*H + h).
#include "common.cuh"

namespace {

using sdk::bf16;

constexpr float NEG = -1e30f;

// (batch, row, head) element strides of six [B, S, H, D] views, passed to
// the kernels by value
struct Strides {
  long long v[18];
};

// rows [r0, r0+R) x columns [0, D) of a strided bf16 matrix into shared
// memory, row-major with row stride LD; rows at or past n are zeros
template <int R, int LD, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long row_stride, int r0, int n,
                                          int D) {
  const int dv = D / 8;
  for (int idx = threadIdx.x; idx < R * dv; idx += THREADS) {
    const int r = idx / dv, c = (idx - r * dv) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// the same rows stored both row-major (row stride LD) and transposed to
// [column][row] (row stride TS)
template <int R, int LD, int TS, int THREADS>
__device__ __forceinline__ void load_rows_both(bf16* dst, bf16* dst_t,
                                               const bf16* src,
                                               long long row_stride, int r0,
                                               int n, int D) {
  const int dv = D / 8;
  for (int idx = threadIdx.x; idx < R * dv; idx += THREADS) {
    const int r = idx / dv, c = (idx - r * dv) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int u = 0; u < 8; ++u) dst_t[(c + u) * TS + r] = e[u];
  }
}

template <int N>
__device__ __forceinline__ void zero_fill(bf16* p, int tid, int threads) {
  for (int i = tid; i < N; i += threads) p[i] = __float2bfloat16(0.f);
}

// the A fragment (16 rows x k16) made of two neighbouring m16n8 fp32
// accumulator tiles, rounded to bf16: columns 0-7 from lo, 8-15 from hi
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = sdk::pack_bf16(lo[0], lo[1]);
  a[1] = sdk::pack_bf16(lo[2], lo[3]);
  a[2] = sdk::pack_bf16(hi[0], hi[1]);
  a[3] = sdk::pack_bf16(hi[2], hi[3]);
}

// ---------------------------------------------------------------------------
// dQ (+ delta): one block per (q tile of BQ rows, b*H + h); warp w owns rows
// [16w, 16w+16) of the tile and sweeps every kv tile of BK rows.
// ---------------------------------------------------------------------------

template <int DP, int BQ, int BK>
struct DqCfg {
  static constexpr int WARPS = BQ / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int LD = DP + 8;   // bf16 row stride of [row][d] tiles
  static constexpr int TS = BK + 8;   // bf16 row stride of K^T [d][kv]
  static constexpr int SNT = BK / 8;  // n8 tiles of S and dP per warp
  static constexpr int ONT = DP / 8;  // n8 tiles of dQ per warp
  static constexpr size_t SMEM =
      (size_t)(2 * BQ) * 4 + (size_t)(2 * BQ * LD + 2 * BK * LD + DP * TS) * 2;
  static_assert(DP % 16 == 0 && BK % 16 == 0 && THREADS == 2 * BQ, "tiling");
};

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(DqCfg<DP, BQ, BK>::THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse, bf16* __restrict__ dq,
                    float* __restrict__ delta, int H, int Sq, int Skv, int D,
                    const Strides sv, float scale_log2,
                    float scale) {
  using C = DqCfg<DP, BQ, BK>;
  const long long* st = sv.v;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lse_s = reinterpret_cast<float*>(smem);
  float* delta_s = lse_s + BQ;
  bf16* Qs = reinterpret_cast<bf16*>(delta_s + BQ);
  bf16* dOs = Qs + BQ * C::LD;
  bf16* Ks = dOs + BQ * C::LD;
  bf16* Vs = Ks + BK * C::LD;
  bf16* Kt = Vs + BK * C::LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  // strides: (batch, row, head) for q, k, v, o, dO, dq in that order
  const bf16* qb = q + b * st[0] + h * st[2];
  const bf16* kb = k + b * st[3] + h * st[5];
  const bf16* vb = v + b * st[6] + h * st[8];
  const bf16* ob = o + b * st[9] + h * st[11];
  const bf16* dob = dout + b * st[12] + h * st[14];
  bf16* dqb = dq + b * st[15] + h * st[17];

  // padded head columns stay zero: loads only ever write columns < D
  zero_fill<(2 * BQ + 2 * BK) * C::LD + DP * C::TS>(Qs, tid, C::THREADS);
  __syncthreads();
  load_rows<BQ, C::LD, C::THREADS>(Qs, qb, st[1], q0, Sq, D);
  load_rows<BQ, C::LD, C::THREADS>(dOs, dob, st[13], q0, Sq, D);

  // delta = rowsum(dO * O): two neighbouring threads per row
  {
    const int r = tid >> 1, half = tid & 1;
    float sum = 0.f;
    if (q0 + r < Sq) {
      const bf16* orow = ob + (long long)(q0 + r) * st[10];
      const bf16* drow = dob + (long long)(q0 + r) * st[13];
      for (int c = half * 8; c < D; c += 16) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          sum += __bfloat162float(oe[u]) * __bfloat162float(de[u]);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      delta_s[r] = sum;
      lse_s[r] = q0 + r < Sq ? lse[(long long)bh * Sq + q0 + r] : NEG;
      if (q0 + r < Sq) delta[(long long)bh * Sq + q0 + r] = sum;
    }
  }

  float dqacc[C::ONT][4];
#pragma unroll
  for (int i = 0; i < C::ONT; ++i) dqacc[i][0] = dqacc[i][1] = dqacc[i][2] = dqacc[i][3] = 0.f;

  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  for (int j0 = 0; j0 < Skv; j0 += BK) {
    load_rows_both<BK, C::LD, C::TS, C::THREADS>(Ks, Kt, kb, st[4], j0, Skv, D);
    load_rows<BK, C::LD, C::THREADS>(Vs, vb, st[7], j0, Skv, D);
    __syncthreads();

    // ---- S = Q K^T and dP = dO V^T for this warp's 16 rows -------------
    float s[C::SNT][4], dp[C::SNT][4];
#pragma unroll
    for (int i = 0; i < C::SNT; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t aq[4], ado[4];
      sdk::load_a(aq, Qs, C::LD, warp * 16, kk * 16, g, t);
      sdk::load_a(ado, dOs, C::LD, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < C::SNT; ++nt) {
        const int off = (nt * 8 + g) * C::LD + kk * 16 + 2 * t;
        sdk::mma_16816(s[nt], aq, sdk::ld32(Ks + off), sdk::ld32(Ks + off + 8));
        sdk::mma_16816(dp[nt], ado, sdk::ld32(Vs + off), sdk::ld32(Vs + off + 8));
      }
    }

    // ---- p from lse2, dS = p (dP - delta), in place in s ----------------
    const float l_lo = lse_s[r_lo], l_hi = lse_s[r_hi];
    const float d_lo = delta_s[r_lo], d_hi = delta_s[r_hi];
    const bool ok_lo = l_lo > NEG / 2, ok_hi = l_hi > NEG / 2;
#pragma unroll
    for (int nt = 0; nt < C::SNT; ++nt) {
      const int col = j0 + nt * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const bool ok = (hi ? ok_hi : ok_lo) && col + (e & 1) < Skv;
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - (hi ? l_hi : l_lo)) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (hi ? d_hi : d_lo));
      }
    }

    // ---- dQ += bf16(dS) K  (B operand: K^T [d][kv], kv contiguous) ------
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < C::ONT; ++nt) {
        const bf16* p = Kt + (nt * 8 + g) * C::TS + kk * 16 + 2 * t;
        sdk::mma_16816(dqacc[nt], a, sdk::ld32(p), sdk::ld32(p + 8));
      }
    }
    __syncthreads();
  }

  // ---- dQ * scale, bf16, strided store -------------------------------------
#pragma unroll
  for (int nt = 0; nt < C::ONT; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (col < D) {
      if (q0 + r_lo < Sq)
        sdk::st32(dqb + (long long)(q0 + r_lo) * st[16] + col,
                  dqacc[nt][0] * scale, dqacc[nt][1] * scale);
      if (q0 + r_hi < Sq)
        sdk::st32(dqb + (long long)(q0 + r_hi) * st[16] + col,
                  dqacc[nt][2] * scale, dqacc[nt][3] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (kv tile of BK rows, b*H + h); warp w owns kv rows
// [16w, 16w+16) and sweeps every q tile of BQ rows, dK and dV in registers.
// ---------------------------------------------------------------------------

template <int DP, int BK, int BQ>
struct DkvCfg {
  static constexpr int WARPS = BK / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int LD = DP + 8;   // bf16 row stride of [row][d] tiles
  static constexpr int TS = BQ + 8;   // bf16 row stride of Q^T, dO^T [d][q]
  static constexpr int SNT = BQ / 8;  // n8 tiles of S^T and dP^T per warp
  static constexpr int ONT = DP / 8;  // n8 tiles of dK and dV per warp
  static constexpr size_t SMEM =
      (size_t)(2 * BQ) * 4 + (size_t)(2 * BK * LD + 2 * BQ * LD + 2 * DP * TS) * 2;
  static_assert(DP % 16 == 0 && BQ % 16 == 0, "tiling");
};

template <int DP, int BK, int BQ>
__global__ void __launch_bounds__(DkvCfg<DP, BK, BQ>::THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Sq, int Skv, int D,
                     const Strides sv, float scale_log2,
                     float scale) {
  using C = DkvCfg<DP, BK, BQ>;
  const long long* st = sv.v;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lse_s = reinterpret_cast<float*>(smem);
  float* delta_s = lse_s + BQ;
  bf16* Ks = reinterpret_cast<bf16*>(delta_s + BQ);
  bf16* Vs = Ks + BK * C::LD;
  bf16* Qs = Vs + BK * C::LD;
  bf16* dOs = Qs + BQ * C::LD;
  bf16* Qt = dOs + BQ * C::LD;
  bf16* dOt = Qt + DP * C::TS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  // strides: (batch, row, head) for q, k, v, dO, dk, dv in that order
  const bf16* qb = q + b * st[0] + h * st[2];
  const bf16* kb = k + b * st[3] + h * st[5];
  const bf16* vb = v + b * st[6] + h * st[8];
  const bf16* dob = dout + b * st[9] + h * st[11];
  bf16* dkb = dk + b * st[12] + h * st[14];
  bf16* dvb = dv + b * st[15] + h * st[17];

  zero_fill<(2 * BK + 2 * BQ) * C::LD + 2 * DP * C::TS>(Ks, tid, C::THREADS);
  __syncthreads();
  load_rows<BK, C::LD, C::THREADS>(Ks, kb, st[4], k0, Skv, D);
  load_rows<BK, C::LD, C::THREADS>(Vs, vb, st[7], k0, Skv, D);

  float dkacc[C::ONT][4], dvacc[C::ONT][4];
#pragma unroll
  for (int i = 0; i < C::ONT; ++i) {
    dkacc[i][0] = dkacc[i][1] = dkacc[i][2] = dkacc[i][3] = 0.f;
    dvacc[i][0] = dvacc[i][1] = dvacc[i][2] = dvacc[i][3] = 0.f;
  }

  for (int i0 = 0; i0 < Sq; i0 += BQ) {
    load_rows_both<BQ, C::LD, C::TS, C::THREADS>(Qs, Qt, qb, st[1], i0, Sq, D);
    load_rows_both<BQ, C::LD, C::TS, C::THREADS>(dOs, dOt, dob, st[10], i0, Sq, D);
    for (int i = tid; i < BQ; i += C::THREADS) {
      const bool in = i0 + i < Sq;
      lse_s[i] = in ? lse[(long long)bh * Sq + i0 + i] : NEG;
      delta_s[i] = in ? delta[(long long)bh * Sq + i0 + i] : 0.f;
    }
    __syncthreads();

    // ---- S^T = K Q^T and dP^T = V dO^T for this warp's 16 kv rows -------
    float s[C::SNT][4], dp[C::SNT][4];
#pragma unroll
    for (int i = 0; i < C::SNT; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ak[4], av[4];
      sdk::load_a(ak, Ks, C::LD, warp * 16, kk * 16, g, t);
      sdk::load_a(av, Vs, C::LD, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < C::SNT; ++nt) {
        const int off = (nt * 8 + g) * C::LD + kk * 16 + 2 * t;
        sdk::mma_16816(s[nt], ak, sdk::ld32(Qs + off), sdk::ld32(Qs + off + 8));
        sdk::mma_16816(dp[nt], av, sdk::ld32(dOs + off), sdk::ld32(dOs + off + 8));
      }
    }

    // ---- p^T from lse2 (per q column), dS^T = p^T (dP^T - delta) --------
#pragma unroll
    for (int nt = 0; nt < C::SNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);
        const float l = lse_s[qc];
        const float p = l > NEG / 2 ? exp2f(s[nt][e] * scale_log2 - l) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - delta_s[qc]);
      }
    }

    // ---- dV += bf16(p^T) dO, dK += bf16(dS^T) Q  (B: [d][q] transposes) --
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], ads[4];
      acc_to_a(ap, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < C::ONT; ++nt) {
        const int off = (nt * 8 + g) * C::TS + kk * 16 + 2 * t;
        sdk::mma_16816(dvacc[nt], ap, sdk::ld32(dOt + off), sdk::ld32(dOt + off + 8));
        sdk::mma_16816(dkacc[nt], ads, sdk::ld32(Qt + off), sdk::ld32(Qt + off + 8));
      }
    }
    __syncthreads();
  }

  // ---- dK * scale and dV, bf16, strided store --------------------------------
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int nt = 0; nt < C::ONT; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (col < D) {
      if (k0 + r_lo < Skv) {
        sdk::st32(dkb + (long long)(k0 + r_lo) * st[13] + col,
                  dkacc[nt][0] * scale, dkacc[nt][1] * scale);
        sdk::st32(dvb + (long long)(k0 + r_lo) * st[16] + col, dvacc[nt][0], dvacc[nt][1]);
      }
      if (k0 + r_hi < Skv) {
        sdk::st32(dkb + (long long)(k0 + r_hi) * st[13] + col,
                  dkacc[nt][2] * scale, dkacc[nt][3] * scale);
        sdk::st32(dvb + (long long)(k0 + r_hi) * st[16] + col, dvacc[nt][2], dvacc[nt][3]);
      }
    }
  }
}

template <int DP>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
              const bf16* dout, const float* lse, bf16* dq, float* delta,
              int B, int H, int Sq, int Skv, int D, const Strides& st,
              float scale_log2, float scale, cudaStream_t stream) {
  constexpr int BQ = 64, BK = 64;
  using C = DqCfg<DP, BQ, BK>;
  auto kern = flash_bwd_dq_kernel<DP, BQ, BK>;
  SDK_SET_SMEM(kern, C::SMEM);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(q, k, v, o, dout, lse, dq, delta,
                                              H, Sq, Skv, D, st, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               const float* lse, const float* delta, bf16* dk, bf16* dv, int B,
               int H, int Sq, int Skv, int D, const Strides& st,
               float scale_log2, float scale, cudaStream_t stream) {
  // two fp32 [16, DP] accumulators per warp: a narrower q tile above d = 80
  // keeps S^T and dP^T from pushing the registers past what a thread has
  constexpr int BK = 64, BQ = DP > 80 ? 32 : 64;
  using C = DkvCfg<DP, BK, BQ>;
  auto kern = flash_bwd_dkv_kernel<DP, BK, BQ>;
  SDK_SET_SMEM(kern, C::SMEM);
  dim3 grid((Skv + BK - 1) / BK, B * H);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                              H, Sq, Skv, D, st, scale_log2, scale);
  return (int)cudaGetLastError();
}

Strides copy_strides(const long long* strides) {
  Strides st;
  for (int i = 0; i < 18; ++i) st.v[i] = strides[i];
  return st;
}

}  // namespace

// dQ and delta. q, k, v, o, dO, dq: [B, S, H, D] bf16 views, unit stride
// along D; `strides` holds 18 values, (batch, row, head) for q, k, v, o, dO,
// dq in that order. lse2 (in) and delta (out): [B*H, Sq] fp32. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int sd_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, const void* lse,
                               void* dq, void* delta, int B, int H, int Sq,
                               int Skv, int D, const long long* strides,
                               float scale_log2, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = copy_strides(strides);
#define SDK_DQ(DPV)                                                            \
  case DPV:                                                                    \
    return launch_dq<DPV>(                                                     \
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),              \
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),              \
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),        \
        static_cast<bf16*>(dq), static_cast<float*>(delta), B, H, Sq, Skv, D,  \
        st, scale_log2, scale, s);
  switch ((D + 15) / 16 * 16) {
    SDK_DQ(16)
    SDK_DQ(32)
    SDK_DQ(48)
    SDK_DQ(64)
    SDK_DQ(80)
    SDK_DQ(96)
    SDK_DQ(112)
    SDK_DQ(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SDK_DQ
}

// dK and dV. q, k, v, dO, dk, dv: [B, S, H, D] bf16 views, unit stride along
// D; `strides`: (batch, row, head) for q, k, v, dO, dk, dv in that order;
// lse2 and delta: [B*H, Sq] fp32 (delta from sd_flash_bwd_dq). Returns the
// CUDA error code of the launch.
extern "C" int sd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int H, int Sq, int Skv, int D,
                                const long long* strides, float scale_log2,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = copy_strides(strides);
#define SDK_DKV(DPV)                                                           \
  case DPV:                                                                    \
    return launch_dkv<DPV>(                                                    \
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),              \
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),           \
        static_cast<const float*>(lse), static_cast<const float*>(delta),      \
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H, Sq, Skv, D, st,  \
        scale_log2, scale, s);
  switch ((D + 15) / 16 * 16) {
    SDK_DKV(16)
    SDK_DKV(32)
    SDK_DKV(48)
    SDK_DKV(64)
    SDK_DKV(80)
    SDK_DKV(96)
    SDK_DKV(112)
    SDK_DKV(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SDK_DKV
}
