// Flash-attention forward for Hopper (bf16 in, bf16 out, fp32 softmax state).
//
// Replaces the TPU kernels `_flash_kernel` (sd_tpu/kernels/flash_attention.py:66,
// the [B*H, S, D] forward behind `flash_attention`) and `_flash_hpacked_kernel`
// (:293, the projection-native [B, S, H*D] forward behind
// `flash_attention_hpacked`). Both become this one kernel over strided
// [B, S, H, D] views: the head stride is D for a [B, S, H*D] projection and
// the row stride is H*D, so no layout copy enters or leaves either caller.
// Compiled with LSE = true it also replaces `_flash_kernel_lse` (:421), the
// training forward: the same sweep, plus the base-2 row log-sum-exp
// lse2 = m + log2(l) (NEG where l = 0) written to a [B*H, Sq] fp32 array for
// the backward kernels (`flash_attention_bwd.cu`). Its bound is the same.
//
// Math (the TPU kernel's): non-causal softmax(q k^T * scale) v with the
// softmax in base 2 (log2(e) folded into the scale, exp2f), running max m,
// running sum l and the output accumulator in fp32, p rounded to bf16 before
// the p v product, the ragged last kv tile masked to -1e30, and the output
// divided by max(l, 1e-30).
//
// What bounds it on the H100: at the UNet shapes (S=4096/1024, d=40/80) the
// work is 4*S^2*d flops per head against 8*S*d bytes, far above the card's
// ~295 flop/byte ridge, so it is bound by operations: tensor-core products
// and, at d=40, the exponentials (one exp2 per 2*2*d flops of mma).
// What the design does about it: both products run on the tensor cores
// (mma.sync m16n8k16, fp32 accumulate); a block keeps a BQ-row q tile for its
// whole kv sweep so K/V stream from L2 once per q tile, not once per row;
// the logits never reach device memory. The head dim is zero-padded to a
// multiple of 16 in shared memory only (d=40 -> 48). It is the simple form:
// no cp.async/TMA pipelining and no wgmma yet (later work, see PERF.md).
//
// Layout of one block (blockIdx.x = q tile, blockIdx.y = b*H + h):
//   RG = BQ/16 row groups x CW column groups of warps. Warp (rg, cg) computes
//   S[16 rows of rg][BK/CW columns] and owns O[16 rows of rg][DP/CW columns].
//   S goes through shared memory (fp32) so any thread layout can run the
//   online softmax; P goes back through shared memory as bf16.
//   d=512 (the VAE mid-block) uses BQ=32 and CW=4: its fp32 O tile is split
//   across four warps' registers (64 floats each) instead of one.
#include "common.cuh"

namespace {

using sdk::bf16;

constexpr float NEG = -1e30f;

template <int DP, int BQ, int BK, int CW>
struct Cfg {
  static constexpr int RG = BQ / 16;
  static constexpr int WARPS = RG * CW;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int QS = DP + 8;    // bf16 row stride of the Q and K tiles
  static constexpr int VS = BK + 8;    // bf16 row stride of V^T and P
  static constexpr int SS = BK + 8;    // fp32 row stride of S
  static constexpr int OCOLS = DP / CW;
  static constexpr int ONT = OCOLS / 8;       // n8 tiles of O per warp
  static constexpr int SNT = BK / 8 / CW;     // n8 tiles of S per warp
  static constexpr int TPR = THREADS / BQ;    // softmax threads per row
  static constexpr int VPT = BK / TPR;        // softmax values per thread
  static constexpr size_t SMEM =
      (size_t)(BQ * SS + 3 * BQ) * 4 +
      (size_t)(BQ * QS + BK * QS + DP * VS + BQ * VS) * 2;
  static_assert(DP % 16 == 0 && OCOLS % 8 == 0, "head tiling");
  static_assert(BK % (8 * CW) == 0 && 32 % TPR == 0 && BK % TPR == 0, "tiling");
};

// rows [r0, r0+R) x columns [0, D) of a strided bf16 matrix into shared
// memory (row stride LD); rows at or past n are written as zeros.
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

template <int DP, int BQ, int BK, int CW, bool LSE>
__global__ void __launch_bounds__(Cfg<DP, BQ, BK, CW>::THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H,
                 int Sq, int Skv, int D, long long q_sb, long long q_ss,
                 long long q_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, long long o_sb, long long o_ss,
                 long long o_sh, float scale_log2) {
  using C = Cfg<DP, BQ, BK, CW>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ss = reinterpret_cast<float*>(smem);
  float* m_s = Ss + BQ * C::SS;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;
  bf16* Qs = reinterpret_cast<bf16*>(c_s + BQ);
  bf16* Ks = Qs + BQ * C::QS;
  bf16* Vt = Ks + BK * C::QS;
  bf16* Ps = Vt + DP * C::VS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / CW, cg = warp % CW;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  bf16* ob = o + b * o_sb + h * o_sh;

  // zero the padded head columns once: loads only ever write columns < D
  for (int i = tid; i < BQ * C::QS; i += C::THREADS) Qs[i] = __float2bfloat16(0.f);
  for (int i = tid; i < BK * C::QS; i += C::THREADS) Ks[i] = __float2bfloat16(0.f);
  for (int i = tid; i < DP * C::VS; i += C::THREADS) Vt[i] = __float2bfloat16(0.f);
  for (int i = tid; i < BQ; i += C::THREADS) {
    m_s[i] = NEG;
    l_s[i] = 0.f;
  }
  __syncthreads();
  load_rows<BQ, C::QS, C::THREADS>(Qs, qb, q_ss, q0, Sq, D);

  float oacc[C::ONT][4];
#pragma unroll
  for (int i = 0; i < C::ONT; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;

  const int dv = D / 8;
  for (int j0 = 0; j0 < Skv; j0 += BK) {
    // ---- K tile row-major, V tile transposed to [d][kv] ----------------
    load_rows<BK, C::QS, C::THREADS>(Ks, kb, k_ss, j0, Skv, D);
    for (int idx = tid; idx < BK * dv; idx += C::THREADS) {
      const int r = idx / dv, c = (idx - r * dv) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + r < Skv)
        val = *reinterpret_cast<const uint4*>(vb + (long long)(j0 + r) * v_ss + c);
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int u = 0; u < 8; ++u) Vt[(c + u) * C::VS + r] = e[u];
    }
    __syncthreads();

    // ---- S = Q K^T (scaled into base 2) --------------------------------
    {
      float sacc[C::SNT][4];
#pragma unroll
      for (int i = 0; i < C::SNT; ++i)
        sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        sdk::load_a(a, Qs, C::QS, rg * 16, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < C::SNT; ++nt) {
          const bf16* p = Ks + ((cg * C::SNT + nt) * 8 + g) * C::QS + kk * 16 + 2 * t;
          sdk::mma_16816(sacc[nt], a, sdk::ld32(p), sdk::ld32(p + 8));
        }
      }
      const int row = rg * 16 + g;
#pragma unroll
      for (int nt = 0; nt < C::SNT; ++nt) {
        const int col = (cg * C::SNT + nt) * 8 + 2 * t;
        Ss[row * C::SS + col] = sacc[nt][0] * scale_log2;
        Ss[row * C::SS + col + 1] = sacc[nt][1] * scale_log2;
        Ss[(row + 8) * C::SS + col] = sacc[nt][2] * scale_log2;
        Ss[(row + 8) * C::SS + col + 1] = sacc[nt][3] * scale_log2;
      }
    }
    __syncthreads();

    // ---- online softmax: TPR neighbouring lanes per row ------------------
    {
      const int row = tid / C::TPR, sub = tid % C::TPR;
      const int valid = Skv - j0;
      float vals[C::VPT];
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < C::VPT; ++i) {
        const int col = sub + i * C::TPR;
        const float s = col < valid ? Ss[row * C::SS + col] : NEG;
        vals[i] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = C::TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < C::VPT; ++i) {
        const float p = exp2f(vals[i] - m_new);
        sum += p;
        Ps[row * C::VS + sub + i * C::TPR] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = C::TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (sub == 0) {
        const float corr = exp2f(m_prev - m_new);
        c_s[row] = corr;
        l_s[row] = corr * l_s[row] + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

    // ---- O = O * corr + P V ----------------------------------------------
    {
      const float c_lo = c_s[rg * 16 + g], c_hi = c_s[rg * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < C::ONT; ++nt) {
        oacc[nt][0] *= c_lo;
        oacc[nt][1] *= c_lo;
        oacc[nt][2] *= c_hi;
        oacc[nt][3] *= c_hi;
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        sdk::load_a(a, Ps, C::VS, rg * 16, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < C::ONT; ++nt) {
          const bf16* p = Vt + (cg * C::OCOLS + nt * 8 + g) * C::VS + kk * 16 + 2 * t;
          sdk::mma_16816(oacc[nt], a, sdk::ld32(p), sdk::ld32(p + 8));
        }
      }
    }
    __syncthreads();
  }

  // ---- base-2 row log-sum-exp (training forward only) -------------------
  if (LSE) {
    for (int i = tid; i < BQ; i += C::THREADS)
      if (q0 + i < Sq)
        lse[(long long)blockIdx.y * Sq + q0 + i] =
            l_s[i] > 0.f ? m_s[i] + log2f(l_s[i]) : NEG;
  }

  // ---- O / l, bf16, strided store ----------------------------------------
  const int r_lo = rg * 16 + g, r_hi = r_lo + 8;
  const float inv_lo = 1.f / fmaxf(l_s[r_lo], 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_s[r_hi], 1e-30f);
#pragma unroll
  for (int nt = 0; nt < C::ONT; ++nt) {
    const int col = cg * C::OCOLS + nt * 8 + 2 * t;
    if (col < D) {
      if (q0 + r_lo < Sq)
        sdk::st32(ob + (long long)(q0 + r_lo) * o_ss + col,
                  oacc[nt][0] * inv_lo, oacc[nt][1] * inv_lo);
      if (q0 + r_hi < Sq)
        sdk::st32(ob + (long long)(q0 + r_hi) * o_ss + col,
                  oacc[nt][2] * inv_hi, oacc[nt][3] * inv_hi);
    }
  }
}

template <int DP, int BQ, int BK, int CW, bool LSE = false>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
           int B, int H, int Sq, int Skv, int D, const long long* st,
           float scale_log2, cudaStream_t stream) {
  using C = Cfg<DP, BQ, BK, CW>;
  auto kern = flash_fwd_kernel<DP, BQ, BK, CW, LSE>;
  SDK_SET_SMEM(kern, C::SMEM);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      q, k, v, o, lse, H, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, S, H, D] bf16 views with unit stride along D; `strides`
// holds (batch, row, head) strides in elements for q, k, v, o in that order.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int sd_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int Sq, int Skv, int D,
                            const long long* strides, float scale_log2,
                            void* stream) {
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = (D + 15) / 16 * 16;
#define SDK_SMALL(DPV) \
  case DPV:            \
    return launch<DPV, 64, 64, 1>(Q, K, V, O, nullptr, B, H, Sq, Skv, D, strides, scale_log2, s);
  switch (dp) {
    SDK_SMALL(16)
    SDK_SMALL(32)
    SDK_SMALL(48)
    SDK_SMALL(64)
    SDK_SMALL(80)
    SDK_SMALL(96)
    SDK_SMALL(112)
    SDK_SMALL(128)
    default:
      break;
  }
#undef SDK_SMALL
  if (D <= 256)
    return launch<256, 32, 64, 4>(Q, K, V, O, nullptr, B, H, Sq, Skv, D, strides, scale_log2, s);
  if (D <= 512)
    return launch<512, 32, 64, 4>(Q, K, V, O, nullptr, B, H, Sq, Skv, D, strides, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

// The training forward: as sd_flash_fwd, plus lse2 [B*H, Sq] fp32 (row
// b*H + h). Head dims up to 128 (the backward kernels' range).
extern "C" int sd_flash_fwd_lse(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int H, int Sq,
                                int Skv, int D, const long long* strides,
                                float scale_log2, void* stream) {
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(o);
  float* L = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
#define SDK_LSE(DPV) \
  case DPV:          \
    return launch<DPV, 64, 64, 1, true>(Q, K, V, O, L, B, H, Sq, Skv, D, strides, scale_log2, s);
    SDK_LSE(16)
    SDK_LSE(32)
    SDK_LSE(48)
    SDK_LSE(64)
    SDK_LSE(80)
    SDK_LSE(96)
    SDK_LSE(112)
    SDK_LSE(128)
#undef SDK_LSE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
