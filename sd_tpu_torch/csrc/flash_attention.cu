// Flash-attention forward (bf16 in, bf16 out, fp32 softmax state) on
// `mma.sync`, the template of the flash forwards the Hopper kernels do not
// serve: the LSE (training) forward and the pipelined sweep at head dims up
// to 128 (the wrapper's `launch_plan` decides). The serial sweep at every
// head dim, the int8 PV and the pipelined sweep above 128 now run
// `flash_attention_sm90.cu`, `flash_attention_sm90_pv8.cu` and
// `flash_attention_wide.cu`; their instantiations here remain as the
// yardstick those kernels are timed against in the same run.
//
// Replaces the TPU kernels `_flash_kernel` (sd_tpu/kernels/flash_attention.py:66,
// the [B*H, S, D] forward behind `flash_attention`) and `_flash_hpacked_kernel`
// (:293, the projection-native [B, S, H*D] forward behind
// `flash_attention_hpacked`) there. Both become this one kernel over strided
// [B, S, H, D] views: the head stride is D for a [B, S, H*D] projection and
// the row stride is H*D, so no layout copy enters or leaves either caller.
// Compiled with LSE = true it also replaces `_flash_kernel_lse` (:421), the
// training forward: the same sweep, plus the base-2 row log-sum-exp
// lse2 = m + log2(l) (NEG where l = 0) written to a [B*H, Sq] fp32 array for
// the backward kernels (`flash_attention_bwd.cu`). Its bound is the same.
// Compiled with PIPE = true it replaces `_flash_kernel_pipelined` (:123, the
// opt-in `SD_TPU_FLASH_PIPE=1` variant of `_flash_kernel`): the kv sweep runs
// one extra drain step, and step j issues Q K_j^T and the exp2 of tile j
// before P_{j-1} V_{j-1}, with two P tiles and two rescale vectors in shared
// memory. The softmax of tile j and the PV product of tile j-1 touch disjoint
// buffers, so no barrier separates them: warps that finish their exp2 go on to
// the tensor cores while others are still exponentiating, and a step has three
// barriers instead of four. The arithmetic and the rounding of P are the
// serial kernel's, in the same order, so the output is the same bits.
//
// Compiled with EXPB = true (the inference switch SD_TPU_FLASH_EXP=bf16, the
// TPU kernels' p_dtype = bfloat16, serial and pipelined sweeps) the softmax
// exponential runs as the TPU package computes jnp.exp2 on a bf16 operand:
// XLA lowers it to exp(x * ln2) with the operand and the product in bf16,
// and keeps the exponential's fp32 result where it is read in fp32, so
//   p = exp(bf16(bf16(s - m_new) * bf16(ln2)))     bf16(ln2) = 0.69140625
// (about 0.25% below 2^x per unit of |x|: the constant itself is rounded).
// From there p goes the fp32 sweep's way: summed in fp32, rounded to bf16
// for the PV product; corr = exp2f(m_prev - m_new) stays fp32. Hopper's
// ex2.approx.bf16x2 computes 2^x, a different function, so the kernel
// evaluates the exponential in fp32.
// The int8 PV variant (SD_TPU_FLASH_PV=int8, the TPU kernels' `_pv_int8`,
// serial sweep only) is its own kernel, `flash_fwd_pv8_kernel`, because the
// quantization spans the TPU kernel's kv tile T (`block_k`: 1024 rows
// head-packed, 512 at d = 512, the wrapper passes it), not this kernel's
// 64-row tile. Per T-row super-tile:
//   * a pre-pass launch (`v_scale_kernel`) writes each head-dim column's
//     vs = max|v| / 127 over the T rows, [B*H, ceil(Skv/T), D] fp32;
//   * pass 1 sweeps the super-tile's 64-row sub-tiles for the row max m
//     over all T columns; O and l are rescaled by corr = exp2(m_prev - m)
//     once;
//   * pass 2 recomputes S bit for bit, p = exp2(s - m) (or EXPB's),
//     p_i8 = trunc(p * 127 + 0.5), v_i8 = round-half-even(v / max(vs, 1e-30))
//     in place in the bytes of the bf16 V^T tile, the sub-tile's int32
//     product on the int8 tensor cores (mma.sync m16n8k32 s8.s8.s32) enters
//     O as float(acc) * (vs / 127) (within fp32 rounding of the TPU kernel's
//     one int32 sum over T rows, which is exact: |sum| < 127^2 * 1024 < 2^24),
//     and the integer row sum of p_i8 enters l once, as sum / 127.
// S is computed twice, so the variant costs more than the serial sweep.
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

template <int DP, int BQ, int BK, int CW, bool PIPE = false, bool PV8 = false>
struct Cfg {
  static constexpr int kDP = DP, kBQ = BQ, kBK = BK, kCW = CW;
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
  static constexpr int NP = PIPE ? 2 : 1;      // P tiles and rescale vectors
  static constexpr int NVS = PV8 ? 2 * DP : 0; // per-column vs / 127 and max(vs, 1e-30)
  static constexpr int PS8 = BK + 16;          // byte row stride of the int8 P
  static constexpr int VS8 = VS * 2;           // byte row stride of the int8 V^T
  static constexpr size_t SMEM =
      (size_t)(BQ * SS + (2 + NP) * BQ + NVS) * 4 +
      (size_t)(BQ * QS + BK * QS + DP * VS + NP * BQ * VS) * 2;
  static_assert(DP % 16 == 0 && OCOLS % 8 == 0, "head tiling");
  static_assert(BK % (8 * CW) == 0 && 32 % TPR == 0 && BK % TPR == 0, "tiling");
  static_assert(!PV8 || (!PIPE && BK % 32 == 0 && PS8 <= 2 * VS), "int8 PV tiling");
};

// sd_tpu's jnp.exp2 on a bf16 operand: exp(bf16(bf16(x) * bf16(ln2))), in fp32
__device__ __forceinline__ float exp2_bf16(float x) {
  const float xb = __bfloat162float(__float2bfloat16_rn(x));
  return expf(__bfloat162float(__float2bfloat16_rn(__fmul_rn(xb, 0.69140625f))));
}

// four consecutive int8 values as one 32-bit register
__device__ __forceinline__ uint32_t ld32_s8(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A B on the int8 tensor cores, A 16x32 row-major, B 32x8 "col", int32
// accumulate. Fragments (PTX ISA, "Matrix fragments for mma.m16n8k32"), with
// g = lane / 4, t = lane % 4, four s8 values per register:
//   a0 = A[g][4t..4t+3]   a1 = A[g+8][4t..4t+3]
//   a2 = A[g][4t+16..]    a3 = A[g+8][4t+16..]
//   b0 = B[4t..4t+3][g]   b1 = B[4t+16..4t+19][g]
//   d0,d1 = D[g][2t..2t+1]   d2,d3 = D[g+8][2t..2t+1]
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// V rows [v0, v0 + BK) transposed into V^T [d][kv] (row stride VS); rows at
// or past Skv are written as zeros
template <class C>
__device__ __forceinline__ void load_vt(bf16* Vt, const bf16* vb, long long v_ss, int v0,
                                        int Skv, int D) {
  const int dv = D / 8;
  for (int idx = threadIdx.x; idx < C::kBK * dv; idx += C::THREADS) {
    const int r = idx / dv, c = (idx - r * dv) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (v0 + r < Skv)
      val = *reinterpret_cast<const uint4*>(vb + (long long)(v0 + r) * v_ss + c);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int u = 0; u < 8; ++u) Vt[(c + u) * C::VS + r] = e[u];
  }
}

// S = Q K^T for warp (rg, cg): its 16 rows x SNT n8 tiles, scaled into base
// 2, written to the fp32 S tile
template <class C>
__device__ __forceinline__ void qk_to_smem(float* Ss, const bf16* Qs, const bf16* Ks, int rg,
                                           int cg, int g, int t, float scale_log2) {
  float sacc[C::SNT][4];
#pragma unroll
  for (int i = 0; i < C::SNT; ++i) sacc[i][0] = sacc[i][1] = sacc[i][2] = sacc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::kDP / 16; ++kk) {
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

template <int DP, int BQ, int BK, int CW, bool LSE, bool PIPE, bool EXPB>
__global__ void __launch_bounds__(Cfg<DP, BQ, BK, CW, PIPE>::THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H,
                 int Sq, int Skv, int D, long long q_sb, long long q_ss,
                 long long q_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, long long o_sb, long long o_ss,
                 long long o_sh, float scale_log2) {
  using C = Cfg<DP, BQ, BK, CW, PIPE>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ss = reinterpret_cast<float*>(smem);
  float* m_s = Ss + BQ * C::SS;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;               // NP rescale vectors of BQ
  bf16* Qs = reinterpret_cast<bf16*>(c_s + C::NP * BQ);
  bf16* Ks = Qs + BQ * C::QS;
  bf16* Vt = Ks + BK * C::QS;
  bf16* Ps = Vt + DP * C::VS;          // NP P tiles of BQ x VS

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

  const int n_kv = (Skv + BK - 1) / BK;
  // serial: step j is QK, softmax and PV of tile j; pipelined: QK and
  // softmax of tile j, PV of tile j - 1, and one drain step at the end
  for (int j = 0; j < n_kv + (PIPE ? 1 : 0); ++j) {
    const int jp = PIPE ? j - 1 : j;     // the tile whose PV runs this step
    const bool qk_step = j < n_kv, pv_step = jp >= 0;
    const int j0 = j * BK;
    bf16* Pw = Ps + (PIPE ? (j & 1) : 0) * BQ * C::VS;
    float* cw = c_s + (PIPE ? (j & 1) : 0) * BQ;
    const bf16* Pr = Ps + (PIPE ? (jp & 1) : 0) * BQ * C::VS;
    const float* cr = c_s + (PIPE ? (jp & 1) : 0) * BQ;

    // ---- K tile j row-major, V tile jp transposed to [d][kv] -------------
    if (qk_step) load_rows<BK, C::QS, C::THREADS>(Ks, kb, k_ss, j0, Skv, D);
    if (pv_step) load_vt<C>(Vt, vb, v_ss, jp * BK, Skv, D);
    __syncthreads();

    // ---- S = Q K^T (scaled into base 2) --------------------------------
    if (qk_step) qk_to_smem<C>(Ss, Qs, Ks, rg, cg, g, t, scale_log2);
    __syncthreads();

    // ---- online softmax of tile j: TPR neighbouring lanes per row ---------
    if (qk_step) {
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
        const float p = EXPB ? exp2_bf16(vals[i] - m_new) : exp2f(vals[i] - m_new);
        sum += p;
        Pw[row * C::VS + sub + i * C::TPR] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = C::TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (sub == 0) {
        const float corr = exp2f(m_prev - m_new);
        cw[row] = corr;
        l_s[row] = corr * l_s[row] + sum;
        m_s[row] = m_new;
      }
    }
    // serial: PV reads the P just written; pipelined: it reads the other tile
    if (!PIPE) __syncthreads();

    // ---- O = O * corr + P V of tile jp -------------------------------------
    if (pv_step) {
      const float c_lo = cr[rg * 16 + g], c_hi = cr[rg * 16 + g + 8];
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
        sdk::load_a(a, Pr, C::VS, rg * 16, kk * 16, g, t);
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

// vs = max|v| / 127 of every head-dim column over each T-row kv super-tile:
// [B*H, ceil(Skv / T), D] fp32 (rows past Skv count as zeros). Block
// (super-tile, b*H + h): 8 row groups x 32 columns at a time.
__global__ void __launch_bounds__(256)
v_scale_kernel(const bf16* __restrict__ v, float* __restrict__ vs, int H, int Skv, int D,
               int T, long long v_sb, long long v_ss, long long v_sh) {
  __shared__ float red[8][32];
  const int st = blockIdx.x, n_st = gridDim.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int lane = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const int r0 = st * T, r1 = min(r0 + T, Skv);
  for (int c0 = 0; c0 < D; c0 += 32) {
    const int c = c0 + lane;
    float mx = 0.f;
    if (c < D)
      for (int r = r0 + ty; r < r1; r += 8)
        mx = fmaxf(mx, fabsf(__bfloat162float(vb[(long long)r * v_ss + c])));
    red[ty][lane] = mx;
    __syncthreads();
    if (ty == 0 && c < D) {
#pragma unroll
      for (int i = 1; i < 8; ++i) mx = fmaxf(mx, red[i][lane]);
      vs[((long long)blockIdx.y * n_st + st) * D + c] = mx / 127.f;
    }
    __syncthreads();
  }
}

// The int8 PV forward (serial sweep): per T-row super-tile, a pass for the
// row max, then the sweep that quantizes p and V against the super-tile's
// max and column scales (see the note at the top). Layout as
// flash_fwd_kernel's, plus the super-tile's vs / 127 and max(vs, 1e-30) per
// column; V^T is quantized in place (row d at byte d * VS8) and P written as
// int8 into the P tile's bytes (row stride PS8).
template <int DP, int BQ, int BK, int CW, bool EXPB>
__global__ void __launch_bounds__(Cfg<DP, BQ, BK, CW, false, true>::THREADS)
flash_fwd_pv8_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     const float* __restrict__ vscale, int H, int Sq, int Skv, int D, int T,
                     long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, long long o_sb, long long o_ss, long long o_sh,
                     float scale_log2) {
  using C = Cfg<DP, BQ, BK, CW, false, true>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ss = reinterpret_cast<float*>(smem);
  float* m_s = Ss + BQ * C::SS;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;
  float* vsc_s = c_s + BQ;             // vs / 127 per column
  float* vden_s = vsc_s + DP;          // max(vs, 1e-30) per column
  bf16* Qs = reinterpret_cast<bf16*>(vden_s + DP);
  bf16* Ks = Qs + BQ * C::QS;
  bf16* Vt = Ks + BK * C::QS;
  int8_t* Vt8 = reinterpret_cast<int8_t*>(Vt);
  int8_t* P8 = reinterpret_cast<int8_t*>(Vt + DP * C::VS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / CW, cg = warp % CW;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int row = tid / C::TPR, sub = tid % C::TPR;   // this thread's softmax row

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  bf16* ob = o + b * o_sb + h * o_sh;
  const int n_st = (Skv + T - 1) / T;
  const float* vsb = vscale + (long long)blockIdx.y * n_st * D;

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
  for (int i = 0; i < C::ONT; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;

  for (int st = 0; st < n_st; ++st) {
    const int s0 = st * T, s1 = min(s0 + T, Skv);

    // ---- pass 1: the row max over the super-tile's T columns -------------
    float mx = NEG;
    for (int j0 = s0; j0 < s1; j0 += BK) {
      load_rows<BK, C::QS, C::THREADS>(Ks, kb, k_ss, j0, Skv, D);
      __syncthreads();
      qk_to_smem<C>(Ss, Qs, Ks, rg, cg, g, t, scale_log2);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < C::VPT; ++i) {
        const int col = sub + i * C::TPR;
        if (col < Skv - j0) mx = fmaxf(mx, Ss[row * C::SS + col]);
      }
    }
#pragma unroll
    for (int off = C::TPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (sub == 0) {
      const float m_prev = m_s[row], m_new = fmaxf(m_prev, mx);
      const float corr = exp2f(m_prev - m_new);
      c_s[row] = corr;
      m_s[row] = m_new;
      l_s[row] *= corr;
    }
    for (int i = tid; i < DP; i += C::THREADS) {
      const float vs = i < D ? vsb[st * D + i] : 0.f;
      vsc_s[i] = vs / 127.f;
      vden_s[i] = fmaxf(vs, 1e-30f);
    }
    __syncthreads();
    {
      const float c_lo = c_s[rg * 16 + g], c_hi = c_s[rg * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < C::ONT; ++nt) {
        oacc[nt][0] *= c_lo;
        oacc[nt][1] *= c_lo;
        oacc[nt][2] *= c_hi;
        oacc[nt][3] *= c_hi;
      }
    }
    const float m_row = m_s[row];

    // ---- pass 2: S again, int8 p and V, int8 P V into O ---------------------
    int isum = 0;
    for (int j0 = s0; j0 < s1; j0 += BK) {
      load_rows<BK, C::QS, C::THREADS>(Ks, kb, k_ss, j0, Skv, D);
      load_vt<C>(Vt, vb, v_ss, j0, Skv, D);
      __syncthreads();
      // V^T quantized per row (one head-dim column) against the super-tile's
      // scale: a warp owns whole rows, reads them, then rewrites each as int8
      // in its own first BK bytes; the barrier after QK orders it before PV
      {
        constexpr int PER = BK / 32;
        for (int r = warp; r < DP; r += C::WARPS) {
          float vals[PER];
#pragma unroll
          for (int i = 0; i < PER; ++i) vals[i] = __bfloat162float(Vt[r * C::VS + lane + 32 * i]);
          const float den = vden_s[r];
          __syncwarp();
#pragma unroll
          for (int i = 0; i < PER; ++i)
            Vt8[r * C::VS8 + lane + 32 * i] = (int8_t)__float2int_rn(vals[i] / den);
        }
      }
      qk_to_smem<C>(Ss, Qs, Ks, rg, cg, g, t, scale_log2);
      __syncthreads();
      {
        const int valid = Skv - j0;
#pragma unroll
        for (int i = 0; i < C::VPT; ++i) {
          const int col = sub + i * C::TPR;
          const float s = col < valid ? Ss[row * C::SS + col] : NEG;
          const float p = EXPB ? exp2_bf16(s - m_row) : exp2f(s - m_row);
          const int q8 = (int)__fadd_rn(__fmul_rn(p, 127.f), 0.5f);   // trunc, p >= 0
          isum += q8;
          P8[row * C::PS8 + col] = (int8_t)q8;
        }
      }
      __syncthreads();
      uint32_t a[BK / 32][4];
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const int8_t* pa = P8 + (rg * 16 + g) * C::PS8 + kk * 32 + 4 * t;
        a[kk][0] = ld32_s8(pa);
        a[kk][1] = ld32_s8(pa + 8 * C::PS8);
        a[kk][2] = ld32_s8(pa + 16);
        a[kk][3] = ld32_s8(pa + 8 * C::PS8 + 16);
      }
#pragma unroll
      for (int nt = 0; nt < C::ONT; ++nt) {
        int acc[4] = {0, 0, 0, 0};
        const int n0 = cg * C::OCOLS + nt * 8;
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          const int8_t* pb = Vt8 + (n0 + g) * C::VS8 + kk * 32 + 4 * t;
          mma_s8_16832(acc, a[kk], ld32_s8(pb), ld32_s8(pb + 16));
        }
        const float s0v = vsc_s[n0 + 2 * t], s1v = vsc_s[n0 + 2 * t + 1];
        oacc[nt][0] += (float)acc[0] * s0v;
        oacc[nt][1] += (float)acc[1] * s1v;
        oacc[nt][2] += (float)acc[2] * s0v;
        oacc[nt][3] += (float)acc[3] * s1v;
      }
      __syncthreads();
    }
#pragma unroll
    for (int off = C::TPR / 2; off > 0; off >>= 1)
      isum += __shfl_xor_sync(0xffffffffu, isum, off);
    if (sub == 0) l_s[row] += (float)isum / 127.f;
  }
  __syncthreads();

  const int r_lo = rg * 16 + g, r_hi = r_lo + 8;
  const float inv_lo = 1.f / fmaxf(l_s[r_lo], 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_s[r_hi], 1e-30f);
#pragma unroll
  for (int nt = 0; nt < C::ONT; ++nt) {
    const int col = cg * C::OCOLS + nt * 8 + 2 * t;
    if (col < D) {
      if (q0 + r_lo < Sq)
        sdk::st32(ob + (long long)(q0 + r_lo) * o_ss + col, oacc[nt][0] * inv_lo,
                  oacc[nt][1] * inv_lo);
      if (q0 + r_hi < Sq)
        sdk::st32(ob + (long long)(q0 + r_hi) * o_ss + col, oacc[nt][2] * inv_hi,
                  oacc[nt][3] * inv_hi);
    }
  }
}

template <int DP, int BQ, int BK, int CW, bool LSE = false, bool PIPE = false,
          bool EXPB = false>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
           int B, int H, int Sq, int Skv, int D, const long long* st,
           float scale_log2, cudaStream_t stream) {
  using C = Cfg<DP, BQ, BK, CW, PIPE>;
  auto kern = flash_fwd_kernel<DP, BQ, BK, CW, LSE, PIPE, EXPB>;
  SDK_SET_SMEM(kern, C::SMEM);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      q, k, v, o, lse, H, Sq, Skv, D, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

// the int8 PV forward: the V-scale pre-pass, then the two-pass sweep
template <int DP, int BQ, int BK, int CW, bool EXPB>
int launch_pv8(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* vscale, int B,
               int H, int Sq, int Skv, int D, int T, const long long* st, float scale_log2,
               cudaStream_t stream) {
  if (T <= 0 || T % BK) return (int)cudaErrorInvalidValue;
  using C = Cfg<DP, BQ, BK, CW, false, true>;
  const int n_st = (Skv + T - 1) / T;
  v_scale_kernel<<<dim3(n_st, B * H), 256, 0, stream>>>(v, vscale, H, Skv, D, T, st[6],
                                                         st[7], st[8]);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  auto kern = flash_fwd_pv8_kernel<DP, BQ, BK, CW, EXPB>;
  SDK_SET_SMEM(kern, C::SMEM);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      q, k, v, o, vscale, H, Sq, Skv, D, T, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

template <int DP, int BQ, int BK, int CW, bool PIPE, bool EXPB, bool PV8>
int run(const bf16* Q, const bf16* K, const bf16* V, bf16* O, float* vscale, int B, int H,
        int Sq, int Skv, int D, int T, const long long* strides, float scale_log2,
        cudaStream_t s) {
  if constexpr (PV8)
    return launch_pv8<DP, BQ, BK, CW, EXPB>(Q, K, V, O, vscale, B, H, Sq, Skv, D, T, strides,
                                            scale_log2, s);
  else
    return launch<DP, BQ, BK, CW, false, PIPE, EXPB>(Q, K, V, O, nullptr, B, H, Sq, Skv, D,
                                                     strides, scale_log2, s);
}

template <bool PIPE, bool EXPB, bool PV8>
int fwd(const bf16* Q, const bf16* K, const bf16* V, bf16* O, float* vscale, int B, int H,
        int Sq, int Skv, int D, int T, const long long* strides, float scale_log2,
        cudaStream_t s) {
  switch ((D + 15) / 16 * 16) {
#define SDK_SMALL(DPV) \
  case DPV:            \
    return run<DPV, 64, 64, 1, PIPE, EXPB, PV8>(Q, K, V, O, vscale, B, H, Sq, Skv, D, T, strides, scale_log2, s);
    SDK_SMALL(16)
    SDK_SMALL(32)
    SDK_SMALL(48)
    SDK_SMALL(64)
    SDK_SMALL(80)
    SDK_SMALL(96)
    SDK_SMALL(112)
    SDK_SMALL(128)
#undef SDK_SMALL
    default:
      break;
  }
  if (D <= 256)
    return run<256, 32, 64, 4, PIPE, EXPB, PV8>(Q, K, V, O, vscale, B, H, Sq, Skv, D, T, strides, scale_log2, s);
  if (D <= 512)
    return run<512, 32, 64, 4, PIPE, EXPB, PV8>(Q, K, V, O, vscale, B, H, Sq, Skv, D, T, strides, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: [B, S, H, D] bf16 views with unit stride along D; `strides`
// holds (batch, row, head) strides in elements for q, k, v, o in that order.
// pipelined = 1 runs the software-pipelined kv sweep (same output bits);
// exp_bf16 = 1 the bf16 softmax exponential, pv_int8 = 1 the int8 PV product
// (serial sweep only: pipelined with pv_int8 is refused) quantized over kv
// super-tiles of block_k rows (a multiple of 64), with `vscale` a
// [B*H, ceil(Skv / block_k), D] fp32 scratch for the column scales (both
// unused without pv_int8).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int sd_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int Sq, int Skv, int D,
                            const long long* strides, float scale_log2,
                            int pipelined, int exp_bf16, int pv_int8, int block_k,
                            void* vscale, void* stream) {
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(o);
  float* VS = static_cast<float*>(vscale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDK_FWD(P, E, I) \
  fwd<P, E, I>(Q, K, V, O, VS, B, H, Sq, Skv, D, block_k, strides, scale_log2, s)
  if (pipelined) {
    if (pv_int8) return (int)cudaErrorInvalidValue;
    return exp_bf16 ? SDK_FWD(true, true, false) : SDK_FWD(true, false, false);
  }
  if (pv_int8) return exp_bf16 ? SDK_FWD(false, true, true) : SDK_FWD(false, false, true);
  return exp_bf16 ? SDK_FWD(false, true, false) : SDK_FWD(false, false, false);
#undef SDK_FWD
}

// The training forward: as sd_flash_fwd, plus lse2 [B*H, Sq] fp32 (row
// b*H + h). Head dims up to 512, as the backward kernels take. Above 128
// the O tile is split over CW = 4 column warps, and each row's m and l live
// in shared memory, so its lse2 is written once, by one thread.
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
      break;
  }
  if (D <= 256)
    return launch<256, 32, 64, 4, true>(Q, K, V, O, L, B, H, Sq, Skv, D, strides, scale_log2, s);
  if (D <= 512)
    return launch<512, 32, 64, 4, true>(Q, K, V, O, L, B, H, Sq, Skv, D, strides, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

namespace {
template <bool PIPE, bool PV8>
size_t smem_of(int dp) {
  switch (dp) {
#define SDK_SMEM(DPV) \
  case DPV:           \
    return Cfg<DPV, 64, 64, 1, PIPE, PV8>::SMEM;
    SDK_SMEM(16)
    SDK_SMEM(32)
    SDK_SMEM(48)
    SDK_SMEM(64)
    SDK_SMEM(80)
    SDK_SMEM(96)
    SDK_SMEM(112)
    SDK_SMEM(128)
#undef SDK_SMEM
    default:
      break;
  }
  return dp <= 256 ? Cfg<256, 32, 64, 4, PIPE, PV8>::SMEM : Cfg<512, 32, 64, 4, PIPE, PV8>::SMEM;
}
}  // namespace

// Dynamic shared memory (bytes) of the inference launch sd_flash_fwd makes
// for head dim D (the build report).
extern "C" int sd_flash_fwd_smem(int D, int pipelined, int pv_int8) {
  const int dp = (D + 15) / 16 * 16;
  if (pipelined) return (int)smem_of<true, false>(dp);
  return (int)(pv_int8 ? smem_of<false, true>(dp) : smem_of<false, false>(dp));
}
