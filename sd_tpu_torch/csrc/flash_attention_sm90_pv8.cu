// The int8-PV flash-attention inference forward for Hopper at head dims up
// to 128 (bf16 q, k, v and output, fp32 softmax state, int8 PV product):
// the `_pv_int8` variant of the TPU kernels `_flash_kernel`
// (sd_tpu/kernels/flash_attention.py:66) and `_flash_hpacked_kernel` (:293),
// `_pv_int8` at :44, serial sweep, with the fp32 exponential or the bf16 one
// (EXPB, as in `flash_attention_sm90.cu`). Read through strided [B, S, H, D]
// views as `flash_attention_sm90.cu` reads them.
//
// Math (the TPU kernel's): the quantization spans the TPU kernel's kv tile T
// (`block_k`: 1024 rows head-packed, 256-1024 otherwise, a multiple of 64;
// the wrapper passes it). Per T-row super-tile:
//   * m is the running max including the whole super-tile; O and l are
//     rescaled once by corr = exp2(m_prev - m);
//   * p = exp2(s * scale - m) (or EXPB's), p_i8 = trunc(p * 127 + 0.5);
//   * v_i8 = round-half-even(v / max(vs, 1e-30)), vs = max|v| / 127 per
//     head-dim column over the super-tile (the pre-pass, `sm90.cuh`);
//   * O += float(sum over the T rows of p_i8 * v_i8) * vs / 127, one int32
//     sum per super-tile (exact: |sum| < 127^2 * 1024 < 2^24), and l +=
//     (sum of p_i8) / 127.
// The output is divided by max(l, 1e-30); kv columns past Skv are masked.
//
// What bounds it on the H100: the exponentials, as for the bf16 forward (one
// per logit; at [8, 4096, 8 x 40] 0.275 ms at 3.9e12/s, and 0.017 ms at
// [8, 1024, 8 x 80]); the PV product runs at the int8 rate and S is computed
// twice, so the tensor work is 1.5x the bf16 forward's at half of it on the
// int8 rate.
// What the design does about it: it is `flash_attention_sm90.cu`'s design
// (two consumer warpgroups of 64 q rows, S = Q K^T by wgmma in the
// accumulators, K by TMA into a 4-stage full/empty mbarrier ring refilled by
// thread 0, no block-wide barrier in the sweep) with two passes per
// super-tile over the same ring: the first takes the row max (products, no
// exponential), the second recomputes S bit for bit and runs the int8
// product with
//   * P quantized in the registers it is computed in, packed four to a
//     register as the k32 A fragment of `wgmma .s32.s8.s8` with no shuffle
//     (the pre-pass stores V's codes permuted within each 16-row kv group,
//     `perm16`, to match) and with no float-to-int conversion, which would
//     share the special-function units with the exponential (`q8_bits`);
//   * V's codes (written once by the pre-pass, K-major as the int8 B operand
//     needs, since 8-bit wgmma has no transposed mode) arriving by one 1-D
//     bulk copy per tile beside the K tile;
//   * the int32 accumulator kept across the super-tile's 64-row sub-tiles
//     and folded into O once (DP/2 registers a thread);
//   * the integer row sum kept per lane (one dp4a per four codes) and
//     folded across the quad at the end.
#include "sm90.cuh"

namespace {

constexpr int BQ = 128;        // q rows per block: two warpgroups of 64
constexpr int BK = 64;         // kv rows per step
constexpr int STAGES = 4;      // ring depth
constexpr int THREADS = 256;

template <int DP>
struct CfgPv8 {
  static constexpr int MINB = DP <= 48 ? 2 : 1;       // blocks per SM
  static constexpr int KBYTES = BK * DP * 2;          // a K tile (bf16)
  static constexpr int VBYTES = BK * DP;              // a V-code tile (int8)
  static constexpr int STAGE = KBYTES + VBYTES;
  static constexpr size_t SMEM =
      (size_t)BQ * DP * 2 + (size_t)STAGES * STAGE + (2 * STAGES + 1) * 8;
  static_assert(DP % 16 == 0 && DP <= 128, "head tiling");
};

// S = Q K^T of one K tile: this warpgroup's 64 rows x BK columns
template <int DP>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 2], const bf16* Qs, const bf16* Ks,
                                        int wg) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    Wgmma<BK>::ss(s, gmma_desc(Qs + cm_off<BQ>(64 * wg, 16 * kk), BQ * 16, 128),
                  gmma_desc(Ks + cm_off<BK>(0, 16 * kk), BK * 16, 128), kk > 0);
  wg_commit();
  wg_wait_all();
}

// the ragged last tile's columns past Skv at -inf
__device__ __forceinline__ void mask_tail(float (&s)[BK / 2], int valid, int t) {
  if (valid < BK) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if ((i >> 2) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
  }
}

template <int DP, bool EXPB>
__global__ void __launch_bounds__(THREADS, CfgPv8<DP>::MINB)
flash_fwd_sm90_pv8_kernel(const __grid_constant__ ViewMap mq, const __grid_constant__ ViewMap mk,
                          const int8_t* __restrict__ codes, const float* __restrict__ vmul,
                          bf16* __restrict__ o, int H, int Sq, int Skv, int D, int T,
                          long long o_sb, long long o_ss, long long o_sh, float scale_log2) {
  using C = CfgPv8<DP>;
  constexpr int ST = STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + BQ * DP * 2;   // stage i: K tile, then the V-code tile
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * C::STAGE);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int dv = D / 8;
  const int n_kv = (Skv + BK - 1) / BK;
  const int spt = T / BK;                     // sub-tiles of a whole super-tile
  const int n_st = (Skv + T - 1) / T;
  const int n_steps = 2 * n_kv;               // each sub-tile twice: max pass, product pass
  bf16* ob = o + b * o_sb + h * o_sh;
  const int8_t* cb = codes + (long long)bh * n_st * T * DP;
  const float* vmb = vmul + (long long)bh * n_st * DP;

  // pad chunks [D/8, DP/8) of Q and of every stage's K tile, zeroed once (no
  // copy writes them; Q K^T reads them)
  const int padc = (DP - D) / 8;
  for (int idx = tid; idx < padc * BQ; idx += THREADS) {
    const int c = dv + idx / BQ, r = idx % BQ;
    *reinterpret_cast<uint4*>(Qs + c * BQ * 8 + r * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int idx = tid; idx < padc * BK * ST; idx += THREADS) {
    const int s = idx / (padc * BK), rem = idx % (padc * BK);
    const int c = dv + rem / BK, r = rem % BK;
    *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(ring + s * C::STAGE) + c * BK * 8 + r * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, THREADS / 32);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();

  // ring step i: kv sub-tile j of super-tile i / (2 spt), in its max pass or
  // its product pass (which also brings the sub-tile's V codes)
  auto issue = [&](int i) {
    const int st = i / (2 * spt), r = i - st * 2 * spt;
    const int n_this = min(spt, n_kv - st * spt);
    const bool pv = r >= n_this;
    const int j = st * spt + (pv ? r - n_this : r);
    unsigned char* s = ring + (i % ST) * C::STAGE;
    mbar_expect_tx(full + i % ST, (uint32_t)dv * BK * 16 + (pv ? C::VBYTES : 0));
    load_rows_tma(mk, reinterpret_cast<bf16*>(s), BK, j * BK, b, h, dv, 0, 1, full + i % ST);
    if (pv) bulk_load(s + C::KBYTES, cb + (long long)j * BK * DP, C::VBYTES, full + i % ST);
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, (uint32_t)dv * BQ * 16);
    load_rows_tma(mq, Qs, BQ, q0, b, h, dv, 0, 1, qbar);
    for (int i = 0; i < ST && i < n_steps; ++i) issue(i);
  }
  // wait for step i's stage, refilling the stage step i - 2 used once every
  // warp is done with it
  auto acquire = [&](int i) {
    if (tid == 0 && i >= 2 && i - 2 + ST < n_steps) {
      mbar_wait(empty + (i - 2) % ST, ((i - 2) / ST) & 1);
      issue(i - 2 + ST);
    }
    __syncwarp();
    mbar_wait(full + i % ST, (i / ST) & 1);
  };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + i % ST);
  };

  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  int acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0;
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  uint32_t a[BK / 32][4];
  float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;   // rows g and g + 8
  mbar_wait(qbar, 0);

  int i = 0;
  for (int st = 0; st < n_st; ++st) {
    const int n_this = min(spt, n_kv - st * spt);

    // ---- pass 1: the row max over the super-tile (the scale is positive,
    // so the max of the raw logits scales to the max of the scaled ones) ----
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
    for (int jj = 0; jj < n_this; ++jj, ++i) {
      acquire(i);
      qk_tile<DP>(s, Qs, reinterpret_cast<const bf16*>(ring + (i % ST) * C::STAGE), wg);
      release(i);
      mask_tail(s, Skv - (st * spt + jj) * BK, t);
#pragma unroll
      for (int k = 0; k < BK / 2; k += 4) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[k], s[k + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[k + 2], s[k + 3]));
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2);
    const float mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
    const float c_lo = fast_exp2(m_lo - mn_lo), c_hi = fast_exp2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= c_lo;
    l_hi *= c_hi;
    if (__any_sync(0xffffffffu, c_lo != 1.f || c_hi != 1.f)) {
#pragma unroll
      for (int k = 0; k < DP / 2; ++k) oacc[k] *= (k & 2) ? c_hi : c_lo;
    }

    // ---- pass 2: S again, p_i8 in registers, the int8 product -------------
    int isum_lo = 0, isum_hi = 0;
    for (int jj = 0; jj < n_this; ++jj, ++i) {
      acquire(i);
      const unsigned char* stage = ring + (i % ST) * C::STAGE;
      qk_tile<DP>(s, Qs, reinterpret_cast<const bf16*>(stage), wg);
      mask_tail(s, Skv - (st * spt + jj) * BK, t);
#pragma unroll
      for (int k = 0; k < BK / 2; ++k) {
        const float x = fmaf(s[k], scale_log2, -((k & 2) ? m_hi : m_lo));
        s[k] = EXPB ? exp2_bf16(x) : fast_exp2(x);
      }
      pack_p_i8<BK / 32>(a, s, isum_lo, isum_hi);
      const int8_t* V8 = reinterpret_cast<const int8_t*>(stage + C::KBYTES);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        Wgmma8<DP>::rs(acc, a[kk], gmma_desc(V8 + kk * 2 * DP * 16, DP * 16, 128),
                       jj > 0 || kk > 0);
      wg_commit();
      wg_wait_all();
      release(i);
    }
    // ---- the super-tile's int32 sum into O, its p_i8 sum into l -----------
    const float* vm = vmb + st * DP;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const float2 mul = *reinterpret_cast<const float2*>(vm + nt * 8 + 2 * t);
      oacc[4 * nt] += (float)acc[4 * nt] * mul.x;
      oacc[4 * nt + 1] += (float)acc[4 * nt + 1] * mul.y;
      oacc[4 * nt + 2] += (float)acc[4 * nt + 2] * mul.x;
      oacc[4 * nt + 3] += (float)acc[4 * nt + 3] * mul.y;
    }
    l_lo += (float)isum_lo / 127.f;
    l_hi += (float)isum_hi / 127.f;
  }

  // ---- l across the quad, O / l, bf16, strided store -------------------------
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  const int r_lo = q0 + 64 * wg + 16 * wl + g, r_hi = r_lo + 8;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (col < D) {
      if (r_lo < Sq)
        sdk::st32(ob + (long long)r_lo * o_ss + col, oacc[4 * nt] * inv_lo,
                  oacc[4 * nt + 1] * inv_lo);
      if (r_hi < Sq)
        sdk::st32(ob + (long long)r_hi * o_ss + col, oacc[4 * nt + 2] * inv_hi,
                  oacc[4 * nt + 3] * inv_hi);
    }
  }
}

template <int DP, bool EXPB>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int8_t* codes, float* vmul,
           int B, int H, int Sq, int Skv, int D, int T, const long long* st, float scale_log2,
           cudaStream_t stream) {
  using C = CfgPv8<DP>;
  int e = launch_v_codes<DP>(v, codes, vmul, B, H, Skv, D, T, st + 6, stream);
  ViewMap mq, mk;
  if (!e) e = make_view_map(&mq, q, B, Sq, H, D, st[0], st[1], st[2], BQ);
  if (!e) e = make_view_map(&mk, k, B, Skv, H, D, st[3], st[4], st[5], BK);
  if (e) return e;
  auto kern = flash_fwd_sm90_pv8_kernel<DP, EXPB>;
  SDK_SET_SMEM(kern, C::SMEM);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, C::SMEM, stream>>>(mq, mk, codes, vmul, o, H, Sq, Skv, D, T, st[9],
                                           st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

template <bool EXPB>
int fwd(const bf16* Q, const bf16* K, const bf16* V, bf16* O, int8_t* codes, float* vmul, int B,
        int H, int Sq, int Skv, int D, int T, const long long* strides, float scale_log2,
        cudaStream_t s) {
  switch ((D + 15) / 16 * 16) {
#define SDK_DP(DPV) \
  case DPV:         \
    return launch<DPV, EXPB>(Q, K, V, O, codes, vmul, B, H, Sq, Skv, D, T, strides, scale_log2, s);
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
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [B, S, H, D] bf16 views as sd_flash_fwd_sm90 takes them;
// block_k: the int8 super-tile T, a positive multiple of 64; `codes`
// [B*H, ceil(Skv/T)*T, DP] int8 and `vmul` [B*H, ceil(Skv/T), DP] fp32 are
// scratch the pre-pass launch fills (DP = D rounded up to 16). Two launches:
// the pre-pass, then the sweep. Returns the CUDA error code (0 on success).
extern "C" int sd_flash_fwd_sm90_pv8(const void* q, const void* k, const void* v, void* o,
                                     void* codes, void* vmul, int B, int H, int Sq, int Skv,
                                     int D, const long long* strides, float scale_log2,
                                     int exp_bf16, int block_k, void* stream) {
  if (D % 8 || D > 128 || D <= 0 || block_k <= 0 || block_k % BK)
    return (int)cudaErrorInvalidValue;
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(o);
  int8_t* C8 = static_cast<int8_t*>(codes);
  float* VM = static_cast<float*>(vmul);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return exp_bf16
             ? fwd<true>(Q, K, V, O, C8, VM, B, H, Sq, Skv, D, block_k, strides, scale_log2, s)
             : fwd<false>(Q, K, V, O, C8, VM, B, H, Sq, Skv, D, block_k, strides, scale_log2, s);
}

// Dynamic shared memory (bytes) of the sweep for head dim D (the build report).
extern "C" int sd_flash_fwd_sm90_pv8_smem(int D) {
  switch ((D + 15) / 16 * 16) {
    case 16: return (int)CfgPv8<16>::SMEM;
    case 32: return (int)CfgPv8<32>::SMEM;
    case 48: return (int)CfgPv8<48>::SMEM;
    case 64: return (int)CfgPv8<64>::SMEM;
    case 80: return (int)CfgPv8<80>::SMEM;
    case 96: return (int)CfgPv8<96>::SMEM;
    case 112: return (int)CfgPv8<112>::SMEM;
    case 128: return (int)CfgPv8<128>::SMEM;
    default: return -1;
  }
}
