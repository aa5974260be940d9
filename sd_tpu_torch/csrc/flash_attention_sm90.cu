// Flash-attention inference forward for Hopper at head dims up to 128
// (bf16 in, bf16 out, fp32 softmax state): warpgroup products (wgmma) on
// tiles that arrive by TMA.
//
// Replaces, at the UNet's head dims, the TPU kernels `_flash_kernel`
// (sd_tpu/kernels/flash_attention.py:66, the [B*H, S, D] forward behind
// `flash_attention`) and `_flash_hpacked_kernel` (:293, the projection-native
// [B, S, H*D] forward behind `flash_attention_hpacked`), both read here
// through strided [B, S, H, D] views (head stride D and row stride H*D for a
// head-packed projection), serial sweep, with the fp32 exponential or the
// bf16 one (EXPB, `p_dtype = bfloat16`: exp(bf16(bf16(x) * bf16(ln 2))) in
// fp32, as XLA lowers jnp.exp2 on a bf16 operand). The int8 PV forward at
// these head dims is `flash_attention_sm90_pv8.cu`, head dims above 128
// `flash_attention_wide.cu`; the pipelined sweep at d <= 128 and the LSE
// forward stay on `flash_attention.cu`.
//
// Math (the TPU kernel's): non-causal softmax(q k^T * scale) v in base 2
// (log2(e) folded into the scale), running max m, running sum l and the
// output accumulator in fp32, p rounded to bf16 before the p v product, kv
// columns past Skv masked out, the output divided by max(l, 1e-30). Two
// roundings differ from the TPU kernel's: s * scale - m is one FFMA, and
// 2^x is ex2.approx (2 ulp).
//
// What bounds it on the H100: at the UNet shapes the work is 4*S^2*d
// tensor-core flops and S^2 exponentials per head against 8*S*d bytes, far
// above the ridge. At d = 80 the tensor-core products bound it (989 TFLOP/s);
// at d = 40 the exponentials do: one exp2 per 4*d = 160 flops, and the
// special-function units give ~3.9e12 results/s (16 per clock per SM), so
// the exponentials alone take 1.6x the products' time.
// What the design does about it:
//   * a block of two warpgroups owns 128 q rows, 64 each; S = Q K^T is one
//     wgmma m64n{BK}k16 chain per warpgroup with Q and K from shared memory,
//     and S stays in the accumulators: row max and row sum are quad shuffles
//     (each row lives in 4 lanes), the exponentials are taken in place;
//   * P never leaves the registers: the accumulator layout of two
//     neighbouring n8 column groups is the register-A layout of one k16
//     step, so O += P V is wgmma with A from registers and B = V from shared
//     memory in the transposed (MN-major) mode, no transposed copy of V;
//   * K and V tiles arrive by TMA into a 4-stage ring, each stage with a
//     "full" mbarrier (transaction bytes) and an "empty" one (one arrival
//     per warp); thread 0 refills the stage of tile j - 2 at step j, so the
//     two warpgroups drift apart freely and one's softmax runs under the
//     other's products, with no block-wide barrier in the sweep;
//   * tiles sit in shared memory in the no-swizzle core-matrix layout (8
//     columns x R rows x 16 bytes per chunk): each TMA box is one 8-column
//     chunk of R rows of a 4-D view (d, s and h by stride, b), so a
//     head-packed row's next head is never read; the head dim is padded to
//     a multiple of 16 (40 -> 48: one chunk of zeros, written once), which
//     costs the products 20% at d = 40 and nothing in exponentials;
//   * BK = 128 kv rows per step at d <= 48 (fewer row reductions and O
//     rescales per exponential), 64 above (registers); the O rescale is
//     skipped where no row of the warp moved its max.
// A ping-pong schedule of the two warpgroups' products (named barriers)
// and 1-block-per-warpgroup layouts were tried and not kept (PERF.md).
#include "sm90.cuh"

namespace {

constexpr int BQ = 128;        // q rows per block: two warpgroups of 64
constexpr int STAGES = 4;      // K/V ring depth
constexpr int THREADS = 256;

template <int DP>
struct Cfg90 {
  static constexpr int BK = DP <= 48 ? 128 : 64;      // kv rows per step
  static constexpr int MINB = DP <= 80 ? 2 : 1;       // blocks per SM
  static constexpr int TILE = BK * DP;                // elements of a K or V tile
  static constexpr size_t SMEM =
      (size_t)(BQ * DP + STAGES * 2 * TILE) * 2 + (2 * STAGES + 1) * 8;
  static_assert(DP % 16 == 0 && DP <= 128, "head tiling");
};

template <int DP, bool EXPB>
__global__ void __launch_bounds__(THREADS, Cfg90<DP>::MINB)
flash_fwd_sm90_kernel(const __grid_constant__ ViewMap mq, const __grid_constant__ ViewMap mk,
                      const __grid_constant__ ViewMap mv, bf16* __restrict__ o, int H, int Sq,
                      int Skv, int D, long long o_sb, long long o_ss, long long o_sh,
                      float scale_log2) {
  using C = Cfg90<DP>;
  constexpr int BK = C::BK, TILE = C::TILE, ST = STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KV = Qs + BQ * DP;                    // stage i: K at KV + 2i*TILE, V after
  uint64_t* full = reinterpret_cast<uint64_t*>(KV + ST * 2 * TILE);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int dv = D / 8;
  const int n_kv = (Skv + BK - 1) / BK;
  bf16* ob = o + b * o_sb + h * o_sh;

  // pad chunks [D/8, DP/8) of every tile, zeroed once (no copy writes them;
  // Q K^T reads them)
  const int padc = (DP - D) / 8;
  for (int idx = tid; idx < padc * BQ; idx += THREADS) {
    const int c = dv + idx / BQ, r = idx % BQ;
    *reinterpret_cast<uint4*>(Qs + c * BQ * 8 + r * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int idx = tid; idx < padc * BK * 2 * ST; idx += THREADS) {
    const int tile = idx / (padc * BK), rem = idx % (padc * BK);
    const int c = dv + rem / BK, r = rem % BK;
    *reinterpret_cast<uint4*>(KV + tile * TILE + c * BK * 8 + r * 8) =
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

  auto issue_kv = [&](int j) {
    bf16* Ks = KV + (j % ST) * 2 * TILE;
    mbar_expect_tx(full + j % ST, 2u * dv * BK * 16);
    load_rows_tma(mk, Ks, BK, j * BK, b, h, dv, 0, 1, full + j % ST);
    load_rows_tma(mv, Ks + TILE, BK, j * BK, b, h, dv, 0, 1, full + j % ST);
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, (uint32_t)dv * BQ * 16);
    load_rows_tma(mq, Qs, BQ, q0, b, h, dv, 0, 1, qbar);
    for (int j = 0; j < ST && j < n_kv; ++j) issue_kv(j);
  }

  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  uint32_t a[BK / 16][4];
  float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;   // rows g and g + 8
  mbar_wait(qbar, 0);

  for (int j = 0; j < n_kv; ++j) {
    // refill the stage tile j - 2 used, once every warp is done with it
    if (tid == 0 && j >= 2 && j - 2 + ST < n_kv) {
      mbar_wait(empty + (j - 2) % ST, ((j - 2) / ST) & 1);
      issue_kv(j - 2 + ST);
    }
    __syncwarp();
    mbar_wait(full + j % ST, (j / ST) & 1);
    const bf16* Ks = KV + (j % ST) * 2 * TILE;
    const bf16* Vs = Ks + TILE;

    // ---- S = Q K^T: this warpgroup's 64 rows x BK ----------------------------
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<BK>::ss(s, gmma_desc(Qs + cm_off<BQ>(64 * wg, 16 * kk), BQ * 16, 128),
                    gmma_desc(Ks + cm_off<BK>(0, 16 * kk), BK * 16, 128), kk > 0);
    wg_commit();
    wg_wait_all();

    // ---- online softmax: the max over the raw logits (the scale is
    // positive), the ragged last tile's columns past Skv at -inf, and
    // x = s * scale - m in one FFMA ---------------------------------------------
    const int valid = Skv - j * BK;
    if (valid < BK) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if ((i >> 2) * 8 + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 4) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[i], s[i + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[i + 2], s[i + 3]));
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
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float x = fmaf(s[i], scale_log2, -((i & 2) ? mn_hi : mn_lo));
      s[i] = EXPB ? exp2_bf16(x) : fast_exp2(x);
      if (i & 2)
        sum_hi += s[i];
      else
        sum_lo += s[i];
    }
    // the row sum is kept per lane and folded across the quad at the end
    l_lo = c_lo * l_lo + sum_lo;
    l_hi = c_hi * l_hi + sum_hi;
    if (__any_sync(0xffffffffu, c_lo != 1.f || c_hi != 1.f)) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) oacc[i] *= (i & 2) ? c_hi : c_lo;
    }

    // ---- O += P V: P (bf16) from the registers, V MN-major from shared memory
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      a[kk][0] = sdk::pack_bf16(s[8 * kk], s[8 * kk + 1]);
      a[kk][1] = sdk::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = sdk::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = sdk::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<DP>::rs(oacc, a[kk], gmma_desc(Vs + cm_off<BK>(16 * kk, 0), 128, BK * 16));
    wg_commit();
    wg_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + j % ST);
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
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int Sq,
           int Skv, int D, const long long* st, float scale_log2, cudaStream_t stream) {
  using C = Cfg90<DP>;
  ViewMap mq, mk, mv;
  int e = make_view_map(&mq, q, B, Sq, H, D, st[0], st[1], st[2], BQ);
  if (!e) e = make_view_map(&mk, k, B, Skv, H, D, st[3], st[4], st[5], C::BK);
  if (!e) e = make_view_map(&mv, v, B, Skv, H, D, st[6], st[7], st[8], C::BK);
  if (e) return e;
  auto kern = flash_fwd_sm90_kernel<DP, EXPB>;
  SDK_SET_SMEM(kern, C::SMEM);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, C::SMEM, stream>>>(mq, mk, mv, o, H, Sq, Skv, D, st[9], st[10], st[11],
                                           scale_log2);
  return (int)cudaGetLastError();
}

template <bool EXPB>
int fwd(const bf16* Q, const bf16* K, const bf16* V, bf16* O, int B, int H, int Sq, int Skv,
        int D, const long long* strides, float scale_log2, cudaStream_t s) {
  switch ((D + 15) / 16 * 16) {
#define SDK_DP(DPV) \
  case DPV:         \
    return launch<DPV, EXPB>(Q, K, V, O, B, H, Sq, Skv, D, strides, scale_log2, s);
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

// q, k, v, o: [B, S, H, D] bf16 views with unit stride along D, D a multiple
// of 8 up to 128, 16-byte aligned, strides multiples of 8 elements; `strides`
// holds (batch, row, head) strides in elements for q, k, v, o in that order.
// exp_bf16 = 1 takes the bf16 softmax exponential. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int sd_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                 int B, int H, int Sq, int Skv, int D,
                                 const long long* strides, float scale_log2, int exp_bf16,
                                 void* stream) {
  if (D % 8 || D > 128 || D <= 0) return (int)cudaErrorInvalidValue;
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return exp_bf16 ? fwd<true>(Q, K, V, O, B, H, Sq, Skv, D, strides, scale_log2, s)
                  : fwd<false>(Q, K, V, O, B, H, Sq, Skv, D, strides, scale_log2, s);
}

// Dynamic shared memory (bytes) of the launch for head dim D (the build report).
extern "C" int sd_flash_fwd_sm90_smem(int D) {
  switch ((D + 15) / 16 * 16) {
    case 16: return (int)Cfg90<16>::SMEM;
    case 32: return (int)Cfg90<32>::SMEM;
    case 48: return (int)Cfg90<48>::SMEM;
    case 64: return (int)Cfg90<64>::SMEM;
    case 80: return (int)Cfg90<80>::SMEM;
    case 96: return (int)Cfg90<96>::SMEM;
    case 112: return (int)Cfg90<112>::SMEM;
    case 128: return (int)Cfg90<128>::SMEM;
    default: return -1;
  }
}
