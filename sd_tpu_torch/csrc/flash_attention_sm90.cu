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
// fp32, as XLA lowers jnp.exp2 on a bf16 operand). With LSE (fp32
// exponential only, as `sd_tpu`'s `_fwd` ignores `p_dtype`) it also replaces
// `_flash_kernel_lse` (:421), the training forward: the same sweep, and at
// its end, where O is divided by l, lse2 = m + log2(l) (-1e30 where l = 0)
// into a [B*H, Sq] fp32 array for the backward kernels, one lane of each
// row's quad writing it (m is already in scaled base-2 units). With PIPE it
// replaces `_flash_kernel_pipelined` (:123, `SD_TPU_FLASH_PIPE=1` on the
// [B, S, H, D] route) at these head dims: the same sweep with tile j - 1's
// P V product under tile j's Q K^T and exponentials, the same bits (below).
// The int8 PV forward at these head dims is `flash_attention_sm90_pv8.cu`,
// head dims above 128 `flash_attention_wide.cu`.
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
//
// The pipelined sweep (PIPE) overlaps within one warpgroup what the serial
// sweep does in turn: at step j it issues S_j = Q K_j^T and then O +=
// P_{j-1} V_{j-1} (P from registers, O already rescaled by c_{j-1}) as two
// wgmma groups, retires the first alone (wait_group 1), so tile j's mask,
// max and exponentials run while tile j-1's product is on the tensor cores,
// then retires the second, rescales O by c_j and packs P_j; one drain step
// does the last product. O sees the serial sweep's operations in its order
// ((O c_{j-1} + P_{j-1} V_{j-1}) c_j + ...), at the serial sweep's kv tile,
// and the softmax, the rescale and the packing are the serial sweep's own
// functions, so the output is its bits. P_{j-1} (BK / 4 registers) lives
// beside S_j: at d <= 48 (BK = 128) that is 146 registers, so two blocks of
// two warpgroups (128 each) would spill; a block there is three warpgroups
// (192 q rows, 384 threads, one an SM). V_{j-1} is read one step later than
// in the serial sweep, so thread 0 refills at step j the stage of tile j - 2,
// which the other warpgroups released at step j - 1: the ring still
// prefetches two tiles ahead, and warpgroups drift apart less than a step.
#include "sm90.cuh"

namespace {

constexpr int BQ = 128;        // q rows per block: two warpgroups of 64
constexpr int STAGES = 4;      // K/V ring depth
constexpr int THREADS = 256;
constexpr float NEG_LSE = -1e30f;   // lse2 of a row whose sum is 0 (`NEG_INF`)

// a block of NWG warpgroups of 64 q rows (the serial sweep's: 2)
template <int DP, int NWG = 2>
struct Cfg90 {
  static constexpr int ROWS = 64 * NWG;               // q rows per block
  static constexpr int NT = 128 * NWG;                // threads per block
  static constexpr int BK = DP <= 48 ? 128 : 64;      // kv rows per step
  static constexpr int TILE = BK * DP;                // elements of a K or V tile
  static constexpr size_t SMEM =
      (size_t)(ROWS * DP + STAGES * 2 * TILE) * 2 + (2 * STAGES + 1) * 8;
  static_assert(DP % 16 == 0 && DP <= 128, "head tiling");
};

// blocks per SM of the serial sweep (two warpgroups a block)
__host__ __device__ constexpr int minb90(int DP) { return DP <= 80 ? 2 : 1; }
// warpgroups a block of the pipelined sweep and its blocks per SM: at d <= 48
// P_{j-1} beside S_j takes more than the 128 registers of two blocks of two
// warpgroups, so one block of three
__host__ __device__ constexpr int pipe_nwg(int DP) { return DP <= 48 ? 3 : 2; }
__host__ __device__ constexpr int pipe_minb(int DP) { return DP <= 48 ? 1 : minb90(DP); }

// The block's shared memory: Q, the K/V ring (stage i: K at KV + 2i * TILE,
// V after it), a "full" and an "empty" mbarrier per stage and Q's.
template <int DP, int NWG = 2>
struct Smem90 {
  bf16* Qs;
  bf16* KV;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* qbar;
  __device__ explicit Smem90(unsigned char* smem)
      : Qs(reinterpret_cast<bf16*>(smem)), KV(Qs + Cfg90<DP, NWG>::ROWS * DP),
        full(reinterpret_cast<uint64_t*>(KV + STAGES * 2 * Cfg90<DP>::TILE)),
        empty(full + STAGES), qbar(empty + STAGES) {}
  __device__ bf16* k_tile(int j) const { return KV + (j % STAGES) * 2 * Cfg90<DP>::TILE; }
};

// K_j and V_j by TMA into stage j % STAGES (thread 0)
template <int DP, int NWG>
__device__ __forceinline__ void issue_kv(const Smem90<DP, NWG>& sm, const ViewMap& mk,
                                         const ViewMap& mv, int j, int b, int h, int dv) {
  constexpr int BK = Cfg90<DP>::BK;
  bf16* Ks = sm.k_tile(j);
  mbar_expect_tx(sm.full + j % STAGES, 2u * dv * BK * 16);
  load_rows_tma(mk, Ks, BK, j * BK, b, h, dv, 0, 1, sm.full + j % STAGES);
  load_rows_tma(mv, Ks + Cfg90<DP>::TILE, BK, j * BK, b, h, dv, 0, 1, sm.full + j % STAGES);
}

// The block's start: pad chunks [D/8, DP/8) of every tile zeroed once (no
// copy writes them; Q K^T reads them), the barriers set up, Q and the first
// STAGES kv tiles asked for
template <int DP, int NWG>
__device__ __forceinline__ void start_block(const Smem90<DP, NWG>& sm, const ViewMap& mq,
                                            const ViewMap& mk, const ViewMap& mv, int b, int h,
                                            int q0, int D, int n_kv) {
  constexpr int BK = Cfg90<DP>::BK, TILE = Cfg90<DP>::TILE;
  constexpr int BQ = Cfg90<DP, NWG>::ROWS, THREADS = Cfg90<DP, NWG>::NT;
  const int tid = threadIdx.x, dv = D / 8;
  const int padc = (DP - D) / 8;
  for (int idx = tid; idx < padc * BQ; idx += THREADS) {
    const int c = dv + idx / BQ, r = idx % BQ;
    *reinterpret_cast<uint4*>(sm.Qs + c * BQ * 8 + r * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int idx = tid; idx < padc * BK * 2 * STAGES; idx += THREADS) {
    const int tile = idx / (padc * BK), rem = idx % (padc * BK);
    const int c = dv + rem / BK, r = rem % BK;
    *reinterpret_cast<uint4*>(sm.KV + tile * TILE + c * BK * 8 + r * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(sm.full + i, 1);
      mbar_init(sm.empty + i, THREADS / 32);
    }
    mbar_init(sm.qbar, 1);
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sm.qbar, (uint32_t)dv * BQ * 16);
    load_rows_tma(mq, sm.Qs, BQ, q0, b, h, dv, 0, 1, sm.qbar);
    for (int j = 0; j < STAGES && j < n_kv; ++j) issue_kv(sm, mk, mv, j, b, h, dv);
  }
}

// S = Q K^T: warpgroup wg's 64 rows x BK as one wgmma chain (not committed)
template <int DP, int NWG = 2>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg90<DP>::BK / 2], const bf16* Qs,
                                         const bf16* Ks, int wg) {
  constexpr int BK = Cfg90<DP>::BK, BQ = Cfg90<DP, NWG>::ROWS;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    Wgmma<BK>::ss(s, gmma_desc(Qs + cm_off<BQ>(64 * wg, 16 * kk), BQ * 16, 128),
                  gmma_desc(Ks + cm_off<BK>(0, 16 * kk), BK * 16, 128), kk > 0);
}

// O += P V: P (bf16) from the registers, V MN-major from shared memory (not
// committed)
template <int DP>
__device__ __forceinline__ void issue_pv(float (&oacc)[DP / 2],
                                         uint32_t (&a)[Cfg90<DP>::BK / 16][4],
                                         const bf16* Vs) {
  constexpr int BK = Cfg90<DP>::BK;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<DP>::rs(oacc, a[kk], gmma_desc(Vs + cm_off<BK>(16 * kk, 0), 128, BK * 16));
}

// The online softmax of one kv tile, in place: the max over the raw logits
// (the scale is positive), the ragged last tile's columns past Skv at -inf
// (`valid` columns of the tile are kv rows), x = s * scale - m in one FFMA,
// p = 2^x in s; the running max moves, the per-lane row sums (folded across
// the quad at the end) take c * l + sum, and c_lo / c_hi are O's rescale
template <int BK, bool EXPB>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], int valid, int t,
                                             float scale_log2, float& m_lo, float& m_hi,
                                             float& l_lo, float& l_hi, float& c_lo,
                                             float& c_hi) {
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
  c_lo = fast_exp2(m_lo - mn_lo);
  c_hi = fast_exp2(m_hi - mn_hi);
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
  l_lo = c_lo * l_lo + sum_lo;
  l_hi = c_hi * l_hi + sum_hi;
}

// O *= c, skipped where no row of the warp moved its max
template <int DP>
__device__ __forceinline__ void rescale_o(float (&oacc)[DP / 2], float c_lo, float c_hi) {
  if (__any_sync(0xffffffffu, c_lo != 1.f || c_hi != 1.f)) {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] *= (i & 2) ? c_hi : c_lo;
  }
}

// p (fp32 accumulator layout) rounded to bf16 as the k16 register A
// fragments of the P V product: two neighbouring n8 column groups of the
// accumulator are one k16 step's A
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&a)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    a[kk][0] = sdk::pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = sdk::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = sdk::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = sdk::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The end of the sweep: l across the quad, O / l in bf16 by strided stores,
// and with LSE the row's lse2 = m + log2(l) (m is in scaled base-2 units)
template <int DP, bool LSE>
__device__ __forceinline__ void store_o(const float (&oacc)[DP / 2], float l_lo, float l_hi,
                                       float m_lo, float m_hi, bf16* ob, float* lse, int q0,
                                       int Sq, int D, long long o_ss) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  const int r_lo = q0 + 64 * wg + 16 * wl + g, r_hi = r_lo + 8;
  if (LSE && t == 0) {
    float* lrow = lse + (long long)blockIdx.y * Sq;
    if (r_lo < Sq) lrow[r_lo] = l_lo > 0.f ? m_lo + log2f(l_lo) : NEG_LSE;
    if (r_hi < Sq) lrow[r_hi] = l_hi > 0.f ? m_hi + log2f(l_hi) : NEG_LSE;
  }
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

// keeps the compiler from moving reads or writes of these registers across
// this point (the wgmma that reads or writes them in flight before it)
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(r[i][k])::"memory");
}

template <int DP, bool EXPB, bool LSE>
__global__ void __launch_bounds__(THREADS, minb90(DP))
flash_fwd_sm90_kernel(const __grid_constant__ ViewMap mq, const __grid_constant__ ViewMap mk,
                      const __grid_constant__ ViewMap mv, bf16* __restrict__ o,
                      float* __restrict__ lse, int H, int Sq, int Skv, int D, long long o_sb,
                      long long o_ss, long long o_sh, float scale_log2) {
  static_assert(!(LSE && EXPB), "the training forward takes the fp32 exponential");
  constexpr int BK = Cfg90<DP>::BK, ST = STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem90<DP> sm(smem);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int dv = D / 8;
  const int n_kv = (Skv + BK - 1) / BK;
  start_block(sm, mq, mk, mv, b, h, q0, D, n_kv);

  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  uint32_t a[BK / 16][4];
  float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;   // rows g and g + 8
  mbar_wait(sm.qbar, 0);

  for (int j = 0; j < n_kv; ++j) {
    // refill the stage tile j - 2 used, once every warp is done with it
    if (tid == 0 && j >= 2 && j - 2 + ST < n_kv) {
      mbar_wait(sm.empty + (j - 2) % ST, ((j - 2) / ST) & 1);
      issue_kv(sm, mk, mv, j - 2 + ST, b, h, dv);
    }
    __syncwarp();
    mbar_wait(sm.full + j % ST, (j / ST) & 1);
    const bf16* Ks = sm.k_tile(j);

    wg_fence();
    issue_qk<DP>(s, sm.Qs, Ks, wg);
    wg_commit();
    wg_wait_all();

    float c_lo, c_hi;
    softmax_tile<BK, EXPB>(s, Skv - j * BK, t, scale_log2, m_lo, m_hi, l_lo, l_hi, c_lo, c_hi);
    rescale_o<DP>(oacc, c_lo, c_hi);
    pack_p<BK>(a, s);
    wg_fence();
    issue_pv<DP>(oacc, a, Ks + Cfg90<DP>::TILE);
    wg_commit();
    wg_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty + j % ST);
  }
  store_o<DP, LSE>(oacc, l_lo, l_hi, m_lo, m_hi, o + b * o_sb + h * o_sh, lse, q0, Sq, D, o_ss);
}

// The pipelined sweep (inference only): tile j - 1's P V under tile j's
// Q K^T and softmax, in one warpgroup (see the header)
template <int DP, bool EXPB>
__global__ void __launch_bounds__(128 * pipe_nwg(DP), pipe_minb(DP))
flash_fwd_sm90_pipe_kernel(const __grid_constant__ ViewMap mq, const __grid_constant__ ViewMap mk,
                           const __grid_constant__ ViewMap mv, bf16* __restrict__ o, int H,
                           int Sq, int Skv, int D, long long o_sb, long long o_ss, long long o_sh,
                           float scale_log2) {
  constexpr int BK = Cfg90<DP>::BK, TILE = Cfg90<DP>::TILE, ST = STAGES, NWG = pipe_nwg(DP);
  // thread 0 refills at step j the stage of tile j - LAG: released at step
  // j - 1 once V_{j-2}'s product retired
  constexpr int LAG = 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem90<DP, NWG> sm(smem);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * 64 * NWG;
  const int dv = D / 8;
  const int n_kv = (Skv + BK - 1) / BK;
  start_block(sm, mq, mk, mv, b, h, q0, D, n_kv);

  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  uint32_t a[BK / 16][4];   // P_{j-1}, the A operand of the product in flight
  float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;   // rows g and g + 8
  float c_lo, c_hi;
  mbar_wait(sm.qbar, 0);

  // step 0: S_0 alone (O is zero: its rescale is the serial sweep's no-op)
  mbar_wait(sm.full, 0);
  wg_fence();
  issue_qk<DP, NWG>(s, sm.Qs, sm.k_tile(0), wg);
  wg_commit();
  wg_wait_all();
  pin(s);
  softmax_tile<BK, EXPB>(s, Skv, t, scale_log2, m_lo, m_hi, l_lo, l_hi, c_lo, c_hi);
  rescale_o<DP>(oacc, c_lo, c_hi);
  pack_p<BK>(a, s);

  for (int j = 1; j < n_kv; ++j) {
    if (tid == 0 && j >= LAG && j - LAG + ST < n_kv) {
      mbar_wait(sm.empty + (j - LAG) % ST, ((j - LAG) / ST) & 1);
      issue_kv(sm, mk, mv, j - LAG + ST, b, h, dv);
    }
    __syncwarp();
    mbar_wait(sm.full + j % ST, (j / ST) & 1);
    wg_fence();
    issue_qk<DP, NWG>(s, sm.Qs, sm.k_tile(j), wg);
    wg_commit();
    issue_pv<DP>(oacc, a, sm.k_tile(j - 1) + TILE);
    wg_commit();
    wg_wait_one();   // S_j
    pin(s);
    softmax_tile<BK, EXPB>(s, Skv - j * BK, t, scale_log2, m_lo, m_hi, l_lo, l_hi, c_lo, c_hi);
    wg_wait_all();   // P_{j-1} V_{j-1}
    pin(oacc);
    pin(a);
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty + (j - 1) % ST);
    rescale_o<DP>(oacc, c_lo, c_hi);
    pack_p<BK>(a, s);
  }

  // the drain: the last tile's product
  wg_fence();
  issue_pv<DP>(oacc, a, sm.k_tile(n_kv - 1) + TILE);
  wg_commit();
  wg_wait_all();
  pin(oacc);
  store_o<DP, false>(oacc, l_lo, l_hi, m_lo, m_hi, o + b * o_sb + h * o_sh, nullptr, q0, Sq, D,
                     o_ss);
}

template <int DP, bool EXPB, bool LSE>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B, int H,
           int Sq, int Skv, int D, const long long* st, float scale_log2, cudaStream_t stream) {
  using C = Cfg90<DP>;
  ViewMap mq, mk, mv;
  int e = make_view_map(&mq, q, B, Sq, H, D, st[0], st[1], st[2], BQ);
  if (!e) e = make_view_map(&mk, k, B, Skv, H, D, st[3], st[4], st[5], C::BK);
  if (!e) e = make_view_map(&mv, v, B, Skv, H, D, st[6], st[7], st[8], C::BK);
  if (e) return e;
  auto kern = flash_fwd_sm90_kernel<DP, EXPB, LSE>;
  SDK_SET_SMEM(kern, C::SMEM);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, C::SMEM, stream>>>(mq, mk, mv, o, lse, H, Sq, Skv, D, st[9], st[10],
                                           st[11], scale_log2);
  return (int)cudaGetLastError();
}

// the pipelined sweep's launch
template <int DP, bool EXPB>
int launch_pipe(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H, int Sq,
                int Skv, int D, const long long* st, float scale_log2, cudaStream_t stream) {
  using C = Cfg90<DP, pipe_nwg(DP)>;
  ViewMap mq, mk, mv;
  int e = make_view_map(&mq, q, B, Sq, H, D, st[0], st[1], st[2], C::ROWS);
  if (!e) e = make_view_map(&mk, k, B, Skv, H, D, st[3], st[4], st[5], C::BK);
  if (!e) e = make_view_map(&mv, v, B, Skv, H, D, st[6], st[7], st[8], C::BK);
  if (e) return e;
  auto kern = flash_fwd_sm90_pipe_kernel<DP, EXPB>;
  SDK_SET_SMEM(kern, C::SMEM);
  dim3 grid((Sq + C::ROWS - 1) / C::ROWS, B * H);
  kern<<<grid, C::NT, C::SMEM, stream>>>(mq, mk, mv, o, H, Sq, Skv, D, st[9], st[10], st[11],
                                         scale_log2);
  return (int)cudaGetLastError();
}

// the pipelined sweep's dynamic shared memory at padded head dim DP
template <int DP>
constexpr int pipe_smem() {
  return (int)Cfg90<DP, pipe_nwg(DP)>::SMEM;
}

template <bool EXPB, bool LSE>
int fwd(const bf16* Q, const bf16* K, const bf16* V, bf16* O, float* L, int B, int H, int Sq,
        int Skv, int D, const long long* strides, float scale_log2, cudaStream_t s) {
  switch ((D + 15) / 16 * 16) {
#define SDK_DP(DPV) \
  case DPV:         \
    return launch<DPV, EXPB, LSE>(Q, K, V, O, L, B, H, Sq, Skv, D, strides, scale_log2, s);
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
  return exp_bf16 ? fwd<true, false>(Q, K, V, O, nullptr, B, H, Sq, Skv, D, strides, scale_log2, s)
                  : fwd<false, false>(Q, K, V, O, nullptr, B, H, Sq, Skv, D, strides, scale_log2,
                                      s);
}

// The training forward (`_flash_kernel_lse`): as sd_flash_fwd_sm90 with the
// fp32 exponential, plus lse2 [B*H, Sq] fp32 (row b*H + h), NEG_LSE where a
// row's sum is 0.
extern "C" int sd_flash_fwd_sm90_lse(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int B, int H, int Sq, int Skv, int D,
                                     const long long* strides, float scale_log2, void* stream) {
  if (D % 8 || D > 128 || D <= 0) return (int)cudaErrorInvalidValue;
  return fwd<false, true>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<bf16*>(o),
                          static_cast<float*>(lse), B, H, Sq, Skv, D, strides, scale_log2,
                          static_cast<cudaStream_t>(stream));
}

// The pipelined sweep (inference): as sd_flash_fwd_sm90 (Skv >= 1), the
// same bits.
extern "C" int sd_flash_fwd_sm90_pipe(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int Sq, int Skv, int D,
                                      const long long* strides, float scale_log2, int exp_bf16,
                                      void* stream) {
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 8 || D > 128 || D <= 0 || Skv <= 0) return (int)cudaErrorInvalidValue;
  switch ((D + 15) / 16 * 16) {
#define SDK_DP(DPV)                                                                         \
  case DPV:                                                                                 \
    return exp_bf16 ? launch_pipe<DPV, true>(Q, K, V, O, B, H, Sq, Skv, D, strides,         \
                                             scale_log2, s)                                 \
                    : launch_pipe<DPV, false>(Q, K, V, O, B, H, Sq, Skv, D, strides,        \
                                              scale_log2, s);
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

// Dynamic shared memory (bytes) of the pipelined sweep for head dim D (the
// build report).
extern "C" int sd_flash_fwd_sm90_pipe_smem(int D) {
  switch ((D + 15) / 16 * 16) {
    case 16: return pipe_smem<16>();
    case 32: return pipe_smem<32>();
    case 48: return pipe_smem<48>();
    case 64: return pipe_smem<64>();
    case 80: return pipe_smem<80>();
    case 96: return pipe_smem<96>();
    case 112: return pipe_smem<112>();
    case 128: return pipe_smem<128>();
    default: return -1;
  }
}

// Dynamic shared memory (bytes) of the serial sweep for head dim D (the
// build report).
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
