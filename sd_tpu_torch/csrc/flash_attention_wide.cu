// Flash-attention inference forward for Hopper at head dims 129-512 (bf16
// in, bf16 out, fp32 softmax state): the decoder's single-head d = 512
// mid-block attention and any wide head.
//
// Replaces, above head dim 128, the TPU kernels `_flash_kernel`
// (sd_tpu/kernels/flash_attention.py:66, serial sweep) and
// `_flash_kernel_pipelined` (:123, PIPE: the same bits), with the fp32
// exponential or the bf16 one (EXPB, `p_dtype = bfloat16`, as in
// `flash_attention_sm90.cu`), and their int8 PV variant (PV8, `_pv_int8`
// :44) over strided [B, S, H, D] views. With LSE (the serial sweep, fp32
// exponential: `sd_tpu`'s `_fwd` ignores `p_dtype` and `pv_quant`) it also
// replaces `_flash_kernel_lse` (:421), the training forward at the codec's
// d = 512: at the end of the sweep lse2 = m + log2(l) (-1e30 where l = 0)
// goes to a [B*H, Sq] fp32 array; both warpgroups hold the same m and l, so
// one lane of each row's quad in warpgroup 0 writes it. At train_kl_vae's
// [4, 1024, 1, 512] the grid is 64 blocks, half the SMs, so the time is one
// block's sweep of 16 kv steps: there the wrapper splits each row's sweep in
// two (`lse_split`, grid.z = 2: 128 blocks of 8 steps), each part leaves its
// unnormalized fp32 O, m and l, and a second launch (`lse_combine_kernel`,
// one block per row) rescales the parts to the common max and writes o and
// lse2.
//
// Math (the TPU kernel's): non-causal softmax(q k^T * scale) v in base 2
// (log2(e) folded into the scale), running max m, running sum l and the
// output accumulator in fp32, p rounded to bf16 before the p v product, kv
// columns past Skv masked out, the output divided by max(l, 1e-30). Two
// roundings differ from the TPU kernel's: s * scale - m is one FFMA, and
// 2^x is ex2.approx (2 ulp). PV8 is `flash_attention_sm90_pv8.cu`'s
// function (super-tiles of the TPU kernel's kv tile T, 512 rows at d = 512;
// the row max over the whole super-tile, p_i8 = trunc(p * 127 + 0.5), V's
// column scales and codes from the pre-pass in `sm90.cuh`), except that the
// int32 product of each 64-row sub-tile enters O at vs / 127 on its own:
// within fp32 rounding of the TPU kernel's one exact int32 sum over T rows.
//
// What bounds it on the H100: at d = 512 the work is 4*S^2*d tensor-core
// flops per head against 8*S*d bytes and S^2 exponentials, so the products
// bound it (0.0695 ms at [2, 4096, 1, 512] at 989 TFLOP/s); the exponentials
// take 1/2048 of the flops and do not. A 64-row q tile at d = 512 is 64 KB of
// bf16 and so is each K or V tile, and O is 64 x 512 fp32: 256 registers a
// thread for one warpgroup. Each q tile reads all of K and V from L2.
// What the design does about it:
//   * a block of two warpgroups owns 64 q rows (128 blocks for 132 SMs at
//     [2, 4096, 1, 512]); warpgroup w owns O's columns [w*DP/2, (w+1)*DP/2)
//     (128 fp32 registers at d = 512) and takes the same half of the head
//     dim for S = Q K^T: a wgmma m64n64k16 chain with Q and K from shared
//     memory. The two partial S tiles are swapped through shared memory
//     (laid out [warpgroup][value][thread]: no bank conflicts) behind one
//     named barrier; each warpgroup adds the same two numbers, so both hold
//     the same S bit for bit and run the same softmax (twice: the
//     exponentials are 1/2048 of the work), with P in registers;
//   * O += P V is wgmma with A = P from the registers (the accumulator
//     layout of two n8 groups is the k16 A layout) and B = this warpgroup's
//     columns of V, MN-major in shared memory, no transposed copy; PV8 runs
//     `wgmma .s32.s8.s8` in 64-column chunks with P packed to int8 in
//     registers (the codes are permuted to match, `perm16`);
//   * Q (64 KB), one K tile and one V tile (64 KB each at BK = 64) and the
//     two partial S tiles (32 KB) fill 224 KB: K and V are single-buffered
//     and arrive by TMA (one box per 8-column chunk, issued by the 32 lanes
//     of warp 0; V codes by one bulk copy). K of step i + 1 is issued once
//     both warpgroups have swapped S of step i, V once both have finished PV
//     of step i, so each load runs under about half a step of products;
//   * PIPE issues the products of S of step i + 1 and of P_i V_i together,
//     so the tensor cores run them back to back: the same arithmetic in the
//     same order, the same bits as the serial sweep.
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // kv rows per step
constexpr int THREADS = 256;   // two warpgroups
constexpr int XV = BK / 2;     // S values a thread holds
constexpr float NEG_LSE = -1e30f;   // lse2 of a row whose sum is 0 (`NEG_INF`)
constexpr int MAX_SPLIT = 2;        // the most parts a training forward's kv sweep is split into

template <int DP, bool PV8>
struct CfgWide {
  static constexpr int HALF = DP / 2;                 // a warpgroup's O columns and S depth
  static constexpr int QBYTES = BQ * DP * 2;
  static constexpr int KBYTES = BK * DP * 2;
  static constexpr int VBYTES = PV8 ? BK * DP : BK * DP * 2;   // V codes or the V tile
  static constexpr int XBYTES = 2 * XV * 128 * 4;    // the two partial S tiles
  static constexpr size_t SMEM = (size_t)QBYTES + KBYTES + VBYTES + XBYTES + 4 * 8;
  static_assert(DP == 256 || DP == 512, "head tiling");
};

// this warpgroup's partial S over its half of the head dim, written out for
// the other warpgroup
template <int DP>
__device__ __forceinline__ void s_partial(float (&s)[XV], const bf16* Qs, const bf16* Ks,
                                          float* Sx, int wg, int tw) {
  constexpr int HALF = DP / 2;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HALF / 16; ++kk)
    Wgmma<BK>::ss(s, gmma_desc(Qs + cm_off<BQ>(0, wg * HALF + 16 * kk), BQ * 16, 128),
                  gmma_desc(Ks + cm_off<BK>(0, wg * HALF + 16 * kk), BK * 16, 128), kk > 0);
  wg_commit();
  wg_wait_all();
  float* mine = Sx + wg * XV * 128 + tw;
#pragma unroll
  for (int k = 0; k < XV; ++k) mine[k * 128] = s[k];
}

// S = the two partials (each warpgroup adds the same two numbers), the
// ragged last tile's columns past Skv at -inf
__device__ __forceinline__ void s_gather(float (&s)[XV], const float* Sx, int wg, int tw,
                                         int valid, int t) {
  const float* other = Sx + (1 - wg) * XV * 128 + tw;
#pragma unroll
  for (int k = 0; k < XV; ++k) s[k] += other[k * 128];
  if (valid < BK) {
#pragma unroll
    for (int k = 0; k < XV; ++k)
      if ((k >> 2) * 8 + 2 * t + (k & 1) >= valid) s[k] = -INFINITY;
  }
}

template <int DP, bool EXPB, bool PIPE, bool PV8, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wide_kernel(const __grid_constant__ ViewMap mq, const __grid_constant__ ViewMap mk,
                      const __grid_constant__ ViewMap mv, const int8_t* __restrict__ codes,
                      const float* __restrict__ vmul, bf16* __restrict__ o,
                      float* __restrict__ lse, float* __restrict__ part, int H, int Sq, int Skv,
                      int D, int T, long long o_sb, long long o_ss, long long o_sh,
                      float scale_log2) {
  using C = CfgWide<DP, PV8>;
  constexpr int HALF = C::HALF;
  static_assert(!(PIPE && PV8), "the pipelined sweep has no int8 PV");
  static_assert(!(LSE && (EXPB || PIPE || PV8)), "the training forward is the fp32 serial sweep");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + C::QBYTES);
  unsigned char* Vb = smem + C::QBYTES + C::KBYTES;
  bf16* Vs = reinterpret_cast<bf16*>(Vb);
  float* Sx = reinterpret_cast<float*>(Vb + C::VBYTES);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(Sx + 2 * XV * 128);
  uint64_t* vfull = kfull + 1;
  uint64_t* qbar = kfull + 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3, tw = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int dv = D / 8;
  // LSE with a kv split: part blockIdx.z of gridDim.z sweeps its share of
  // the kv tiles (the parts are combined by `lse_combine_kernel`)
  const int n_split = gridDim.z, kv_all = (Skv + BK - 1) / BK;
  const int kv_per = (kv_all + n_split - 1) / n_split, kv0 = blockIdx.z * kv_per;
  const int n_kv = min(kv_per, kv_all - kv0);
  // PV8: each sub-tile twice per super-tile (the max pass, the product pass)
  const int spt = PV8 ? T / BK : 1;
  const int n_st = PV8 ? (Skv + T - 1) / T : 1;
  const int n_steps = PV8 ? 2 * n_kv : n_kv;
  bf16* ob = o + b * o_sb + h * o_sh;
  const int8_t* cb = PV8 ? codes + (long long)bh * n_st * T * DP : nullptr;
  const float* vmb = PV8 ? vmul + (long long)bh * n_st * DP : nullptr;

  // pad chunks [D/8, DP/8) of the Q, K and V tiles, zeroed once
  const int padc = (DP - D) / 8;
  for (int idx = tid; idx < padc * BQ; idx += THREADS) {
    const int c = dv + idx / BQ, r = idx % BQ;
    *reinterpret_cast<uint4*>(Qs + c * BQ * 8 + r * 8) = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(Ks + c * BK * 8 + r * 8) = make_uint4(0u, 0u, 0u, 0u);
    if (!PV8) *reinterpret_cast<uint4*>(Vs + c * BK * 8 + r * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    mbar_init(kfull, 1);
    mbar_init(vfull, 1);
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();

  // step i: kv tile j; returns whether the step runs the PV product
  auto step_of = [&](int i, int& j) -> bool {
    if (!PV8) {
      j = kv0 + i;
      return true;
    }
    const int st = i / (2 * spt), r = i - st * 2 * spt;
    const int n_this = min(spt, n_kv - st * spt);
    j = st * spt + (r >= n_this ? r - n_this : r);
    return r >= n_this;
  };
  // the first PV step after step i (n_steps if none)
  auto next_pv = [&](int i) {
    int j;
    for (int k = i + 1; k < n_steps; ++k)
      if (step_of(k, j)) return k;
    return n_steps;
  };
  // loads, issued by the lanes of warp 0
  auto load_k = [&](int i) {
    int j;
    step_of(i, j);
    if (lane == 0) mbar_expect_tx(kfull, (uint32_t)dv * BK * 16);
    __syncwarp();
    load_rows_tma(mk, Ks, BK, j * BK, b, h, dv, lane, 32, kfull);
  };
  auto load_v = [&](int i) {
    int j;
    step_of(i, j);
    if (PV8) {
      if (lane == 0) {
        mbar_expect_tx(vfull, (uint32_t)BK * DP);
        bulk_load(Vb, cb + (long long)j * BK * DP, BK * DP, vfull);
      }
    } else {
      if (lane == 0) mbar_expect_tx(vfull, (uint32_t)dv * BK * 16);
      __syncwarp();
      load_rows_tma(mv, Vs, BK, j * BK, b, h, dv, lane, 32, vfull);
    }
  };
  if (warp == 0) {
    if (lane == 0) mbar_expect_tx(qbar, (uint32_t)dv * BQ * 16);
    __syncwarp();
    load_rows_tma(mq, Qs, BQ, q0, b, h, dv, lane, 32, qbar);
    load_k(0);
    const int v0 = PV8 ? next_pv(-1) : 0;
    if (v0 < n_steps) load_v(v0);
  }

  float oacc[HALF / 2];
#pragma unroll
  for (int k = 0; k < HALF / 2; ++k) oacc[k] = 0.f;
  float s[XV];
#pragma unroll
  for (int k = 0; k < XV; ++k) s[k] = 0.f;
  float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;   // rows g and g + 8
  float mx_lo = -INFINITY, mx_hi = -INFINITY;                    // PV8: the super-tile's max
  int isum_lo = 0, isum_hi = 0;                                  // PV8: its p_i8 sums
  int vcount = 0;                                                // V tiles consumed
  mbar_wait(qbar, 0);

  for (int i = 0; i < n_steps; ++i) {
    int j;
    const bool pv = step_of(i, j);
    const int valid = Skv - j * BK;

    // ---- S: the two warpgroups' partials, swapped ------------------------
    if (!PIPE || i == 0) {
      mbar_wait(kfull, i & 1);
      s_partial<DP>(s, Qs, Ks, Sx, wg, tw);
      named_sync(1, THREADS);
      if (warp == 0 && i + 1 < n_steps) load_k(i + 1);
    }
    s_gather(s, Sx, wg, tw, valid, t);

    if (PV8 && !pv) {
      // ---- PV8 pass 1: the row max; at the super-tile's last sub-tile, m
      // moves and O and l are rescaled once ------------------------------------
#pragma unroll
      for (int k = 0; k < XV; k += 4) {
        mx_lo = fmaxf(mx_lo, fmaxf(s[k], s[k + 1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[k + 2], s[k + 3]));
      }
      int jn;
      if (i + 1 < n_steps && !step_of(i + 1, jn)) {
        named_sync(1, THREADS);   // both read the other's partial
        continue;
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
        for (int k = 0; k < HALF / 2; ++k) oacc[k] *= (k & 2) ? c_hi : c_lo;
      }
      mx_lo = mx_hi = -INFINITY;
      named_sync(1, THREADS);
      continue;
    }

    if (PV8) {
      // ---- PV8 pass 2: p_i8 in registers, the int8 product in 64-column
      // chunks, each chunk's int32 sum into O at vs / 127 --------------------
#pragma unroll
      for (int k = 0; k < XV; ++k) {
        const float x = fmaf(s[k], scale_log2, -((k & 2) ? m_hi : m_lo));
        s[k] = EXPB ? exp2_bf16(x) : fast_exp2(x);
      }
      uint32_t a[BK / 32][4];
      pack_p_i8<BK / 32>(a, s, isum_lo, isum_hi);
      mbar_wait(vfull, vcount & 1);
      ++vcount;
      const int8_t* V8 = reinterpret_cast<const int8_t*>(Vb);
      const float* vm = vmb + (j / spt) * DP + wg * HALF;
#pragma unroll
      for (int cc = 0; cc < HALF / 64; ++cc) {
        int acc[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[k] = 0;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          Wgmma8<64>::rs(acc, a[kk],
                         gmma_desc(V8 + kk * 2 * DP * 16 + (wg * HALF + 64 * cc) * 16, DP * 16,
                                   128),
                         kk > 0);
        wg_commit();
        wg_wait_all();
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 mul = __ldg(reinterpret_cast<const float2*>(vm + 64 * cc + nt * 8 + 2 * t));
          float* od = oacc + 4 * (8 * cc + nt);
          od[0] += (float)acc[4 * nt] * mul.x;
          od[1] += (float)acc[4 * nt + 1] * mul.y;
          od[2] += (float)acc[4 * nt + 2] * mul.x;
          od[3] += (float)acc[4 * nt + 3] * mul.y;
        }
      }
      int jn;
      if (i + 1 == n_steps || !step_of(i + 1, jn)) {   // the super-tile's last product
        l_lo += (float)isum_lo / 127.f;
        l_hi += (float)isum_hi / 127.f;
        isum_lo = isum_hi = 0;
      }
    } else {
      // ---- online softmax, P in registers, O += P V ------------------------
      float mt_lo = -INFINITY, mt_hi = -INFINITY;
#pragma unroll
      for (int k = 0; k < XV; k += 4) {
        mt_lo = fmaxf(mt_lo, fmaxf(s[k], s[k + 1]));
        mt_hi = fmaxf(mt_hi, fmaxf(s[k + 2], s[k + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mt_lo = fmaxf(mt_lo, __shfl_xor_sync(0xffffffffu, mt_lo, off));
        mt_hi = fmaxf(mt_hi, __shfl_xor_sync(0xffffffffu, mt_hi, off));
      }
      const float mn_lo = fmaxf(m_lo, mt_lo * scale_log2);
      const float mn_hi = fmaxf(m_hi, mt_hi * scale_log2);
      const float c_lo = fast_exp2(m_lo - mn_lo), c_hi = fast_exp2(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int k = 0; k < XV; ++k) {
        const float x = fmaf(s[k], scale_log2, -((k & 2) ? mn_hi : mn_lo));
        s[k] = EXPB ? exp2_bf16(x) : fast_exp2(x);
        if (k & 2)
          sum_hi += s[k];
        else
          sum_lo += s[k];
      }
      l_lo = c_lo * l_lo + sum_lo;
      l_hi = c_hi * l_hi + sum_hi;
      if (__any_sync(0xffffffffu, c_lo != 1.f || c_hi != 1.f)) {
#pragma unroll
        for (int k = 0; k < HALF / 2; ++k) oacc[k] *= (k & 2) ? c_hi : c_lo;
      }
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        a[kk][0] = sdk::pack_bf16(s[8 * kk], s[8 * kk + 1]);
        a[kk][1] = sdk::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        a[kk][2] = sdk::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        a[kk][3] = sdk::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      // PIPE: S of step i + 1 goes to the tensor cores first, then P_i V_i
      const bool ahead = PIPE && i + 1 < n_steps;
      if (ahead) mbar_wait(kfull, (i + 1) & 1);
      mbar_wait(vfull, vcount & 1);
      ++vcount;
      wg_fence();
      if (ahead) {
#pragma unroll
        for (int kk = 0; kk < HALF / 16; ++kk)
          Wgmma<BK>::ss(s, gmma_desc(Qs + cm_off<BQ>(0, wg * HALF + 16 * kk), BQ * 16, 128),
                        gmma_desc(Ks + cm_off<BK>(0, wg * HALF + 16 * kk), BK * 16, 128),
                        kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<HALF>::rs(oacc, a[kk], gmma_desc(Vs + cm_off<BK>(16 * kk, wg * HALF), 128, BK * 16));
      wg_commit();
      wg_wait_all();
      if (ahead) {
        // both warpgroups are past their read of Sx (the barrier ending step
        // i - 1 came after it), and this one has finished reading K and V
        named_sync(1, THREADS);
        float* mine = Sx + wg * XV * 128 + tw;
#pragma unroll
        for (int k = 0; k < XV; ++k) mine[k * 128] = s[k];
        named_sync(1, THREADS);
        if (warp == 0) {
          if (i + 2 < n_steps) load_k(i + 2);
          load_v(i + 1);
        }
        continue;
      }
    }
    // ---- both warpgroups are done with this step's V tile and partials ------
    named_sync(1, THREADS);
    if (warp == 0 && pv) {
      const int nv = PV8 ? next_pv(i) : i + 1;
      if (nv < n_steps) load_v(nv);
    }
  }

  // ---- l across the quad, O / l, bf16, strided store -------------------------
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  const int r_lo = q0 + 16 * wl + g, r_hi = r_lo + 8;
  if (LSE && n_split > 1) {
    // a part of a split sweep: unnormalized O, m and l for the combine launch
    const long long rows = (long long)gridDim.y * Sq, row0 = (long long)bh * Sq;
    float* po = part + (blockIdx.z * rows + row0) * D;
    float* pml = part + n_split * rows * D + (blockIdx.z * rows + row0) * 2;
#pragma unroll
    for (int nt = 0; nt < HALF / 8; ++nt) {
      const int col = wg * HALF + nt * 8 + 2 * t;
      if (col < D) {
        if (r_lo < Sq)
          *reinterpret_cast<float2*>(po + (long long)r_lo * D + col) =
              make_float2(oacc[4 * nt], oacc[4 * nt + 1]);
        if (r_hi < Sq)
          *reinterpret_cast<float2*>(po + (long long)r_hi * D + col) =
              make_float2(oacc[4 * nt + 2], oacc[4 * nt + 3]);
      }
    }
    if (wg == 0 && t == 0) {
      if (r_lo < Sq) *reinterpret_cast<float2*>(pml + 2 * r_lo) = make_float2(m_lo, l_lo);
      if (r_hi < Sq) *reinterpret_cast<float2*>(pml + 2 * r_hi) = make_float2(m_hi, l_hi);
    }
    return;
  }
  if (LSE && wg == 0 && t == 0) {
    // the training epilogue: lse2 = m + log2(l) (m is in scaled base-2 units);
    // both warpgroups hold the same m and l, warpgroup 0 writes them
    float* lrow = lse + (long long)bh * Sq;
    if (r_lo < Sq) lrow[r_lo] = l_lo > 0.f ? m_lo + log2f(l_lo) : NEG_LSE;
    if (r_hi < Sq) lrow[r_hi] = l_hi > 0.f ? m_hi + log2f(l_hi) : NEG_LSE;
  }
#pragma unroll
  for (int nt = 0; nt < HALF / 8; ++nt) {
    const int col = wg * HALF + nt * 8 + 2 * t;
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

template <int DP, bool EXPB, bool PIPE, bool PV8, bool LSE = false>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int8_t* codes, float* vmul,
           float* lse, float* part, int n_split, int B, int H, int Sq, int Skv, int D, int T,
           const long long* st, float scale_log2, cudaStream_t stream) {
  using C = CfgWide<DP, PV8>;
  int e = PV8 ? launch_v_codes<DP>(v, codes, vmul, B, H, Skv, D, T, st + 6, stream) : 0;
  ViewMap mq, mk, mv;
  if (!e) e = make_view_map(&mq, q, B, Sq, H, D, st[0], st[1], st[2], BQ);
  if (!e) e = make_view_map(&mk, k, B, Skv, H, D, st[3], st[4], st[5], BK);
  if (!e) e = make_view_map(&mv, v, B, Skv, H, D, st[6], st[7], st[8], BK);
  if (e) return e;
  auto kern = flash_fwd_wide_kernel<DP, EXPB, PIPE, PV8, LSE>;
  SDK_SET_SMEM(kern, C::SMEM);
  dim3 grid((Sq + BQ - 1) / BQ, B * H, n_split);
  kern<<<grid, THREADS, C::SMEM, stream>>>(mq, mk, mv, codes, vmul, o, lse, part, H, Sq, Skv, D,
                                           T, st[9], st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

// The training forward's kv split: part z of a row's sweep left its
// unnormalized fp32 O, its max m and its sum l in `part`
// [n_split][B*H][Sq][D] and `ml` [n_split][B*H][Sq][2]; one block per row
// rescales the parts to the common max and writes
// o = sum_z 2^(m_z - m) O_z / max(l, 1e-30) (bf16, strided) and
// lse2 = m + log2(l), l = sum_z 2^(m_z - m) l_z (NEG_LSE where l = 0).
__global__ void __launch_bounds__(64)
lse_combine_kernel(const float* __restrict__ part, const float* __restrict__ ml,
                   bf16* __restrict__ o, float* __restrict__ lse, int H, int Sq, int D,
                   int n_split, long long o_sb, long long o_ss, long long o_sh) {
  const long long rows = gridDim.x, row = blockIdx.x;   // row = (b*H + h)*Sq + r
  const int bh = (int)(row / Sq), r = (int)(row % Sq);
  float m = -INFINITY;
  for (int z = 0; z < n_split; ++z) m = fmaxf(m, ml[(z * rows + row) * 2]);
  float c[MAX_SPLIT], l = 0.f;
#pragma unroll
  for (int z = 0; z < MAX_SPLIT; ++z) {
    c[z] = z < n_split ? exp2f(ml[(z * rows + row) * 2] - m) : 0.f;
    if (z < n_split) l += c[z] * ml[(z * rows + row) * 2 + 1];
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  bf16* orow = o + (bh / H) * o_sb + (bh % H) * o_sh + r * o_ss;
  for (int col = 2 * threadIdx.x; col < D; col += 2 * blockDim.x) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int z = 0; z < MAX_SPLIT; ++z) {
      if (z < n_split) {
        const float2 p = *reinterpret_cast<const float2*>(part + (z * rows + row) * D + col);
        a0 += c[z] * p.x;
        a1 += c[z] * p.y;
      }
    }
    sdk::st32(orow + col, a0 * inv, a1 * inv);
  }
  if (threadIdx.x == 0) lse[row] = l > 0.f ? m + log2f(l) : NEG_LSE;
}

template <int DP>
int fwd(const bf16* Q, const bf16* K, const bf16* V, bf16* O, int8_t* codes, float* vmul, int B,
        int H, int Sq, int Skv, int D, int T, const long long* strides, float scale_log2,
        int pipelined, int exp_bf16, int pv_int8, cudaStream_t s) {
#define SDK_WIDE(E, P, I)                                                                  \
  launch<DP, E, P, I>(Q, K, V, O, codes, vmul, nullptr, nullptr, 1, B, H, Sq, Skv, D, T, strides, \
                      scale_log2, s)
  if (pv_int8) return exp_bf16 ? SDK_WIDE(true, false, true) : SDK_WIDE(false, false, true);
  if (pipelined) return exp_bf16 ? SDK_WIDE(true, true, false) : SDK_WIDE(false, true, false);
  return exp_bf16 ? SDK_WIDE(true, false, false) : SDK_WIDE(false, false, false);
#undef SDK_WIDE
}

}  // namespace

// q, k, v, o: [B, S, H, D] bf16 views with unit stride along D, 128 < D <=
// 512 a multiple of 8, 16-byte aligned, strides multiples of 8 elements;
// `strides` holds (batch, row, head) strides in elements for q, k, v, o in
// that order. pipelined = 1 runs the pipelined sweep (the same bits),
// exp_bf16 = 1 the bf16 softmax exponential, pv_int8 = 1 the int8 PV
// product (not with pipelined) over kv super-tiles of block_k rows (a
// positive multiple of 64), with `codes` [B*H, ceil(Skv/block_k)*block_k,
// DP] int8 and `vmul` [B*H, ceil(Skv/block_k), DP] fp32 scratch for the
// pre-pass (DP = 256 for D <= 256, else 512; both unused without pv_int8).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int sd_flash_fwd_wide(const void* q, const void* k, const void* v, void* o,
                                 void* codes, void* vmul, int B, int H, int Sq, int Skv, int D,
                                 const long long* strides, float scale_log2, int pipelined,
                                 int exp_bf16, int pv_int8, int block_k, void* stream) {
  if (D % 8 || D <= 128 || D > 512 || (pipelined && pv_int8) ||
      (pv_int8 && (block_k <= 0 || block_k % BK)))
    return (int)cudaErrorInvalidValue;
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(o);
  int8_t* C8 = static_cast<int8_t*>(codes);
  float* VM = static_cast<float*>(vmul);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 256 ? fwd<256>(Q, K, V, O, C8, VM, B, H, Sq, Skv, D, block_k, strides, scale_log2,
                             pipelined, exp_bf16, pv_int8, s)
                  : fwd<512>(Q, K, V, O, C8, VM, B, H, Sq, Skv, D, block_k, strides, scale_log2,
                             pipelined, exp_bf16, pv_int8, s);
}

// The training forward (`_flash_kernel_lse`): the serial sweep with the fp32
// exponential over the same views, 128 < D <= 512, plus lse2 [B*H, Sq] fp32
// (row b*H + h), NEG_LSE where a row's sum is 0. n_split > 1 (at most
// MAX_SPLIT) splits each row's kv sweep into that many parts, written to
// `part`, fp32 scratch of n_split * B * H * Sq * (D + 2) values (unused for
// n_split = 1), and leaves o and lse to `sd_flash_lse_combine`. Returns the
// CUDA error code of the launch.
extern "C" int sd_flash_fwd_wide_lse(const void* q, const void* k, const void* v, void* o,
                                     void* lse, void* part, int B, int H, int Sq, int Skv, int D,
                                     const long long* strides, float scale_log2, int n_split,
                                     void* stream) {
  if (D % 8 || D <= 128 || D > 512 || n_split < 1 || n_split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  const bf16* Q = static_cast<const bf16*>(q);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(o);
  float* L = static_cast<float*>(lse);
  float* P = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 256 ? launch<256, false, false, false, true>(Q, K, V, O, nullptr, nullptr, L, P,
                                                           n_split, B, H, Sq, Skv, D, 0, strides,
                                                           scale_log2, s)
                  : launch<512, false, false, false, true>(Q, K, V, O, nullptr, nullptr, L, P,
                                                           n_split, B, H, Sq, Skv, D, 0, strides,
                                                           scale_log2, s);
}

// The combine launch of a split training forward: o and lse2 from the
// n_split parts in `part` (as sd_flash_fwd_wide_lse leaves them);
// `o_strides` holds o's (batch, row, head) strides in elements. Returns the
// CUDA error code of the launch.
extern "C" int sd_flash_lse_combine(const void* part, void* o, void* lse, int B, int H, int Sq,
                                    int D, int n_split, const long long* o_strides,
                                    void* stream) {
  if (D % 8 || D <= 0 || n_split < 2 || n_split > MAX_SPLIT) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * H * Sq;
  const float* P = static_cast<const float*>(part);
  lse_combine_kernel<<<(unsigned)rows, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      P, P + n_split * rows * D, static_cast<bf16*>(o), static_cast<float*>(lse), H, Sq, D,
      n_split, o_strides[0], o_strides[1], o_strides[2]);
  return (int)cudaGetLastError();
}

// Dynamic shared memory (bytes) of the sweep for head dim D (the build report).
extern "C" int sd_flash_fwd_wide_smem(int D, int pv_int8) {
  if (D <= 128 || D > 512) return -1;
  if (D <= 256) return (int)(pv_int8 ? CfgWide<256, true>::SMEM : CfgWide<256, false>::SMEM);
  return (int)(pv_int8 ? CfgWide<512, true>::SMEM : CfgWide<512, false>::SMEM);
}
