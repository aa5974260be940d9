// Flash-attention backward for Hopper at head dims 129-512: the dQ kernel
// and the dK/dV kernel (bf16 in and out, fp32 accumulation) as warpgroup
// products (wgmma) on tiles that arrive by TMA; at padded head dim 512 the
// head dim is split over a cluster of two blocks.
//
// Replaces, above head dim 128, the TPU kernels `_flash_bwd_dq_kernel`
// (sd_tpu/kernels/flash_attention.py:465) and `_flash_bwd_dkv_kernel` (:511)
// behind the `jax.custom_vjp` of `flash_attention` (`_bwd` :743; the TPU
// package shrinks its tiles there, `_bwd_geometry` :621). The codec's
// single-head d = 512 (`train_kl_vae`, [4, 1024, 1, 512]) runs here;
// `flash_attention_bwd.cu`'s wide kernels (mma.sync) are the yardstick.
//
// Math (the TPU kernels'), with s2 = q k^T * scale * log2(e):
//   p     = exp2(s2 - lse2)              (0 where lse2 <= NEG/2)
//   delta = rowsum(dO * O)               (fp32, written by the dQ kernel)
//   dS    = p * (dO v^T - delta)
//   dQ    = scale * bf16(dS) k           dV = bf16(p)^T dO
//   dK    = scale * bf16(dS)^T q
// The TPU split into a dQ and a dK/dV kernel is kept; no atomics: every
// output element is written by exactly one thread, and every sum runs in a
// fixed order, so dQ, dK and dV are the same bits on every run.
//
// What bounds it on the H100: per head 6*Sq*Skv*d (dQ) and 8*Sq*Skv*d (dK/dV)
// tensor-core flops against O((Sq + Skv) * d) bytes, so operations. What
// stands in the way at d = 512, and what the design does about it:
//   * registers: dK and dV of one 64-row kv slab are 2 x 64 x 512 fp32 =
//     256 KB, a whole SM's register file, and wgmma's M is 64 a warpgroup.
//     So a block holds HD = 256 head columns: at padded head dim 512
//     (`SPLIT` 2) a cluster of two blocks shares each 64-row slab, block r
//     owning output columns [256 r, 256 r + 256) and holding only its half
//     of every operand; at 256 one block holds them all (`SPLIT` 1, no
//     exchange; kernels/flash_attention.py `bwd_wide_split`). A 128-column
//     half at padded head dim 256 was tried: a step took as long as the
//     256-column one (~1.3 us on an H100, the exchange's and the step's
//     fixed costs), so it bought nothing.
//   * S (S^T) and dP (dP^T) contract over the whole head dim: with SPLIT 2
//     each block forms its partial over its half and writes it into the
//     peer's shared memory with st.async, each store counted as bytes on the
//     peer's mbarrier (the receiving warpgroup posts the 8 KB it expects),
//     then adds the peer's. fp32 addition commutes, so block 0's p0 + p1 and
//     block 1's p1 + p0 are the same bits: both blocks hold the same S and
//     dP. A thread's 16 values go to the peer's thread of the same index,
//     which holds the same tile positions, in a layout of 16-byte vectors
//     without bank conflicts; two slots, so a block writes slot s again only
//     after the peer's next partial arrived, which the peer sends after
//     reading slot s. Remote stores with one release arrival a thread
//     instead (128 a warpgroup and step) added ~1.1 us a step at
//     [4, 1024, 1, 512] on an H100 over the one-block form at d = 256;
//     st.async ~0.3. dQ's delta is exchanged once, before the sweep, by a
//     remote read after the cluster barrier;
//   * each warpgroup issues step j + 1's first product before it waits for
//     step j's partial from the peer, so the tensor cores run meanwhile;
//   * two consumer warpgroups share the block's 64-row slab by role:
//     warpgroup 0 forms S and P, warpgroup 1 dP; P (dQ: each its tile)
//     passes to the other warpgroup through shared memory, thread to thread,
//     behind one named barrier a step. dK/dV: warpgroup 0 accumulates dV and
//     warpgroup 1 dK over the block's 256 columns (128 fp32 a thread); dQ:
//     each accumulates 128 of them. P and dS are rounded to bf16 in
//     registers into the A operand of the second products, whose B is the
//     streamed tile read MN-major through a second descriptor (no transposed
//     copy is stored);
//   * shared memory: the block keeps its 64-row slabs (K and V; Q and dO) at
//     256 columns resident and streams the other side's two tensors in
//     T = 32 row tiles (wgmma N = 32 for the first products) through a
//     3-stage ring that a producer warp fills by TMA ("full" and "empty"
//     mbarriers, as in flash_attention_bwd_sm90.cu); its warpgroup gives its
//     registers to the consumers (setmaxnreg 40 / 232: with 168 a thread,
//     dK/dV spilled and ptxas serialized its wgmma); a 64-row tile would not
//     fit beside the slabs. Per block at [4, 1024, 1, 512] the sweep reads
//     1 MB of the other side from L2 (the template's 32-row blocks 2 MB);
//   * masks by index, as flash_attention_bwd_sm90.cu: kv columns past Skv
//     (dQ) and q columns past Sq (dK/dV) take lse2 = +1e30 and delta 0.
// Tiles sit in groups of 64 head columns, each rows x 128 bytes in the
// 128-byte swizzle, one TMA box a group (a 32-row tile: 4 boxes of 4 KB a
// tensor); the first products read them K-major, the second MN-major
// (`gmma_desc_sw128_mn`). 8-column boxes of 512 bytes in the no-swizzle
// layout (64 boxes a step) held a step to ~3.6 us on an H100. Groups past D
// are zeroed once and never loaded.
#include "sm90.cuh"

namespace {

constexpr int R = 64;             // own rows of a block (one slab, wgmma's M)
constexpr int T = 32;             // rows of a streamed tile
constexpr int HD = 256;           // head columns a block holds
constexpr int ST = 3;             // ring depth
constexpr int WG = 128;           // threads of a warpgroup
constexpr int XF = R * T / WG;    // fp32 values of a 64 x 32 tile a thread holds
constexpr float NEG = -1e30f;     // lse2 of a row whose sum is 0 (`NEG_INF`)

// SPLIT: blocks of a cluster (2: padded head dim 512, 1: 256)
template <int SPLIT, bool DKV>
struct WideCfg {
  static constexpr int SLAB = R * HD;                      // elements of a resident slab
  static constexpr int TILE = T * HD;                      // elements of a streamed tile
  static constexpr int THREADS = 3 * WG;                   // + the producer warpgroup
  static constexpr int NACC = DKV ? HD / 2 : HD / 4;       // accumulator values a thread
  static constexpr int STAGE = 2 * TILE * 2;               // a stage: the two streamed tiles
  static constexpr int XBYTES = WG * XF * 4;               // one warpgroup's tile in fp32
  static constexpr int OFF_RING = 2 * SLAB * 2;
  static constexpr int OFF_RL = OFF_RING + ST * STAGE;     // dK/dV: each stage's lse2, delta
  static constexpr int OFF_RECV = OFF_RL + (DKV ? ST * 2 * T * 4 : 0);   // the peer's partials
  static constexpr int OFF_HAND = OFF_RECV + (SPLIT > 1 ? 4 * XBYTES : 0);   // [role][slot]
  static constexpr int OFF_BAR = OFF_HAND + (DKV ? 2 : 4) * XBYTES;   // hand-overs [(role)][slot]
  static constexpr int OFF_DELTA = OFF_BAR + (2 * ST + 1 + 4) * 8;    // dQ: delta partials
  // + 1024: the base is aligned up to the 128-byte swizzle's 1024-byte atom
  static constexpr size_t SMEM = (size_t)OFF_DELTA + (DKV ? 0 : R * 4) + 1024;
  static_assert(SPLIT == 1 || SPLIT == 2, "a block or a pair a slab");
  static_assert(STAGE % 1024 == 0 && SMEM <= 232448, "shared memory");
};

// what the body reads besides its four tensor maps
struct WideArgs {
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

// float offset of a thread's 16-byte vector i (of XF / 4) in a warpgroup's
// fp32 tile: vector i of every thread, then vector i + 1, so a warp's
// accesses are consecutive 16-byte words
__device__ __forceinline__ int xoff(int i, int tw) { return (i * WG + tw) * 4; }

// A tile of `rows` rows x HD head columns is HD/64 groups of 64 columns, each
// `rows` rows of 128 bytes in the 128-byte swizzle, one TMA box a group:
// groups [0, ng) of rows [r0, r0 + rows) of head (b, h) of a view, from head
// column c0 on (rows past the end and columns past D arrive as zeros)
__device__ __forceinline__ void load_groups(const ViewMap& m, bf16* dst, int rows, int r0, int b,
                                            int h, int c0, int ng, uint64_t* bar) {
  for (int gi = 0; gi < ng; ++gi)
    tma_load_4d(dst + gi * rows * 64, &m.map, c0 + 64 * gi, m.hfirst ? h : r0, m.hfirst ? r0 : h,
                b, bar);
}

// P = 2^(s * scale_log2 - lse2) in place over the dK/dV kernel's 64 x 32 S^T
// (x: rows g and g + 8 of the thread's warp, columns 8n + 2t and + 1 of each
// n8 group n); lse2 per column from the stage (`rl`: 32 lse2, then 32
// delta); columns at or past `valid` (q rows past Sq) or whose lse2 marks a
// zero sum take lse2 = +1e30, so P is 0 there whatever the stage holds
__device__ __forceinline__ void p_cols(float (&x)[XF], const float* rl, int valid, int t,
                                       float scale_log2) {
#pragma unroll
  for (int n = 0; n < T / 8; ++n) {
    const int cl = 8 * n + 2 * t;
    const float2 lc = *reinterpret_cast<const float2*>(rl + cl);
    const float l[2] = {cl < valid && lc.x > NEG / 2 ? lc.x : -NEG,
                        cl + 1 < valid && lc.y > NEG / 2 ? lc.y : -NEG};
#pragma unroll
    for (int e = 0; e < 4; ++e) x[4 * n + e] = fast_exp2(fmaf(x[4 * n + e], scale_log2, -l[e & 1]));
  }
}

// dS = P (dP - delta) in place over the same tile: y holds dP^T, p P^T;
// delta per column from the stage, 0 on the columns p_cols masks
__device__ __forceinline__ void ds_cols(float (&y)[XF], const float (&p)[XF], const float* rl,
                                        int valid, int t) {
#pragma unroll
  for (int n = 0; n < T / 8; ++n) {
    const int cl = 8 * n + 2 * t;
    const float2 lc = *reinterpret_cast<const float2*>(rl + cl);
    const float2 dc = *reinterpret_cast<const float2*>(rl + T + cl);
    const float dd[2] = {cl < valid && lc.x > NEG / 2 ? dc.x : 0.f,
                         cl + 1 < valid && lc.y > NEG / 2 ? dc.y : 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) y[4 * n + e] = p[4 * n + e] * (y[4 * n + e] - dd[e & 1]);
  }
}

// P = 2^(s * scale_log2 - lse2) in place over the dQ kernel's 64 x 32 S,
// lse2 per row (rows g and g + 8); with EDGE, columns at or past `lim` (kv
// rows past Skv) take lse2 = +1e30, so P is 0 there
template <bool EDGE>
__device__ __forceinline__ void p_rows(float (&x)[XF], float l_lo, float l_hi, int lim, int t,
                                       float scale_log2) {
#pragma unroll
  for (int i = 0; i < XF; ++i) {
    float l = (i & 2) ? l_hi : l_lo;
    if (EDGE && 8 * (i >> 2) + 2 * t + (i & 1) >= lim) l = -NEG;
    x[i] = fast_exp2(fmaf(x[i], scale_log2, -l));
  }
}

// the bf16 A fragments of the k16 steps of a 64 x 32 tile in accumulator
// layout (two neighbouring n8 groups are one k16 step's A layout)
__device__ __forceinline__ void pack_a(uint32_t (&a)[T / 16][4], const float (&x)[XF]) {
#pragma unroll
  for (int kk = 0; kk < T / 16; ++kk) {
    a[kk][0] = sdk::pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = sdk::pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = sdk::pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = sdk::pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

__device__ __forceinline__ void put_tile(float* dst, const float (&x)[XF], int tw) {
#pragma unroll
  for (int i = 0; i < XF / 4; ++i)
    *reinterpret_cast<float4*>(dst + xoff(i, tw)) =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

__device__ __forceinline__ void get_tile(float (&x)[XF], const float* src, int tw) {
#pragma unroll
  for (int i = 0; i < XF / 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(src + xoff(i, tw));
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

// issue (and commit, not wait for) step j's first product over the block's
// head columns: x = A B^T with A the slab of the warpgroup's role and B the
// tile of the same role in stage j % ST, both K-major
template <int STAGE, int TILE>
__device__ __forceinline__ void first_product(float (&x)[XF], const bf16* A,
                                              const unsigned char* ring, uint64_t* full, int j,
                                              int wg) {
  const int s = j % ST;
  mbar_wait(full + s, (j / ST) & 1);
  const bf16* Bt = reinterpret_cast<const bf16*>(ring + s * STAGE) + wg * TILE;
  wg_fence();
  // k16 step kk: group kk / 4, 32 bytes into its rows per step within it
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    Wgmma<T>::ss(x, gmma_desc_sw128(A + (kk >> 2) * R * 64 + (kk & 3) * 16),
                 gmma_desc_sw128(Bt + (kk >> 2) * T * 64 + (kk & 3) * 16), kk > 0);
  wg_commit();
}

// mr1, mr2: the resident tensors (K, V for dK/dV; Q, dO for dQ), boxes of R
// rows; ms1, ms2: the streamed ones (Q, dO; K, V), boxes of T rows
template <int SPLIT, bool DKV>
__device__ __forceinline__ void wide_body(const ViewMap& mr1, const ViewMap& mr2,
                                          const ViewMap& ms1, const ViewMap& ms2,
                                          const WideArgs& a) {
  using C = WideCfg<SPLIT, DKV>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* res = reinterpret_cast<bf16*>(smem);    // slab 1, then slab 2
  unsigned char* ring = smem + C::OFF_RING;
  float* recv = reinterpret_cast<float*>(smem + C::OFF_RECV);
  float* hand = reinterpret_cast<float*>(smem + C::OFF_HAND);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + ST;
  uint64_t* rbar = empty + ST;
  uint64_t* xbar = rbar + 1;                    // [role][slot]: the peer's partial is in
  float* dpart = reinterpret_cast<float*>(smem + C::OFF_DELTA);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t rank = SPLIT > 1 ? cluster_rank() : 0u, peer = rank ^ 1u;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int own = DKV ? a.Skv : a.Sq, other = DKV ? a.Sq : a.Skv;
  const int r0 = (blockIdx.x / SPLIT) * R;      // the block's first own row
  const int c0 = (int)rank * HD;                // its first head column
  const int ng = min(HD / 64, (a.D - c0 + 63) / 64);   // its groups with data (D > 128: >= 1)
  const int n_t = (other + T - 1) / T;

  // groups [ng, HD/64) of the slabs and of every stage's tiles, all past D,
  // zeroed once (no copy writes them; the first products contract over them)
  const int padg = HD / 64 - ng;
  for (int idx = tid; idx < 2 * padg * R * 8; idx += C::THREADS)
    *reinterpret_cast<uint4*>(res + (idx / (padg * R * 8)) * C::SLAB + ng * R * 64 +
                              (idx % (padg * R * 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = tid; idx < 2 * ST * padg * T * 8; idx += C::THREADS) {
    const int tile = idx / (padg * T * 8);
    bf16* base = reinterpret_cast<bf16*>(ring + (tile >> 1) * C::STAGE) + (tile & 1) * C::TILE;
    *reinterpret_cast<uint4*>(base + ng * T * 64 + (idx % (padg * T * 8)) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, 32);                  // every producer lane arrives
      mbar_init(empty + i, 8);                  // every consumer warp
    }
    mbar_init(rbar, 1);
    for (int i = 0; i < 4; ++i) mbar_init(xbar + i, 1);   // the receiver's expect_tx
    mbar_init_fence();
  }
  fence_async_smem();
  __syncthreads();   // the block's barriers are initialised, its pad groups zeroed

  if (warp >= 8) {
    // ---- the producer warpgroup gives its registers to the consumers; its
    // first warp loads the resident slabs once, then tile j into stage j % ST
    // once its last use is done ------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    // the cluster's first barrier, in two halves: the peer may arrive on this
    // block's barriers once every thread of both blocks has arrived
    cluster_arrive();
    if (warp == 8) {
      if (lane == 0) {
        mbar_expect_tx(rbar, 2u * ng * R * 128);
        load_groups(mr1, res, R, r0, b, h, c0, ng, rbar);
        load_groups(mr2, res + C::SLAB, R, r0, b, h, c0, ng, rbar);
      }
      for (int j = 0; j < n_t; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(empty + s, (j / ST - 1) & 1);
        bf16* t1 = reinterpret_cast<bf16*>(ring + s * C::STAGE);
        float* rl = reinterpret_cast<float*>(smem + C::OFF_RL) + s * 2 * T;   // lse2, then delta
        const int i0 = j * T, valid = min(T, other - i0);
        const long long row0 = (long long)bh * a.Sq + i0;
        if (DKV && !a.bulk) {
          for (int i = lane; i < T; i += 32) {
            rl[i] = i < valid ? a.lse[row0 + i] : NEG;
            rl[T + i] = i < valid ? a.delta_in[row0 + i] : 0.f;
          }
        }
        if (lane == 0) {
          const bool bulk = DKV && a.bulk;
          mbar_expect_tx(full + s, 2u * ng * T * 128 + (bulk ? 8u * valid : 0u));
          load_groups(ms1, t1, T, i0, b, h, c0, ng, full + s);
          load_groups(ms2, t1 + C::TILE, T, i0, b, h, c0, ng, full + s);
          if (bulk) {
            bulk_load(rl, a.lse + row0, 4u * valid, full + s);
            bulk_load(rl + T, a.delta_in + row0, 4u * valid, full + s);
          }
        } else {
          mbar_arrive(full + s);
        }
      }
    }
    __syncwarp();
    cluster_wait();
  } else {
    // ---- the consumers: warpgroup 0 forms S, warpgroup 1 dP ---------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    if constexpr (!DKV) {
      // delta's partial over the block's head columns for the 64 own rows,
      // four threads a row, read from device memory while the slabs arrive
      const int lr = tid >> 2, part = tid & 3, rr = r0 + lr;
      float sum = 0.f;
      if (rr < a.Sq) {
        const bf16* orow = a.o + b * a.st[0] + (long long)rr * a.st[1] + h * a.st[2] + c0;
        const bf16* drow = a.dout + b * a.st[3] + (long long)rr * a.st[4] + h * a.st[5] + c0;
        const int dv = min(HD, a.D - c0) / 8;   // the block's 8-column chunks with data
#pragma unroll
        for (int i = 0; i < HD / 32; ++i) {    // chunks part, part + 4, ...: all loads in flight
          const int c = part + 4 * i;
          if (c < dv) {
            const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
            const uint4 dw = *reinterpret_cast<const uint4*>(drow + 8 * c);
            const bf16* oe = reinterpret_cast<const bf16*>(&ov);
            const bf16* de = reinterpret_cast<const bf16*>(&dw);
#pragma unroll
            for (int u = 0; u < 8; ++u) sum += __bfloat162float(oe[u]) * __bfloat162float(de[u]);
          }
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) dpart[lr] = sum;
    }
    cluster_arrive();   // ... and this block's delta partials are written
    cluster_wait();
    const int wg = warp >> 2, wl = warp & 3;
    const int g = lane >> 2, t = lane & 3, tw = tid & (WG - 1);
    const bf16* A = res + wg * C::SLAB;         // K (Q) for S, V (dO) for dP
    const int row_lo = r0 + 16 * wl + g, row_hi = row_lo + 8;
    float l_lo = NEG, l_hi = NEG, d_lo = 0.f, d_hi = 0.f;
    if constexpr (!DKV) {
      // delta of the thread's rows: the blocks' partials added (commutes: both
      // blocks hold the same bits); block 0 writes it for the dK/dV kernel
      const int lr = 16 * wl + g;
      d_lo = dpart[lr];
      d_hi = dpart[lr + 8];
      if (SPLIT > 1) {
        d_lo += ld_cluster_f32(cluster_addr(dpart + lr, peer));
        d_hi += ld_cluster_f32(cluster_addr(dpart + lr + 8, peer));
      }
      if (rank == 0 && wg == 0 && t == 0) {
        if (row_lo < a.Sq) a.delta_out[(long long)bh * a.Sq + row_lo] = d_lo;
        if (row_hi < a.Sq) a.delta_out[(long long)bh * a.Sq + row_hi] = d_hi;
      }
      if (row_lo < a.Sq) l_lo = a.lse[(long long)bh * a.Sq + row_lo];
      if (row_hi < a.Sq) l_hi = a.lse[(long long)bh * a.Sq + row_hi];
    }
    // a row whose lse2 marks a zero sum (or lies past Sq) takes lse2 = +1e30:
    // its p is then 0 with no select per element
    if (!(l_lo > NEG / 2)) l_lo = -NEG;
    if (!(l_hi > NEG / 2)) l_hi = -NEG;

    float acc[C::NACC];      // dK/dV: dV (warpgroup 0), dK (1); dQ: its HD/2 columns
#pragma unroll
    for (int i = 0; i < C::NACC; ++i) acc[i] = 0.f;
    // this step's partial (then P or dS), the next step's (its first product
    // in flight), the tile received from the peer or the other warpgroup
    float x[XF], xn[XF], o[XF];
#pragma unroll
    for (int i = 0; i < XF; ++i) x[i] = xn[i] = 0.f;
    uint32_t af[T / 16][4];
    mbar_wait(rbar, 0);
    first_product<C::STAGE, C::TILE>(x, A, ring, full, 0, wg);
    wg_wait_all();

    for (int j = 0; j < n_t; ++j) {
      const int s = j % ST, slot = j & 1;
      const bf16* T1 = reinterpret_cast<const bf16*>(ring + s * C::STAGE);
      const bf16* T2 = T1 + C::TILE;
      const float* rl = reinterpret_cast<const float*>(smem + C::OFF_RL) + s * 2 * T;
      float* in = recv + (wg * 2 + slot) * (WG * XF);

      // ---- step j's partial into the peer's receive slot, step j + 1's first
      // product, then the peer's partial of step j, added
      if constexpr (SPLIT > 1) {
        const uint32_t rin = cluster_addr(in, peer);
        const uint32_t rbar = cluster_addr(xbar + wg * 2 + slot, peer);
#pragma unroll
        for (int i = 0; i < XF / 4; ++i)
          st_async_f4(rin + 4 * xoff(i, tw), x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3],
                      rbar);
      }
      if (j + 1 < n_t) first_product<C::STAGE, C::TILE>(xn, A, ring, full, j + 1, wg);
      if constexpr (SPLIT > 1) {
        if (tw == 0) mbar_expect_tx(xbar + wg * 2 + slot, C::XBYTES);
        mbar_wait_cluster(xbar + wg * 2 + slot, (j >> 1) & 1);
        get_tile(o, in, tw);
#pragma unroll
        for (int i = 0; i < XF; ++i) x[i] += o[i];
      }

      // ---- P, dS, the hand-over between the warpgroups -------------------------
      if constexpr (DKV) {
        const int valid = a.Sq - j * T;
        float* hp = hand + slot * (WG * XF);
        if (wg == 0) {
          p_cols(x, rl, valid, t, a.scale_log2);
          put_tile(hp, x, tw);
          named_sync(1, 2 * WG);
        } else {
          named_sync(1, 2 * WG);
          get_tile(o, hp, tw);
          ds_cols(x, o, rl, valid, t);
        }
      } else {
        const int c_0 = j * T;
        if (wg == 0) {
          if (c_0 + T <= a.Skv)
            p_rows<false>(x, l_lo, l_hi, T, t, a.scale_log2);
          else
            p_rows<true>(x, l_lo, l_hi, a.Skv - c_0, t, a.scale_log2);
        }
        put_tile(hand + (wg * 2 + slot) * (WG * XF), x, tw);
        named_sync(1, 2 * WG);
        get_tile(o, hand + ((wg ^ 1) * 2 + slot) * (WG * XF), tw);
        // dS = P (dP - delta): warpgroup 0 holds P and reads dP, 1 the other
        // way round; the same operands in the same order, so the same bits
#pragma unroll
        for (int i = 0; i < XF; ++i) {
          const float p = wg == 0 ? x[i] : o[i], dp = wg == 0 ? o[i] : x[i];
          x[i] = p * (dp - ((i & 2) ? d_hi : d_lo));
        }
      }
      pack_a(af, x);

      // ---- the second product: A = P or dS from registers, B the streamed tile
      // MN-major (dK/dV: dV += P^T dO, dK += dS^T Q; dQ: dQ += dS K over the
      // warpgroup's HD/2 columns)
      const bf16* B2 = DKV ? (wg == 0 ? T2 : T1) : T1 + (wg * HD / 128) * T * 64;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk)   // k16 step kk: tile rows 16 kk .. + 15
        Wgmma<DKV ? HD : HD / 2>::rs(acc, af[kk], gmma_desc_sw128_mn(B2 + kk * 16 * 64, T * 128));
      wg_commit();
      wg_wait_all();   // the second product and step j + 1's first product
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
#pragma unroll
      for (int i = 0; i < XF; ++i) x[i] = xn[i];
    }

    // ---- dQ * scale, dK * scale, dV: bf16, strided store ------------------------
    bf16* out;
    long long rs;
    float sc = a.scale;
    int col0 = c0;
    if (DKV && wg == 0) {
      out = a.out2 + b * a.st[9] + h * a.st[11];
      rs = a.st[10];
      sc = 1.f;
    } else {
      out = a.out1 + b * a.st[6] + h * a.st[8];
      rs = a.st[7];
      if (!DKV) col0 += wg * HD / 2;
    }
    const int own_rows = own;
#pragma unroll
    for (int nt = 0; nt < C::NACC / 4; ++nt) {
      const int col = col0 + nt * 8 + 2 * t;
      if (col >= a.D) continue;
      if (row_lo < own_rows)
        sdk::st32(out + (long long)row_lo * rs + col, acc[4 * nt] * sc, acc[4 * nt + 1] * sc);
      if (row_hi < own_rows)
        sdk::st32(out + (long long)row_hi * rs + col, acc[4 * nt + 2] * sc, acc[4 * nt + 3] * sc);
    }
  }
  // no block leaves while its peer may still read or write its shared memory
  __syncwarp();
  cluster_sync();
}

template <int SPLIT>
__global__ void __launch_bounds__(WideCfg<SPLIT, false>::THREADS, 1)
flash_bwd_dq_wide_sm90_kernel(const __grid_constant__ ViewMap mq,
                              const __grid_constant__ ViewMap mdo,
                              const __grid_constant__ ViewMap mk,
                              const __grid_constant__ ViewMap mv,
                              const __grid_constant__ WideArgs a) {
  wide_body<SPLIT, false>(mq, mdo, mk, mv, a);
}

template <int SPLIT>
__global__ void __launch_bounds__(WideCfg<SPLIT, true>::THREADS, 1)
flash_bwd_dkv_wide_sm90_kernel(const __grid_constant__ ViewMap mk,
                               const __grid_constant__ ViewMap mv,
                               const __grid_constant__ ViewMap mq,
                               const __grid_constant__ ViewMap mdo,
                               const __grid_constant__ WideArgs a) {
  wide_body<SPLIT, true>(mk, mv, mq, mdo, a);
}

template <int SPLIT, bool DKV>
int launch(const ViewMap& m1, const ViewMap& m2, const ViewMap& m3, const ViewMap& m4,
           const WideArgs& a, int B, cudaStream_t stream) {
  using C = WideCfg<SPLIT, DKV>;
  const int own = DKV ? a.Skv : a.Sq;
  auto kern = DKV ? flash_bwd_dkv_wide_sm90_kernel<SPLIT> : flash_bwd_dq_wide_sm90_kernel<SPLIT>;
  SDK_SET_SMEM(kern, C::SMEM);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(SPLIT * ((own + R - 1) / R)), (unsigned)(B * a.H));
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, m1, m2, m3, m4, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Skv, int D) {
  return B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0 || D % 8 || D <= 128 || D > 512 ||
         B * H > 65535;
}

// a pair of blocks a slab above head dim 256 (padded 512), one block up to it
template <bool DKV>
int dispatch(int D, const ViewMap& m1, const ViewMap& m2, const ViewMap& m3, const ViewMap& m4,
             const WideArgs& a, int B, cudaStream_t s) {
  return D > 256 ? launch<2, DKV>(m1, m2, m3, m4, a, B, s)
                 : launch<1, DKV>(m1, m2, m3, m4, a, B, s);
}

}  // namespace

// dQ and delta at head dims 129-512 (multiples of 8). The arguments are
// sd_flash_bwd_dq's (flash_attention_bwd.cu): q, k, v, o, dO, dq are
// [B, S, H, D] bf16 views with unit stride along D, 16-byte aligned, strides
// multiples of 8 elements; `strides` holds (batch, row, head) for q, k, v, o,
// dO, dq in that order; lse2 (in) and delta (out) are [B*H, Sq] fp32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int sd_flash_bwd_dq_wide_sm90(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* dq, void* delta, int B, int H, int Sq, int Skv,
                                         int D, const long long* st, float scale_log2,
                                         float scale, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  ViewMap mq, mk, mv, mdo;
  const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k),
             *V = static_cast<const bf16*>(v), *DO = static_cast<const bf16*>(dout);
  int e = make_view_map(&mq, Q, B, Sq, H, D, st[0], st[1], st[2], R, true);
  if (!e) e = make_view_map(&mk, K, B, Skv, H, D, st[3], st[4], st[5], T, true);
  if (!e) e = make_view_map(&mv, V, B, Skv, H, D, st[6], st[7], st[8], T, true);
  if (!e) e = make_view_map(&mdo, DO, B, Sq, H, D, st[12], st[13], st[14], R, true);
  if (e) return e;
  WideArgs a{static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
             static_cast<const float*>(lse), nullptr, static_cast<float*>(delta),
             static_cast<bf16*>(dq), nullptr,
             {st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17], 0, 0, 0},
             H, Sq, Skv, D, 0, scale_log2, scale};
  return dispatch<false>(D, mq, mdo, mk, mv, a, B, static_cast<cudaStream_t>(stream));
}

// dK and dV at head dims 129-512. The arguments are sd_flash_bwd_dkv's: q,
// k, v, dO, dk, dv views; `strides`: (batch, row, head) for q, k, v, dO, dk,
// dv in that order; lse2 and delta (from sd_flash_bwd_dq_wide_sm90):
// [B*H, Sq] fp32. Returns the CUDA error code of the launch.
extern "C" int sd_flash_bwd_dkv_wide_sm90(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dk, void* dv, int B, int H, int Sq, int Skv,
                                          int D, const long long* st, float scale_log2,
                                          float scale, void* stream) {
  if (bad_shape(B, H, Sq, Skv, D)) return (int)cudaErrorInvalidValue;
  ViewMap mq, mk, mv, mdo;
  const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k),
             *V = static_cast<const bf16*>(v), *DO = static_cast<const bf16*>(dout);
  int e = make_view_map(&mq, Q, B, Sq, H, D, st[0], st[1], st[2], T, true);
  if (!e) e = make_view_map(&mk, K, B, Skv, H, D, st[3], st[4], st[5], R, true);
  if (!e) e = make_view_map(&mv, V, B, Skv, H, D, st[6], st[7], st[8], R, true);
  if (!e) e = make_view_map(&mdo, DO, B, Sq, H, D, st[9], st[10], st[11], T, true);
  if (e) return e;
  // a bulk copy needs 16-byte aligned rows of lse2 and delta
  const int bulk = Sq % 4 == 0 && ((reinterpret_cast<uintptr_t>(lse) |
                                    reinterpret_cast<uintptr_t>(delta)) & 15) == 0;
  WideArgs a{nullptr, nullptr, static_cast<const float*>(lse), static_cast<const float*>(delta),
             nullptr, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
             {0, 0, 0, 0, 0, 0, st[12], st[13], st[14], st[15], st[16], st[17]},
             H, Sq, Skv, D, bulk, scale_log2, scale};
  return dispatch<true>(D, mk, mv, mq, mdo, a, B, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory (bytes) of the launch at head dim D of the dK/dV
// kernel (dkv = 1) or the dQ kernel (the build report); -1 where none runs.
extern "C" int sd_flash_bwd_wide_sm90_smem(int D, int dkv) {
  if (bad_shape(1, 1, 1, 1, D)) return -1;
  if (D > 256) return (int)(dkv ? WideCfg<2, true>::SMEM : WideCfg<2, false>::SMEM);
  return (int)(dkv ? WideCfg<1, true>::SMEM : WideCfg<1, false>::SMEM);
}
