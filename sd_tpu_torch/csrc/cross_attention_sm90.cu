// Small-KV cross-attention for Hopper: out = (softmax(q k^T) v) Wo^T + bo per
// head, with q = x Wq^T, over a context of at most 256 pre-projected tokens;
// bf16 in and out, fp32 accumulation and softmax (`cross_attention.cu`'s
// function), in three launches.
//
// Replaces the TPU kernel `_kernel` (sd_tpu/kernels/cross_attention.py:41,
// behind `crossattn_kv`). Same rounding points: q = x Wq^T accumulates in
// fp32, is multiplied by scale * log2(e) and rounded to bf16; the logits are
// base 2 (exp2), the context padded and the padded columns masked; p is
// rounded to bf16 before p v; O = (p v) / l, l the fp32 sum of the unrounded
// p, is rounded to bf16 before the output projection (the TPU kernel's
// `acc_ref` is x's dtype); bo is added in fp32 before the one rounding of the
// output. The `mma.sync` form in `cross_attention.cu` stays as the yardstick.
//
// What bounds it on the H100: the two projections (2 * B * N * C * HD flops
// each) and the attention (4 * B * N * 77 * HD) against the bytes of x, out,
// the weights and K/V: 0.007-0.008 ms of tensor work at each UNet level (B =
// 4; N = 4096 / 1024 / 256; C = HD = 320 / 640 / 1280). The TPU kernel kept
// Wq and Wo whole in VMEM (6.5 MB at C = 1280); a block of 227 KB cannot, and
// `cross_attention.cu`, which streams both per 32- or 64-row block by
// synchronous loads into `mma.sync`, ran 32 blocks for 132 SMs at
// [4, 256, 77, 8 x 160].
// What the design does about it: the products are three launches, each of
// which fills the card on its own, on the TPU kernel's rounding points:
//   * q = bf16((x Wq^T) * scale * log2 e) and out = bf16(O Wo^T + bo) are one
//     GEMM kernel: a block of two consumer warpgroups owns 128 rows x 128
//     columns; a producer warp keeps a 3-stage ring of 64-column K chunks of
//     both operands in flight, one TMA box of 64 columns per operand and
//     stage in the 128-byte swizzle (rows and columns past the matrices as
//     zeros; boxes of 8 columns, the no-swizzle layout of the other Hopper
//     kernels, take one 16-byte request per row, and those requests set the
//     pace), and
//     each warpgroup runs m64n128k16 chains with one step's products in
//     flight while it frees the stage before (wgmma.wait_group 1);
//   * the attention takes a block per (64 or 128 query rows, head): q_h, K_h
//     and V_h (the whole context, 77 -> 80 rows, or 256) arrive by TMA at
//     once; S = q_h K_h^T is one wgmma chain (N = 80 or 256), the exact
//     softmax runs in registers (each row in 4 lanes), P goes in as the bf16
//     register A operand of P V_h with V read MN-major (no transposed copy),
//     and O = P V_h / l is written over q_h in the same buffer (a block reads
//     its q tile whole before it writes, and no other block touches it). Rows
//     per block: 128 where that grid fills a wave, else 64 (`xattn_plan` in
//     kernels/cross_attention.py), so [4, 256, 77, 8 x 160] runs 128 blocks.
// Weights are in torch Linear layout: Wq [H * D, C] and Wo [C, H * D].
#include "sm90.cuh"

namespace {

constexpr int GM = 128;                // rows of a GEMM block: two warpgroups of 64
constexpr int BN = 128;                // columns of a GEMM block
constexpr int GK = 64;                 // contraction of a ring stage
constexpr int ST = 3;                  // GEMM ring stages
constexpr int CONSUMER_WARPS = 8;
constexpr int GEMM_THREADS = CONSUMER_WARPS * 32 + 32;   // + the producer warp
constexpr int MAX_M = 256;             // context tokens
constexpr size_t MAX_SMEM = 232448;
constexpr float NEG = -1e30f;

constexpr int A_BYTES = GM * GK * 2;
constexpr int STAGE = A_BYTES + BN * GK * 2;
// + the slack to align the stages to 1024 bytes (the swizzle's atoms)
constexpr size_t GEMM_SMEM = (size_t)ST * STAGE + 2 * ST * 8 + 1024;

// out [R, NO] = bf16((A [R, K] W [NO, K]^T + bias) * scale), bias optional
__global__ void __launch_bounds__(GEMM_THREADS, 2)
xattn_gemm_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mw,
                  const bf16* __restrict__ bias, bf16* __restrict__ out, int R, int K, int NO,
                  float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * STAGE);
  uint64_t* empty = full + ST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * GM, c0 = blockIdx.y * BN;
  const int n_k = (K + GK - 1) / GK;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // ---- the producer: K chunk kc of both operands into stage kc % ST
    if (lane == 0) {
      for (int kc = 0; kc < n_k; ++kc) {
        const int s = kc % ST;
        if (kc >= ST) mbar_wait(empty + s, (kc / ST - 1) & 1);
        unsigned char* as = smem + (size_t)s * STAGE;
        mbar_expect_tx(full + s, (uint32_t)STAGE);
        tma_load_2d(as, &ma, kc * GK, r0, full + s);
        tma_load_2d(as + A_BYTES, &mw, kc * GK, c0, full + s);
      }
    }
    return;
  }

  // ---- the consumers: warpgroup wg, rows [64 wg, 64 wg + 64) of the block
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  float acc[BN / 2];
  int prev = -1;
  for (int kc = 0; kc < n_k; ++kc) {
    const int s = kc % ST;
    mbar_wait(full + s, (kc / ST) & 1);
    const unsigned char* as = smem + (size_t)s * STAGE;
    wg_fence();
#pragma unroll
    for (int k = 0; k < GK / 16; ++k)
      Wgmma<BN>::ss(acc, gmma_desc_sw128(as + 64 * wg * 128 + 32 * k),
                    gmma_desc_sw128(as + A_BYTES + 32 * k), kc > 0 || k > 0);
    wg_commit();
    wg_wait_one();
    if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
    prev = s;
  }
  wg_wait_all();

  const int r_lo = r0 + 64 * wg + 16 * wl + g, r_hi = r_lo + 8;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = c0 + 8 * i + 2 * t;
    if (col >= NO) continue;   // NO % 8 == 0: both columns or neither
    const float bb0 = bias ? __bfloat162float(bias[col]) : 0.f;
    const float bb1 = bias ? __bfloat162float(bias[col + 1]) : 0.f;
    if (r_lo < R)
      sdk::st32(out + (long long)r_lo * NO + col, (acc[4 * i] + bb0) * scale,
                (acc[4 * i + 1] + bb1) * scale);
    if (r_hi < R)
      sdk::st32(out + (long long)r_hi * NO + col, (acc[4 * i + 2] + bb0) * scale,
                (acc[4 * i + 3] + bb1) * scale);
  }
}

// O [rows, n0 .. n0 + NC) of one head = P V_h / l: P as register A operands,
// V_h MN-major from shared memory; columns past D are not stored
template <int NC, int MP>
__device__ __forceinline__ void pv_chunk(const uint32_t (&a)[MP / 16][4], const bf16* vs, int n0,
                                         bf16* ob, long long ld, int r_lo, int N, int D,
                                         float inv_lo, float inv_hi, int t) {
  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < MP / 16; ++kk)
    Wgmma<NC>::rs(acc, a[kk], gmma_desc(vs + cm_off<MP>(16 * kk, n0), 128, MP * 16));
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int i = 0; i < NC / 8; ++i) {
    const int col = n0 + 8 * i + 2 * t;
    if (col >= D) continue;
    if (r_lo < N) sdk::st32(ob + r_lo * ld + col, acc[4 * i] * inv_lo, acc[4 * i + 1] * inv_lo);
    if (r_lo + 8 < N)
      sdk::st32(ob + (r_lo + 8) * ld + col, acc[4 * i + 2] * inv_hi, acc[4 * i + 3] * inv_hi);
  }
}

// Shared memory of an attention block: q [R][DP], K and V [MP][DP] in the
// core-matrix layout, one mbarrier
__host__ __device__ constexpr size_t attend_smem(int R, int MP, int DP) {
  return (size_t)(R + 2 * MP) * DP * 2 + 8;
}

// The attention over one head of 64 * NWG query rows: o (the same buffer
// as q) [B, N, H * D] gets bf16(softmax(q K^T) V) with q already scaled to
// base-2 logits; K, V [B, M, H * D]; DP = D padded to a multiple of 16
template <int MP, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
xattn_attend_kernel(const __grid_constant__ ViewMap mq, const __grid_constant__ ViewMap mk,
                    const __grid_constant__ ViewMap mv, bf16* __restrict__ o, int N, int M,
                    int H, int D, int DP) {
  constexpr int R = 64 * NWG;
  constexpr int NT = NWG * 128;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + R * DP;
  bf16* vs = ks + MP * DP;
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + MP * DP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * R;

  // the pad chunk (D % 16 == 8) of q and K enters the logits: zeros, written
  // once; V's pad columns are never stored
  if (DP != D) {
    for (int r = tid; r < R; r += NT)
      *reinterpret_cast<uint4*>(qs + cm_off<R>(r, D)) = make_uint4(0u, 0u, 0u, 0u);
    for (int r = tid; r < MP; r += NT) {
      *reinterpret_cast<uint4*>(ks + cm_off<MP>(r, D)) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(vs + cm_off<MP>(r, D)) = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_async_smem();
  }
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (uint32_t)((R + 2 * MP) * D * 2));
    load_rows_tma(mq, qs, R, q0, b, h, D / 8, 0, 1, bar);
    load_rows_tma(mk, ks, MP, 0, b, h, D / 8, 0, 1, bar);
    load_rows_tma(mv, vs, MP, 0, b, h, D / 8, 0, 1, bar);
  }
  mbar_wait(bar, 0);

  // S = q K^T over this warpgroup's 64 rows, in base-2 units
  float s[MP / 2];
  wg_fence();
  for (int kk = 0; kk < DP / 16; ++kk)
    Wgmma<MP>::ss(s, gmma_desc(qs + cm_off<R>(64 * wg, 16 * kk), R * 16, 128),
                  gmma_desc(ks + cm_off<MP>(0, 16 * kk), MP * 16, 128), kk > 0);
  wg_commit();
  wg_wait_all();

  // exact softmax: columns past M masked, rows g (s[4i], s[4i + 1]) and g + 8
  // (s[4i + 2], s[4i + 3]) of the warp's 16, each row in the quad's 4 lanes
  float m_lo = NEG, m_hi = NEG;
#pragma unroll
  for (int i = 0; i < MP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (8 * i + 2 * t + e >= M) {
        s[4 * i + e] = NEG;
        s[4 * i + 2 + e] = NEG;
      }
      m_lo = fmaxf(m_lo, s[4 * i + e]);
      m_hi = fmaxf(m_hi, s[4 * i + 2 + e]);
    }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
  }
  float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
  for (int i = 0; i < MP / 8; ++i) {
    s[4 * i] = exp2f(s[4 * i] - m_lo);
    s[4 * i + 1] = exp2f(s[4 * i + 1] - m_lo);
    s[4 * i + 2] = exp2f(s[4 * i + 2] - m_hi);
    s[4 * i + 3] = exp2f(s[4 * i + 3] - m_hi);
    l_lo += s[4 * i] + s[4 * i + 1];
    l_hi += s[4 * i + 2] + s[4 * i + 3];
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  // P rounded to bf16: two neighbouring n8 groups are one k16 A fragment
  uint32_t a[MP / 16][4];
#pragma unroll
  for (int kk = 0; kk < MP / 16; ++kk) {
    a[kk][0] = sdk::pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = sdk::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = sdk::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = sdk::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }

  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const long long ld = (long long)H * D;
  bf16* ob = o + (long long)b * N * ld + h * D;
  const int r_lo = q0 + 64 * wg + 16 * wl + g;
  for (int n0 = 0; n0 < DP; n0 += 128) {
    switch (DP - n0 < 128 ? DP - n0 : 128) {
      case 16: pv_chunk<16, MP>(a, vs, n0, ob, ld, r_lo, N, D, inv_lo, inv_hi, t); break;
      case 32: pv_chunk<32, MP>(a, vs, n0, ob, ld, r_lo, N, D, inv_lo, inv_hi, t); break;
      case 48: pv_chunk<48, MP>(a, vs, n0, ob, ld, r_lo, N, D, inv_lo, inv_hi, t); break;
      case 64: pv_chunk<64, MP>(a, vs, n0, ob, ld, r_lo, N, D, inv_lo, inv_hi, t); break;
      case 80: pv_chunk<80, MP>(a, vs, n0, ob, ld, r_lo, N, D, inv_lo, inv_hi, t); break;
      case 96: pv_chunk<96, MP>(a, vs, n0, ob, ld, r_lo, N, D, inv_lo, inv_hi, t); break;
      case 112: pv_chunk<112, MP>(a, vs, n0, ob, ld, r_lo, N, D, inv_lo, inv_hi, t); break;
      default: pv_chunk<128, MP>(a, vs, n0, ob, ld, r_lo, N, D, inv_lo, inv_hi, t); break;
    }
  }
}

int launch_gemm(const bf16* a, const bf16* w, const bf16* bias, bf16* out, int R, int K, int NO,
                float scale, cudaStream_t s) {
  CUtensorMap ma, mw;
  if (const int e = make_matrix_map(&ma, a, R, K, GM, true)) return e;
  if (const int e = make_matrix_map(&mw, w, NO, K, BN, true)) return e;
  const dim3 grid((unsigned)((R + GM - 1) / GM), (unsigned)((NO + BN - 1) / BN));
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  SDK_SET_SMEM(xattn_gemm_kernel, GEMM_SMEM);
  xattn_gemm_kernel<<<grid, GEMM_THREADS, GEMM_SMEM, s>>>(ma, mw, bias, out, R, K, NO, scale);
  return (int)cudaGetLastError();
}

template <int MP, int NWG>
int launch_attend(bf16* qo, const bf16* k, const bf16* v, int B, int N, int M, int H, int D,
                  cudaStream_t s) {
  constexpr int R = 64 * NWG;
  const int DP = (D + 15) / 16 * 16, HD = H * D;
  const size_t bytes = attend_smem(R, MP, DP);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  ViewMap mq, mk, mv;
  if (const int e = make_view_map(&mq, qo, B, N, H, D, (long long)N * HD, HD, D, R)) return e;
  if (const int e = make_view_map(&mk, k, B, M, H, D, (long long)M * HD, HD, D, MP)) return e;
  if (const int e = make_view_map(&mv, v, B, M, H, D, (long long)M * HD, HD, D, MP)) return e;
  const dim3 grid((unsigned)((N + R - 1) / R), (unsigned)H, (unsigned)B);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  auto kern = xattn_attend_kernel<MP, NWG>;
  SDK_SET_SMEM(kern, bytes);
  kern<<<grid, NWG * 128, bytes, s>>>(mq, mk, mv, qo, N, M, H, D, DP);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out [B, N, C]; wq [H*D, C]; k, v [B, M, H*D]; wo [C, H*D]; bo [C]: all
// contiguous bf16, 16-byte aligned; qo is scratch of B * N * H * D bf16 (q,
// then O over it). Needs C % 8 == 0, D % 8 == 0, 1 <= M <= 256 and `rows` (query
// rows of an attention block) 64 or 128; the attention block's q, K and V
// must fit in shared memory (`sd_crossattn_sm90_smem`). qscale = scale *
// log2(e). Returns the CUDA error code of the launches (0 on success).
extern "C" int sd_crossattn_fwd_sm90(const void* x, const void* wq, const void* k, const void* v,
                                     const void* wo, const void* bo, void* out, void* qo, int B,
                                     int N, int C, int M, int H, int D, float qscale, int rows,
                                     void* stream) {
  if (B < 1 || N < 1 || C < 8 || C % 8 != 0 || D < 8 || D % 8 != 0 || H < 1 || M < 1 ||
      M > MAX_M || (rows != 64 && rows != 128))
    return (int)cudaErrorInvalidValue;
  const bf16* X = static_cast<const bf16*>(x);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  bf16* QO = static_cast<bf16*>(qo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HD = H * D, R = B * N;
  int e = launch_gemm(X, static_cast<const bf16*>(wq), nullptr, QO, R, C, HD, qscale, s);
  if (e) return e;
  if (M <= 80)
    e = rows == 128 ? launch_attend<80, 2>(QO, K, V, B, N, M, H, D, s)
                    : launch_attend<80, 1>(QO, K, V, B, N, M, H, D, s);
  else
    e = rows == 128 ? launch_attend<256, 2>(QO, K, V, B, N, M, H, D, s)
                    : launch_attend<256, 1>(QO, K, V, B, N, M, H, D, s);
  if (e) return e;
  return launch_gemm(QO, static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
                     static_cast<bf16*>(out), R, HD, C, 1.f, s);
}

// Dynamic shared memory (bytes) of an attention block of `rows` query rows
// at context M and head dim D (the padded context: 80 up to M = 80, else 256).
extern "C" int sd_crossattn_sm90_smem(int rows, int M, int D) {
  return (int)attend_smem(rows, M <= 80 ? 80 : MAX_M, (D + 15) / 16 * 16);
}

// Dynamic shared memory (bytes) of a projection block.
extern "C" int sd_crossattn_gemm_sm90_smem() { return (int)GEMM_SMEM; }
