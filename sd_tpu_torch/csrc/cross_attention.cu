// Fused small-KV cross-attention for Hopper: out = (softmax(q k^T) v) Wo^T + bo
// per head, with q = x Wq^T, over a context of at most 256 pre-projected
// tokens; bf16 in and out, fp32 accumulation and softmax.
//
// Replaces the TPU kernel `_kernel` (sd_tpu/kernels/cross_attention.py:41,
// behind `crossattn_kv`). Same contract and the same rounding points: q = x Wq^T
// accumulates in fp32, is multiplied by scale * log2(e) and rounded to bf16;
// the logits are base 2 (exp2), the context padded to a multiple of 16 tokens
// with the padded columns masked; p is rounded to bf16 before p v; (p v) / l,
// l the fp32 sum of the unrounded p, is rounded to bf16 before the output
// projection; bo is added in fp32 before the one rounding of the output.
//
// What bounds it on the H100: the two projections (2 * N * C * HD flops each)
// and the attention (4 * N * 77 * HD) against the bytes of x, out and the
// weights: at the UNet shapes (N = 4096 / 1024 / 256 tokens per image, C = HD =
// 320 / 640 / 1280) several hundred flops per byte, so it is bound by
// operations on the tensor cores. The TPU kernel kept Wq and Wo whole in VMEM
// (6.5 MB at C = 1280); 227 KB of shared memory cannot.
// What the design does about it: a block owns BQ = 64 query rows (32 when the
// rows of C or HD pass 640) and keeps two tiles resident: x [BQ, C] while q is
// formed, and one [BQ, HD] bf16 tile that holds q and, head by head, is
// overwritten in place by that head's output (a head's columns are read by
// its own logits only). Weight chunks of 64 x 64 stream through shared memory
// from L2, once per block; every product is mma.sync m16n8k16 with fp32
// accumulation. Per head, K_h and V_h^T of the whole context sit in shared
// memory (the head dim zero-padded to a multiple of 16 there only: d = 40 ->
// 48), the logits [BQ, 80] go through shared memory for an exact softmax, and
// nothing but x, the weights, K, V and out touch device memory. No cp.async
// or TMA pipelining of the weight chunks, no wgmma yet (later work).
//
// Weights are in torch Linear layout: Wq [HD, C] and Wo [C, HD], so every
// weight chunk is k-contiguous, which is what the B operand wants.
#include "common.cuh"

namespace {

using sdk::bf16;

constexpr int THREADS = 256;
constexpr int NC = 64;         // output columns per GEMM chunk
constexpr int KC = 64;         // contraction per GEMM chunk
constexpr int WS = KC + 8;     // row stride of a weight chunk
constexpr int MAX_M = 256;     // context tokens
constexpr size_t MAX_SMEM = 232448;
constexpr float NEG = -1e30f;

__host__ __device__ constexpr int rup(int a, int m) { return (a + m - 1) / m * m; }
__host__ __device__ constexpr size_t a16(size_t b) { return (b + 15) / 16 * 16; }
__host__ __device__ constexpr size_t smax(size_t a, size_t b) { return a > b ? a : b; }

// Padded extents, row strides (elements) and byte offsets of the shared
// memory of one block; computed alike on the host (its size) and the device.
struct Layout {
  int Cr, HDr, MP, DP;   // C, HD to 64; context, head dim to 16
  int XS, QS, KS, VS, SS, PS;
  size_t u_off;          // the union: phase A | phase B | phase C
  size_t w_a;            // phase A: x tile at u_off, then a weight chunk
  size_t k_off, v_off, s_off, p_off, l_off;   // phase B
  size_t bytes;
  __host__ __device__ Layout(int BQ, int C, int HD, int M, int D) {
    Cr = rup(C, KC);
    HDr = rup(HD, NC);
    MP = rup(M, 16);
    DP = rup(D, 16);
    XS = Cr + 8;
    QS = HDr + 8;
    KS = DP + 8;
    VS = MP + 8;
    SS = MP + 4;
    PS = MP + 8;
    u_off = a16((size_t)BQ * QS * 2);
    w_a = u_off + a16((size_t)BQ * XS * 2);
    const size_t a_end = w_a + (size_t)NC * WS * 2;
    k_off = u_off;
    v_off = k_off + a16((size_t)MP * KS * 2);
    s_off = v_off + a16((size_t)DP * VS * 2);
    p_off = s_off + a16((size_t)BQ * SS * 4);
    l_off = p_off + a16((size_t)BQ * PS * 2);
    const size_t b_end = l_off + (size_t)BQ * 4;
    const size_t c_end = u_off + (size_t)NC * WS * 2;
    bytes = smax(smax(a_end, b_end), c_end);
  }
};

// rows [r0, r0+NC) x columns [c0, c0+KC) of a row-major bf16 matrix
// [nrows, rowlen] into Wc (row stride WS); outside the matrix -> zeros.
__device__ __forceinline__ void load_chunk(bf16* Wc, const bf16* w, int r0, int c0,
                                           int nrows, int rowlen) {
  for (int idx = threadIdx.x; idx < NC * (KC / 8); idx += THREADS) {
    const int r = idx / (KC / 8), c = (idx - r * (KC / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows && c0 + c < rowlen)
      val = *reinterpret_cast<const uint4*>(w + (long long)(r0 + r) * rowlen + c0 + c);
    *reinterpret_cast<uint4*>(Wc + r * WS + c) = val;
  }
}

template <int BQ>
__global__ void __launch_bounds__(THREADS)
crossattn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq,
                 const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                 bf16* __restrict__ out, int N, int C, int M, int H, int D,
                 float qscale) {
  constexpr int RG = BQ / 16;         // 16-row groups of warps
  constexpr int WC = 8 / RG;          // column groups of warps
  constexpr int GT = NC / 8 / WC;     // n8 tiles per warp in a GEMM chunk
  constexpr int TPR = THREADS / BQ;   // softmax threads per row
  const int HD = H * D;
  const Layout L(BQ, C, HD, M, D);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qa = reinterpret_cast<bf16*>(smem);                 // [BQ][QS]
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.u_off);       // [BQ][XS]
  bf16* Wa = reinterpret_cast<bf16*>(smem + L.w_a);         // [NC][WS]
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k_off);       // [MP][KS]
  bf16* Vt = reinterpret_cast<bf16*>(smem + L.v_off);       // [DP][VS]
  float* Ss = reinterpret_cast<float*>(smem + L.s_off);     // [BQ][SS]
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.p_off);       // [BQ][PS]
  float* l_s = reinterpret_cast<float*>(smem + L.l_off);    // [BQ]
  bf16* Wc = reinterpret_cast<bf16*>(smem + L.u_off);       // [NC][WS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp / WC, wc = warp % WC;
  const int b = blockIdx.y, n0 = blockIdx.x * BQ;
  const bf16* xb = x + (long long)b * N * C;
  const bf16* kb = k + (long long)b * M * HD;
  const bf16* vb = v + (long long)b * M * HD;
  bf16* ob = out + (long long)b * N * C;

  // ---- the x tile (rows past N, columns past C as zeros); Qa's last 8
  //      columns zeroed: the last head's padded reads reach them
  for (int idx = tid; idx < BQ * (L.Cr / 8); idx += THREADS) {
    const int r = idx / (L.Cr / 8), c = (idx - r * (L.Cr / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < N && c < C)
      val = *reinterpret_cast<const uint4*>(xb + (long long)(n0 + r) * C + c);
    *reinterpret_cast<uint4*>(Xs + r * L.XS + c) = val;
  }
  for (int r = tid; r < BQ; r += THREADS)
    *reinterpret_cast<uint4*>(Qa + r * L.QS + L.HDr) = make_uint4(0u, 0u, 0u, 0u);

  // ---- phase A: Qa = bf16((x Wq^T) * scale * log2 e) -----------------------
  for (int j0 = 0; j0 < L.HDr; j0 += NC) {
    float acc[GT][4];
#pragma unroll
    for (int i = 0; i < GT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int c0 = 0; c0 < L.Cr; c0 += KC) {
      __syncthreads();
      load_chunk(Wa, wq, j0, c0, HD, C);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[4];
        sdk::load_a(a, Xs, L.XS, rg * 16, c0 + kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < GT; ++nt) {
          const bf16* p = Wa + ((wc * GT + nt) * 8 + g) * WS + kk * 16 + 2 * t;
          sdk::mma_16816(acc[nt], a, sdk::ld32(p), sdk::ld32(p + 8));
        }
      }
    }
    const int row = rg * 16 + g;
#pragma unroll
    for (int nt = 0; nt < GT; ++nt) {
      const int col = j0 + (wc * GT + nt) * 8 + 2 * t;
      sdk::st32(Qa + row * L.QS + col, acc[nt][0] * qscale, acc[nt][1] * qscale);
      sdk::st32(Qa + (row + 8) * L.QS + col, acc[nt][2] * qscale, acc[nt][3] * qscale);
    }
  }
  __syncthreads();

  // ---- phase B: per head, bf16((bf16(p) V_h) / l) into the head's columns --
  for (int h = 0; h < H; ++h) {
    for (int idx = tid; idx < L.MP * (L.DP / 8); idx += THREADS) {
      const int r = idx / (L.DP / 8), c = (idx - r * (L.DP / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (r < M && c < D) {
        const long long off = (long long)r * HD + h * D + c;
        kv = *reinterpret_cast<const uint4*>(kb + off);
        vv = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * L.KS + c) = kv;
      const bf16* e = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int u = 0; u < 8; ++u) Vt[(c + u) * L.VS + r] = e[u];
    }
    __syncthreads();

    // logits S = Q_h K_h^T (base 2: the scale is in q)
    const bf16* Qh = Qa + h * D;
    for (int nt = wc; nt < L.MP / 8; nt += WC) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < L.DP / 16; ++kk) {
        uint32_t a[4];
        sdk::load_a(a, Qh, L.QS, rg * 16, kk * 16, g, t);
        const bf16* p = Ks + (nt * 8 + g) * L.KS + kk * 16 + 2 * t;
        sdk::mma_16816(s, a, sdk::ld32(p), sdk::ld32(p + 8));
      }
      const int row = rg * 16 + g, col = nt * 8 + 2 * t;
      Ss[row * L.SS + col] = s[0];
      Ss[row * L.SS + col + 1] = s[1];
      Ss[(row + 8) * L.SS + col] = s[2];
      Ss[(row + 8) * L.SS + col + 1] = s[3];
    }
    __syncthreads();

    // exact softmax over the context, TPR neighbouring lanes per row
    {
      const int row = tid / TPR, sub = tid % TPR;
      float mx = NEG;
      for (int c = sub; c < M; c += TPR) mx = fmaxf(mx, Ss[row * L.SS + c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int c = sub; c < L.MP; c += TPR) {
        const float p = c < M ? exp2f(Ss[row * L.SS + c] - mx) : 0.f;
        sum += p;
        Ps[row * L.PS + c] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (sub == 0) l_s[row] = sum;
    }
    __syncthreads();

    // O_h = P V_h / l over the head's own columns (never the next head's q)
    {
      const int row = rg * 16 + g;
      const float inv_lo = 1.f / l_s[row], inv_hi = 1.f / l_s[row + 8];
      for (int nt = wc; nt < L.DP / 8; nt += WC) {
        float o[4] = {0.f, 0.f, 0.f, 0.f};
        for (int kk = 0; kk < L.MP / 16; ++kk) {
          uint32_t a[4];
          sdk::load_a(a, Ps, L.PS, rg * 16, kk * 16, g, t);
          const bf16* p = Vt + (nt * 8 + g) * L.VS + kk * 16 + 2 * t;
          sdk::mma_16816(o, a, sdk::ld32(p), sdk::ld32(p + 8));
        }
        const int col = nt * 8 + 2 * t;
        if (col < D) {
          sdk::st32(Qa + row * L.QS + h * D + col, o[0] * inv_lo, o[1] * inv_lo);
          sdk::st32(Qa + (row + 8) * L.QS + h * D + col, o[2] * inv_hi, o[3] * inv_hi);
        }
      }
    }
    __syncthreads();
  }

  // ---- phase C: out = bf16(O Wo^T + bo) ------------------------------------
  for (int o0 = 0; o0 < L.Cr; o0 += NC) {
    float acc[GT][4];
#pragma unroll
    for (int i = 0; i < GT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int j0 = 0; j0 < L.HDr; j0 += KC) {
      __syncthreads();
      load_chunk(Wc, wo, o0, j0, C, HD);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[4];
        sdk::load_a(a, Qa, L.QS, rg * 16, j0 + kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < GT; ++nt) {
          const bf16* p = Wc + ((wc * GT + nt) * 8 + g) * WS + kk * 16 + 2 * t;
          sdk::mma_16816(acc[nt], a, sdk::ld32(p), sdk::ld32(p + 8));
        }
      }
    }
    const int r_lo = n0 + rg * 16 + g, r_hi = r_lo + 8;
#pragma unroll
    for (int nt = 0; nt < GT; ++nt) {
      const int col = o0 + (wc * GT + nt) * 8 + 2 * t;
      if (col >= C) continue;
      const float b0 = __bfloat162float(bo[col]), b1 = __bfloat162float(bo[col + 1]);
      if (r_lo < N) sdk::st32(ob + (long long)r_lo * C + col, acc[nt][0] + b0, acc[nt][1] + b1);
      if (r_hi < N) sdk::st32(ob + (long long)r_hi * C + col, acc[nt][2] + b0, acc[nt][3] + b1);
    }
  }
}

template <int BQ>
int launch(const bf16* x, const bf16* wq, const bf16* k, const bf16* v,
           const bf16* wo, const bf16* bo, bf16* out, int B, int N, int C, int M,
           int H, int D, float qscale, cudaStream_t s) {
  const Layout L(BQ, C, H * D, M, D);
  auto kern = crossattn_kernel<BQ>;
  SDK_SET_SMEM(kern, L.bytes);
  dim3 grid((N + BQ - 1) / BQ, B);
  kern<<<grid, THREADS, L.bytes, s>>>(x, wq, k, v, wo, bo, out, N, C, M, H, D, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out [B, N, C]; wq [H*D, C]; k, v [B, M, H*D]; wo [C, H*D]; bo [C]: all
// contiguous bf16, 16-byte aligned. Needs C % 8 == 0, D % 8 == 0 and
// 1 <= M <= 256. qscale = scale * log2(e). Returns the CUDA error code of the
// launch (0 on success).
extern "C" int sd_crossattn_fwd(const void* x, const void* wq, const void* k,
                                const void* v, const void* wo, const void* bo,
                                void* out, int B, int N, int C, int M, int H,
                                int D, float qscale, void* stream) {
  if (C % 8 != 0 || D % 8 != 0 || D < 8 || H < 1 || M < 1 || M > MAX_M)
    return (int)cudaErrorInvalidValue;
  const bf16* X = static_cast<const bf16*>(x);
  const bf16* WQ = static_cast<const bf16*>(wq);
  const bf16* K = static_cast<const bf16*>(k);
  const bf16* V = static_cast<const bf16*>(v);
  const bf16* WO = static_cast<const bf16*>(wo);
  const bf16* BO = static_cast<const bf16*>(bo);
  bf16* O = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Layout(64, C, H * D, M, D).bytes <= MAX_SMEM)
    return launch<64>(X, WQ, K, V, WO, BO, O, B, N, C, M, H, D, qscale, s);
  if (Layout(32, C, H * D, M, D).bytes <= MAX_SMEM)
    return launch<32>(X, WQ, K, V, WO, BO, O, B, N, C, M, H, D, qscale, s);
  return (int)cudaErrorInvalidValue;
}
