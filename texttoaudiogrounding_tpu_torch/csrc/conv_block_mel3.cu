// Row 4's mel3 and tri tap modes: the fused PANNs block (conv3x3 -> BN ->
// ReLU) x 2 -> avg+max pool with a conv run as a mel-im2col slab GEMM of
// K = 3 Cin, int8 or bf16.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/conv_block.py:370
// fused_double_conv_pool in its mel3 (:162 _mel3_build, :235 _conv3) and
// tri (:191 _tri_build1, :212 _tri_build2) modes.  The TPU kernel builds a
// [rows, 3 Cin] im2col of the three mel shifts dm in VMEM and runs three
// time-tap dots dt with K = 3 Cin.  Here an output tile is 128 contiguous
// (t, mel) rows of one group (whole times: M divides 64).  For each K step
// (dm, a KC slice of Cin) it stages one slab of (128 + 2M) rows of the
// im2col in shared memory, the tile's times and one time of halo each
// side, zero at mel 0 for dm = 0 and at mel M - 1 for dm = 2 (_mel3_build's
// masks), with the three weight slices (dt, dm); the three time taps are
// reads of the slab at row offsets dt * M.  The A staging of a tile falls
// from 9 Cin 128 elements (direct9, common.cuh conv3x3_gemm) to 3 Cin
// (128 + 2M).  The weight layout is direct9's, k = (dt * 3 + dm) Cin + ci,
// which is _prep_w's time-tap-major order.
//
// Quantization contract (int8):
//   mel3 conv1: x quantized with one scale per (clip, chunk j), max|x|
//     over the flat cells [(j tc - 2) M - 1, (j tc + tc + 2) M + 1) of the
//     clip (the staged window xc_ref, :287, :174-175), into a window copy;
//   tri conv1: x quantized with direct9's per-clip scale; the slab reads
//     the quantized clip itself, times outside the clip as zero;
//   conv2: y1 requantized per chunk over its conv1 rows (times
//     [j tc - 1, j tc + tc + 1), zero outside the clip), over bf16-stored
//     values after a mel3 conv1 with a mel3 conv2 (:340), else over f32
//     values (direct9's, :325-328);
//   weights int8 per output channel, their scales folded into the affine.
// A conv in neither mode runs as direct9.
//
// Bound on the H100: operations, as direct9's (the same 9 Cin Cout
// products an output row: blocks 3 / 4 7.1 / 14.2 GOP of int8 a 10 s
// clip).  This first version stages without pipelining (no cp.async, TMA
// or wgmma), computes a partial last tile in each group, and keeps y1's
// round trip through device memory: its scale is a max over the chunk.
#include "common.cuh"

namespace ttg {

constexpr int MMAX = 64;              // largest M: a tile holds >= 2 times
constexpr int SROWS = BM + 2 * MMAX;  // slab rows, at most

struct SlabArgs {
  const void* src;      // source rows [Gs, S_R, M, Cin]
  const void* wt;       // [Cout, 9 Cin], k = (dt * 3 + dm) * Cin + ci
  const float* alpha;   // [Cout] folded BN scale (x weight scale for int8)
  const float* beta;    // [Cout] folded BN shift
  const float* gscale;  // activation scale of group g at g / scale_div, or
  int scale_div;        //   null
  void* dst;
  int G, nch, tc, T;    // groups, groups per clip, chunk length, clip length
  int M, Cin, Cout;
  int R_out;            // output time rows of a group
  int tiles;            // BM-row tiles of a group
  int S_R;              // time rows of a source group
  int src_div;          // group g reads source group g / src_div, and its
  int src_step;         //   output row r at tap dt reads source time
  int src_off;          //   j * src_step + src_off + r + dt (zero outside
                        //   [0, S_R))
  int pt, pm;           // conv2's pool window
  int time_off;         // conv1: time of row r is j * tc + r + time_off
  int T_out;            // conv2: pooled time rows per clip in dst
};

// MODE 0: conv1 epilogue, f32 rows; 1: conv1 epilogue, bf16 rows;
// 2: conv2 epilogue, f32 avg+max pool (mel pairs, then time pairs).  The
// epilogues are conv3x3_gemm's, on rows in (t, mel) order.
template <typename T, int MODE>
__global__ void __launch_bounds__(NT) slab_gemm(SlabArgs a) {
  using AT = typename Mma<T>::acc_t;
  constexpr int KC = Mma<T>::KC;
  constexpr int SLAB = 16 * sizeof(T);   // bytes of 16 k-elements of a row
  constexpr int NKS = KC / 16;           // 16-wide k slices per step
  constexpr int PIECES = KC * sizeof(T) / 16;  // 16-byte pieces of a step
  constexpr int A_BYTES = NKS * SROWS * SLAB;
  constexpr int B_BYTES = 3 * NKS * BN * SLAB;
  constexpr int LDC = BN + 4;
  constexpr int C_BYTES = BM * LDC * 4;
  __shared__ __align__(128) unsigned char
      smem[C_BYTES > A_BYTES + B_BYTES ? C_BYTES : A_BYTES + B_BYTES];
  unsigned char* As = smem;              // [NKS][SROWS][16] slab slices
  unsigned char* Bs = smem + A_BYTES;    // [3 dt][NKS][BN][16] (B^T)
  AT* Cs = reinterpret_cast<AT*>(smem);  // [BM][LDC] after the K loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int M = a.M;
  const int g = blockIdx.x / a.tiles;
  const int j = g % a.nch;
  const int p0 = (blockIdx.x % a.tiles) * BM;  // tile's first row in g
  const int r0 = p0 / M;
  const int n0 = blockIdx.y * BN;
  const int rows = BM + 2 * M;
  const int s0 = j * a.src_step + a.src_off + r0;  // time of slab row 0
  const int Ktot = 9 * a.Cin;
  const T* src = static_cast<const T*>(a.src) +
                 (long long)(g / a.src_div) * a.S_R * M * a.Cin;
  const T* wt = static_cast<const T*>(a.wt);

  AccFrag<T> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) nvcuda::wmma::fill_fragment(acc[i][jj], (AT)0);

  for (int dm = 0; dm < 3; ++dm) {
    for (int c0 = 0; c0 < a.Cin; c0 += KC) {
      // the slab: im2col column block (dm, c0) of source times s0 ...
      for (int idx = tid; idx < rows * PIECES; idx += NT) {
        const int q = idx / PIECES, piece = idx % PIECES;
        const int st = s0 + q / M, mi = q % M + dm - 1;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (st >= 0 && st < a.S_R && mi >= 0 && mi < M)
          v = *reinterpret_cast<const uint4*>(
              reinterpret_cast<const unsigned char*>(
                  src + ((long long)st * M + mi) * a.Cin + c0) +
              piece * 16);
        const int ks = (piece * 16) / SLAB, part = (piece * 16) % SLAB;
        *reinterpret_cast<uint4*>(As + ks * SROWS * SLAB + q * SLAB + part) =
            v;
      }
      // ... and the weight slices of the three time taps
      for (int idx = tid; idx < 3 * BN * PIECES; idx += NT) {
        const int dt = idx / (BN * PIECES), rem = idx % (BN * PIECES);
        const int n = rem / PIECES, piece = rem % PIECES;
        const T* col =
            wt + (long long)(n0 + n) * Ktot + (dt * 3 + dm) * a.Cin + c0;
        const uint4 v = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const unsigned char*>(col) + piece * 16);
        const int ks = (piece * 16) / SLAB, part = (piece * 16) % SLAB;
        *reinterpret_cast<uint4*>(Bs + (dt * NKS + ks) * BN * SLAB +
                                  n * SLAB + part) = v;
      }
      __syncthreads();
#pragma unroll
      for (int dt = 0; dt < 3; ++dt)
        mma_step<T>(As + dt * M * SLAB, Bs + dt * NKS * BN * SLAB, acc, wm,
                    wn, SROWS);
      __syncthreads();
    }
  }

  store_acc<T>(Cs, acc, LDC, wm, wn);
  __syncthreads();

  const float gs = a.gscale ? a.gscale[g / a.scale_div] : 1.0f;
  if constexpr (MODE == 0 || MODE == 1) {
    using Td = typename std::conditional<MODE == 0, float, bf16>::type;
    Td* dst = static_cast<Td*>(a.dst) + (long long)g * a.R_out * M * a.Cout;
    for (int idx = tid; idx < BM * BN; idx += NT) {
      const int row = idx / BN, c = idx % BN;
      const int p = p0 + row;
      if (p >= a.R_out * M) continue;  // past the group (partial tile)
      const int t = j * a.tc + p / M + a.time_off;
      const int n = n0 + c;
      const float mul = a.gscale ? __fmul_rn(a.alpha[n], gs) : a.alpha[n];
      float y = __fadd_rn(__fmul_rn((float)Cs[row * LDC + c], mul), a.beta[n]);
      y = (t >= 0 && t < a.T) ? fmaxf(y, 0.0f) : 0.0f;
      store<Td>(dst + (long long)p * a.Cout + n, y);
    }
  } else {
    bf16* dst = static_cast<bf16*>(a.dst);
    const int Mo = M / a.pm, win = a.pt * a.pm;
    const int b = g / a.nch;
    for (int idx = tid; idx < (BM / win) * BN; idx += NT) {
      const int wi = idx / BN, c = idx % BN;
      const int ro = wi / Mo, mo = wi % Mo;  // pool window in the tile
      const int r = r0 + ro * a.pt;          // its first row's time in g
      if (r >= a.R_out) continue;
      const int tout = (j * a.tc + r) / a.pt;
      if (tout >= a.T_out) continue;  // past the clip (ragged last chunk)
      const int n = n0 + c;
      const float mul = a.gscale ? __fmul_rn(a.alpha[n], gs) : a.alpha[n];
      float v[2][2];
      for (int di = 0; di < a.pt; ++di)
        for (int dj = 0; dj < a.pm; ++dj) {
          const int row = (ro * a.pt + di) * M + mo * a.pm + dj;
          const float y = __fadd_rn(__fmul_rn((float)Cs[row * LDC + c], mul),
                                    a.beta[n]);
          v[di][dj] = fmaxf(y, 0.0f);
        }
      float s[2], mx[2];
      for (int di = 0; di < a.pt; ++di) {
        s[di] = a.pm == 2 ? __fadd_rn(v[di][0], v[di][1]) : v[di][0];
        mx[di] = a.pm == 2 ? fmaxf(v[di][0], v[di][1]) : v[di][0];
      }
      const float S = a.pt == 2 ? __fadd_rn(s[0], s[1]) : s[0];
      const float MX = a.pt == 2 ? fmaxf(mx[0], mx[1]) : mx[0];
      const float out = __fadd_rn(__fmul_rn(S, 1.0f / (float)win), MX);
      dst[(((long long)b * a.T_out + tout) * Mo + mo) * a.Cout + n] =
          __float2bfloat16_rn(out);
    }
  }
}

template <typename T, int MODE>
inline void launch_slab(SlabArgs a, cudaStream_t st) {
  a.tiles = (a.R_out * a.M + BM - 1) / BM;
  dim3 grid((unsigned)(a.G * a.tiles), (unsigned)(a.Cout / BN));
  slab_gemm<T, MODE><<<grid, NT, 0, st>>>(a);
}

}  // namespace ttg

// quant: int8; mel3_1 / tri_1: conv1 as the slab from the chunk-scaled
// window copy / from the clip; slab2: conv2 as the slab; y1_half: y1 stored
// in bf16 before its int8 scale (mel3 conv2 after mel3 conv1).  Buffers as
// common.cuh double_conv's; with tri_1 and quant, xs holds the per-clip
// quantized clip [B, T, M, Cin] and sx its B scales.
extern "C" int ttg_conv_block_mel3(int quant, int mel3_1, int tri_1,
                                   int slab2, int y1_half, const void* x,
                                   int B, int T, int M, int Cin, int Cout,
                                   int tc, int pt, int pm, const void* w1,
                                   const float* a1, const float* b1,
                                   const void* w2, const float* a2,
                                   const float* b2, void* xs, void* y1,
                                   void* y1q, float* sx, float* sy,
                                   void* out, void* stream) {
  using namespace ttg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const int nch = (T + tc - 1) / tc, G = B * nch;  // last chunk ragged
  const long long L = (long long)M * Cin;          // one time row
  const bool q = quant != 0, half = y1_half != 0;
  if (mel3_1 || tri_1) {
    SlabArgs c{};
    c.wt = w1;
    c.alpha = a1;
    c.beta = b1;
    c.gscale = q ? sx : nullptr;
    c.dst = y1;
    c.G = G;
    c.nch = nch;
    c.tc = tc;
    c.T = T;
    c.M = M;
    c.Cin = Cin;
    c.Cout = Cout;
    c.R_out = tc + 2;
    c.pt = 1;
    c.pm = 1;
    c.time_off = -1;
    if (mel3_1) {
      if (q)
        gather_kernel<bf16, int8_t, true><<<G, 512, 0, st>>>(
            xb, static_cast<int8_t*>(xs), sx, nch, T, M * Cin, tc, 2, tc + 4,
            tc * L, -(2LL * M + 1) * Cin, ((tc + 2LL) * M + 1) * Cin);
      else
        gather_kernel<bf16, bf16, false><<<G, 512, 0, st>>>(
            xb, static_cast<bf16*>(xs), nullptr, nch, T, M * Cin, tc, 2,
            tc + 4, 0, 0, 0);
      c.src = xs;
      c.S_R = tc + 4;
      c.src_div = 1;
      c.scale_div = 1;
    } else {
      c.src = x;
      if (q) {
        gather_kernel<bf16, int8_t, true><<<B, 512, 0, st>>>(
            xb, static_cast<int8_t*>(xs), sx, 1, T, M * Cin, T, 0, T, 0, 0,
            T * L);
        c.src = xs;
      }
      c.S_R = T;
      c.src_div = nch;
      c.src_step = tc;
      c.src_off = -2;
      c.scale_div = nch;
    }
    if (q && !half)
      launch_slab<int8_t, 0>(c, st);
    else if (q)
      launch_slab<int8_t, 1>(c, st);
    else
      launch_slab<bf16, 1>(c, st);
  } else {
    conv1_direct(q, half, xb, B, T, M, Cin, Cout, tc, 0, 0, T * L, w1, a1,
                 b1, xs, y1, sx, st);
  }
  if (!slab2)
    return (int)conv2_pool(q, half, y1, static_cast<int8_t*>(y1q), sy, B,
                           nch, T, M, Cout, tc, pt, pm, w2, a2, b2,
                           static_cast<bf16*>(out), st);
  if (q) requant_y1(half, y1, static_cast<int8_t*>(y1q), sy, G, tc, M, Cout,
                    st);
  SlabArgs c{};
  c.src = q ? y1q : y1;
  c.wt = w2;
  c.alpha = a2;
  c.beta = b2;
  c.gscale = q ? sy : nullptr;
  c.scale_div = 1;
  c.dst = out;
  c.G = G;
  c.nch = nch;
  c.tc = tc;
  c.T = T;
  c.M = M;
  c.Cin = Cout;
  c.Cout = Cout;
  c.R_out = tc;
  c.S_R = tc + 2;
  c.src_div = 1;
  c.pt = pt;
  c.pm = pm;
  c.T_out = T / pt;
  if (q)
    launch_slab<int8_t, 2>(c, st);
  else
    launch_slab<bf16, 2>(c, st);
  return (int)cudaGetLastError();
}
