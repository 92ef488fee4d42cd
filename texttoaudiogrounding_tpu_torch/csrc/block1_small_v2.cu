// Row 7 of the port, second design (sm_90a): PANNs block 1 (1 -> 64 -> 64,
// 2 x 2 avg+max pool) from the bf16 log-mel itself, conv1 on the CUDA
// cores and conv2 on conv_igemm_sm90.cuh's wgmma implicit GEMM.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/conv_block_small.py:471
// fused_block1 (kernel _block1_kernel :420, im2col :401 conv1_im2col).
// The contract carried over, the first design's (block1_small.cu):
//   * conv1 (:435-441): bf16 log-mel and bf16 w1, each product exact in
//     f32, the nine summed in tap order dt * 3 + dm (__fmul_rn, __fadd_rn:
//     nothing contracted into an FMA), then the BN affine (multiply, then
//     add) and the ReLU; rows outside the clip are zero;
//   * int8 (:446-447): one y1 scale a chunk of tc output frames, max(y1) /
//     127 floored at 1e-6 / 127, over the chunk's f32 rows at times
//     [j tc - 1, j tc + tc + 1), not rounded to bf16 first; w2 int8 per
//     output channel divided by its scales (:78 _quant_rows), the scales
//     in conv2's affine; int32 sums;
//   * conv2's epilogue (:460-467): the affine, the ReLU, an f32 avg+max
//     pool over mel pairs then time pairs (sum / 4 + max); bf16 out.
// Its int8 output is the first design's and the plain version's
// (ops/kernels/block1_small.py block1_small_plain) bit for bit.
//
// The design, on the pieces of rows 2 and 5:
//   * No im2col: its 16 columns were only a layout of the same nine bf16
//     values a cell.  conv1_kernel stages a block's log-mel rows (and a
//     time and mel halo, zero outside the clip) in shared memory and reads
//     the nine taps there.  A block takes up to 16 rows and 32 mels of one
//     (clip, chunk) group; thread (mel, 8 channels) walks them.
//   * int8 runs conv1 twice, as row 2's True mode does (conv_block1_v2.cu):
//     the first pass (OUT_MAX) takes the group's max over its in-clip rows
//     into ymax[g] by atomicMax on the float bits (exact, order-free); the
//     second (OUT_Q8) recomputes the rows, the same operations in the same
//     order, so the same bits, and writes them as int8 with the group's
//     scale straight into the mel-padded y1q [G, tc + 2, 66, 64] that the
//     GEMM reads, zero pad columns.  The first design's f32 y1 (550 MB at
//     32 clips x 1001 frames, tc 48), its round trip and its requantize
//     pass are gone.  bf16 runs one pass (OUT_BF16) into the same layout.
//   * conv2 is igemm_kernel MODE 2 at BN = Cout = 64 (two blocks an SM):
//     the f32 pool from the accumulator registers, time pairs in one
//     thread, the chunk's scale folded into alpha2 x sy[g], as rows 3-5
//     run it.  Not MODE 3: that is row 2's bf16-order pool, and row 7
//     pools in f32.
//   * M, the mel count, is a runtime argument: M = 8, 16, 32 or 64, the
//     shapes whose time-pair windows lie inside a 128-row GEMM tile
//     (ops/kernels/conv_block.py v2_takes); the wrapper sends the other
//     even M to the first design, and this entry point refuses them.
//
// Bound on the H100: operations, 4.7 GOP of int8 for conv2 and 0.07
// GFLOP for conv1 a 10 s clip (2.4 us at 1979 TOP/s), against 0.13 MB of
// bf16 log-mel in and 2 MB of bf16 out.  What this design leaves on the
// table: y1 still makes one round trip through device memory (int8, 4.3
// MB a clip read up to nine times from L2 by the GEMM); int8 computes
// conv1 twice on the CUDA cores; and the GEMM's tiles are 128 x 64 with 9
// K stages each, so a tile's fill, drain and epilogue weigh as much as its
// products (as row 5's conv2-only GEMM, pair_conv_pool_v2.cu).
#include "conv_igemm_sm90.cuh"

namespace {

using ttg::bf16;
namespace v2 = ttg::v2;

constexpr int C = 64, TT = 16;
constexpr int MB = 32, NT1 = MB * 8;   // mels and threads of a conv1 block
enum { OUT_BF16 = 0, OUT_MAX = 1, OUT_Q8 = 2 };

// Row r of group g = b * nch + j is time j * tc + r - 1 of clip b; the
// block takes rows [blockIdx.x rpb, + rpb) (rpb <= TT) of group blockIdx.y
// at mels [MB blockIdx.z, + MB), thread (mel MB blockIdx.z + tid / 8,
// channels 8 (tid % 8) + [0, 8)): at M = 64 half the mels a block, so that
// two blocks fit an SM and one's staging overlaps the other's products;
// threads past the last mel only stage.  x [B, T, M] bf16, w1 [9, 64] bf16
// (tap k = dt * 3 + dm), a1, b1 [64] f32; dst rows M + 2 mels wide.
//   OUT_BF16: bf16 y1 into dst [G, R, MP, C], zero outside [0, T);
//   OUT_MAX:  the group's max of y1 over its rows into ymax[g];
//   OUT_Q8:   int8 y1 with the scale of ymax[g] into dst, zero outside.
template <int OUT>
__global__ void __launch_bounds__(NT1, 2)
    conv1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const float* __restrict__ a1, const float* __restrict__ b1,
                 unsigned* __restrict__ ymax, void* __restrict__ dst, int T,
                 int M, int nch, int tc, int R, int rpb) {
  // x at times t0 - 1 .. t0 + rpb, mels m0 - 1 .. m0 + MB
  __shared__ float xs[TT + 2][MB + 2];
  const int g = blockIdx.y, b = g / nch, r0 = blockIdx.x * rpb;
  const int t0 = (g % nch) * tc + r0 - 1, tid = threadIdx.x;
  const int m0 = blockIdx.z * MB;
  const int nrows = min(rpb, R - r0), MP = M + 2;
  for (int i = tid; i < (nrows + 2) * (MB + 2); i += NT1) {
    const int tt = i / (MB + 2), mm = i - tt * (MB + 2);
    const int t = t0 - 1 + tt, m = m0 + mm - 1;
    xs[tt][mm] = t >= 0 && t < T && m >= 0 && m < M
                     ? __bfloat162float(x[((long long)b * T + t) * M + m])
                     : 0.0f;
  }
  __syncthreads();

  const int ml = tid >> 3, m = m0 + ml, c0 = (tid & 7) * 8;
  float wf[9][8], mul[8], beta[8];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const uint4 u = *reinterpret_cast<const uint4*>(w1 + k * C + c0);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      wf[k][2 * i] = f.x;
      wf[k][2 * i + 1] = f.y;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mul[i] = a1[c0 + i];
    beta[i] = b1[c0 + i];
  }
  float qinv = 1.0f;
  if (OUT == OUT_Q8) qinv = 1.0f / v2::scale_of(ymax[g]);

  float vmax = 0.0f;
  for (int tt = 0; tt < (m < M ? nrows : 0); ++tt) {
    const int t = t0 + tt;
    const bool in_clip = t >= 0 && t < T;
    float xv[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) xv[k] = xs[tt + k / 3][ml + k % 3];
    float y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float acc = __fmul_rn(xv[0], wf[0][i]);
#pragma unroll
      for (int k = 1; k < 9; ++k)
        acc = __fadd_rn(acc, __fmul_rn(xv[k], wf[k][i]));
      const float v = fmaxf(__fadd_rn(__fmul_rn(acc, mul[i]), beta[i]), 0.0f);
      y[i] = in_clip ? v : 0.0f;
    }
    if (OUT == OUT_MAX) {
#pragma unroll
      for (int i = 0; i < 8; ++i) vmax = fmaxf(vmax, y[i]);
      continue;
    }
    const long long cell = ((long long)g * R + r0 + tt) * MP + m + 1;
    if (OUT == OUT_BF16) {
      uint4 o;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        h[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      bf16* d = static_cast<bf16*>(dst) + cell * C + c0;
      *reinterpret_cast<uint4*>(d) = o;
      if (m == 0)
        *reinterpret_cast<uint4*>(d - C) = make_uint4(0u, 0u, 0u, 0u);
      if (m == M - 1)
        *reinterpret_cast<uint4*>(d + C) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint2 o;
      int8_t* q = reinterpret_cast<int8_t*>(&o);
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = v2::quant_i8(y[i], qinv);
      int8_t* d = static_cast<int8_t*>(dst) + cell * C + c0;
      *reinterpret_cast<uint2*>(d) = o;
      if (m == 0) *reinterpret_cast<uint2*>(d - C) = make_uint2(0u, 0u);
      if (m == M - 1) *reinterpret_cast<uint2*>(d + C) = make_uint2(0u, 0u);
    }
  }
  if (OUT == OUT_MAX) {
    vmax = v2::block_max(vmax);
    if (tid == 0) v2::max_into(ymax + g, vmax);
  }
}

template <int OUT>
cudaError_t launch_conv1(const bf16* x, const bf16* w1, const float* a1,
                         const float* b1, unsigned* ymax, void* dst, int G,
                         int T, int M, int nch, int tc, int R,
                         cudaStream_t st) {
  // rows a block: R split as evenly as blocks of at most TT rows allow
  const int nb = (R + TT - 1) / TT, rpb = (R + nb - 1) / nb;
  dim3 grid((unsigned)((R + rpb - 1) / rpb), (unsigned)G,
            (unsigned)((M + MB - 1) / MB));
  conv1_kernel<OUT><<<grid, NT1, 0, st>>>(x, w1, a1, b1, ymax, dst, T, M,
                                          nch, tc, R, rpb);
  return cudaGetLastError();
}

}  // namespace

// x [B, T, M] bf16 (the bn0 output), M 8, 16, 32 or 64; tc even; w1 [9,
// 64] bf16; a1, b1 [64] f32; w2 [64, 576] int8 (a2 = BN scale x weight
// scale) or bf16 (k = (dt * 3 + dm) * 64 + ci); ymax [G] unsigned scratch
// (quant only; G = B ceil(T / tc)); y1 [G, tc + 2, M + 2, 64] scratch,
// int8 (quant) or bf16; out [B, T / 2, M / 2, 64] bf16.
extern "C" int ttg_block1_small_v2(int quant, const void* x, int B, int T,
                                   int M, int tc, const void* w1,
                                   const float* a1,
                                   const float* b1, const void* w2,
                                   const float* a2, const float* b2,
                                   void* ymax, void* y1, void* out,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w = static_cast<const bf16*>(w1);
  unsigned* ym = static_cast<unsigned*>(ymax);
  const int nch = (T + tc - 1) / tc, G = B * nch, R = tc + 2;
  if (M < 8 || M % 8 || 128 % (2 * M)) return (int)cudaErrorInvalidValue;
  cudaError_t e;
#define TTG_CHECK(...) \
  if ((e = (__VA_ARGS__)) != cudaSuccess) return (int)e;
  if (quant) {
    TTG_CHECK(cudaMemsetAsync(ym, 0, sizeof(unsigned) * G, st));
    TTG_CHECK(launch_conv1<OUT_MAX>(xb, w, a1, b1, ym, nullptr, G, T, M,
                                    nch, tc, R, st));
    TTG_CHECK(launch_conv1<OUT_Q8>(xb, w, a1, b1, ym, y1, G, T, M, nch, tc,
                                   R, st));
  } else {
    TTG_CHECK(launch_conv1<OUT_BF16>(xb, w, a1, b1, nullptr, y1, G, T, M,
                                     nch, tc, R, st));
  }
  v2::IgemmArgs c2{};
  c2.src = y1;
  c2.wt = w2;
  c2.alpha = a2;
  c2.beta = b2;
  c2.smax = quant ? ym : nullptr;
  c2.scale_div = 1;
  c2.ymax = nullptr;
  c2.dst = out;
  c2.G = G;
  c2.nch = nch;
  c2.tc = tc;
  c2.T = T;
  c2.R_in = R;
  c2.R_out = tc;
  c2.M = M;
  c2.Cin = C;
  c2.Cout = C;
  c2.time_off = 0;
  c2.pt = c2.pm = 2;
  c2.T_out = T / 2;
  if (c2.T_out > 0)
    TTG_CHECK(quant ? v2::launch_igemm_bn<int8_t, 64, 2>(c2, st)
                    : v2::launch_igemm_bn<bf16, 64, 2>(c2, st));
#undef TTG_CHECK
  return (int)cudaSuccess;
}
