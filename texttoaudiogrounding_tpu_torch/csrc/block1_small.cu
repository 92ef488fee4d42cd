// PANNs block 1 (1 -> 64 -> 64, 2 x 2 avg+max pool) from a K = 16 conv1
// im2col, int8 (or bf16) conv2.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/conv_block_small.py:471
// fused_block1 (kernel _block1_kernel :420).  The TPU kernel folds conv1
// in as one K = 16 bf16 dot over an im2col staged outside it (row (t, mel
// pair j): mels 2j - 1 .. 2j + 2 at times t - 1 .. t + 1, 12 real taps
// feeding both mel parities) and runs conv2 as banded K = 384 int8 dots
// with N = (parity, channel) = 128.  Here:
//   * conv1 on CUDA cores, one block per 8 rows and 32 mel pairs of a
//     (clip, chunk) group (any even M), from the same im2col (the wrapper
//     builds it with PyTorch, as XLA does in the JAX package): output
//     mel 2j + p, channel c sums im2col[t, j, dt * 4 + dm + p] *
//     w1[dt, dm, c] in tap order, bf16
//     operands whose products are exact in f32; BN, ReLU, rows outside
//     the clip zeroed; the group's rows are times [j tc - 1, j tc + tc +
//     1), stored as f32 (int8) or bf16;
//   * int8: one y1 scale per chunk, max(y1) / 127 over the f32 rows (not
//     rounded to bf16 first), requantize, int8 conv2 with the scale in the
//     affine (common.cuh conv2_pool); f32 avg+max pool; bf16 out.
//
// Bound on the H100: operations (4.7 GOP int8 for conv2 and 0.07 GFLOP
// bf16 for conv1 per 10 s clip, 2.4 us at 1979 TOP/s) against 1 MB of
// im2col (or 0.1 MB of log-mel) in and 2 MB of bf16 out.  The y1 round
// trip through device memory (16 MB f32 + 4 MB int8 per clip) is this
// version's cost, not the function's.
#include "common.cuh"

namespace {

using ttg::bf16;

// y1[g, r, mo, c] for group g = b * nch + j, row r < tc + 2 at time
// t = j tc + r - 1: relu(conv1 * a1[c] + b1[c]) for t in [0, T), else 0.
// A block computes 8 rows and mel pairs [PC blockIdx.z, + PC) of one
// group; thread (c, quarter of the block's mels).
template <typename Out>
__global__ void __launch_bounds__(256)
    conv1_im2col_kernel(const bf16* __restrict__ xim,
                        const bf16* __restrict__ w,
                        const float* __restrict__ alpha,
                        const float* __restrict__ beta,
                        Out* __restrict__ y1, int T, int Tg, int M, int nch,
                        int tc) {
  constexpr int PC = 32, C = 64, TT = 8, K = 16;
  __shared__ float xs[TT][PC][K];
  const int g = blockIdx.y, b = g / nch, j = g % nch, mp = M / 2;
  const int r0 = blockIdx.x * TT, R = tc + 2, tid = threadIdx.x;
  const int p0 = blockIdx.z * PC, np = min(PC, mp - p0);
  for (int i = tid; i < TT * PC * K; i += blockDim.x) {
    const int tt = i / (PC * K), rest = i % (PC * K);
    const int t = j * tc + r0 + tt - 1;
    xs[tt][rest / K][rest % K] =
        (t >= 0 && t < Tg && r0 + tt < R && rest / K < np)
            ? ttg::to_f32(
                  xim[((long long)b * Tg + t) * mp * K + p0 * K + rest])
            : 0.0f;
  }
  __syncthreads();
  const int c = tid & 63, mg = tid >> 6;
  float wv[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wv[k] = ttg::to_f32(w[k * C + c]);
  const float a = alpha[c], bb = beta[c];
  for (int tt = 0; tt < TT; ++tt) {
    const int r = r0 + tt;
    if (r >= R) break;
    const int t = j * tc + r - 1;
    const bool valid = t >= 0 && t < T;
    for (int mo = mg * 16; mo < min(mg * 16 + 16, 2 * np); ++mo) {
      const int q = mo >> 1, p = mo & 1;
      float acc = __fmul_rn(xs[tt][q][p], wv[0]);
#pragma unroll
      for (int k = 1; k < 9; ++k)
        acc = __fadd_rn(acc,
                        __fmul_rn(xs[tt][q][(k / 3) * 4 + k % 3 + p], wv[k]));
      const float y = fmaxf(__fadd_rn(__fmul_rn(acc, a), bb), 0.0f);
      const long long cell = ((long long)g * R + r) * M + 2 * p0 + mo;
      ttg::store<Out>(y1 + cell * C + c, valid ? y : 0.0f);
    }
  }
}

}  // namespace

// xim [B, Tg * M / 2, 16] bf16 (Tg = ceil(T / tc) tc, M even); w1 [9,
// 64] bf16; a1, b1 [64] f32; w2 [64, 576] int8 (a2 = BN scale x weight
// scale) or bf16; y1 [G, tc + 2, M, 64] f32 (quant) or bf16 scratch, y1q
// the same in int8 (quant only), sy [G] f32 scratch (G = B Tg / tc); out
// [B, T / 2, M / 2, 64] bf16.
extern "C" int ttg_block1_small(int quant, const void* xim, int B, int T,
                                int M, int tc, const void* w1,
                                const float* a1, const float* b1,
                                const void* w2,
                                const float* a2, const float* b2, void* y1,
                                void* y1q, float* sy, void* out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = (T + tc - 1) / tc, Tg = nch * tc;
  const bf16* x = static_cast<const bf16*>(xim);
  const bf16* w = static_cast<const bf16*>(w1);
  if (M < 2 || M % 2) return (int)cudaErrorInvalidValue;
  dim3 grid((tc + 2 + 7) / 8, B * nch, (M / 2 + 31) / 32);
  if (quant)
    conv1_im2col_kernel<float><<<grid, 256, 0, st>>>(
        x, w, a1, b1, static_cast<float*>(y1), T, Tg, M, nch, tc);
  else
    conv1_im2col_kernel<bf16><<<grid, 256, 0, st>>>(
        x, w, a1, b1, static_cast<bf16*>(y1), T, Tg, M, nch, tc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)ttg::conv2_pool(quant != 0, false, y1,
                              static_cast<int8_t*>(y1q), sy, B, nch, T, M,
                              64, tc, 2, 2, w2, a2, b2,
                              static_cast<bf16*>(out), st);
}
