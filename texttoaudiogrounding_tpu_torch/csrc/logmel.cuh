// Shared device code of the log-mel kernels (logmel.cu, logmel_v3.cu,
// logmel_v4.cu): the Cnn8Rnn frontend's geometry and one 16-frame tile's
// windowed DFT and power on the tensor cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace ttg_mel {

constexpr int HOP = 320, NFFT = 1024, F = 512, NM = 64, TILE = 16;
constexpr int LDP = F + 4;
// samples of a 16-frame tile: frame r starts at r * HOP
constexpr int WIN = (TILE - 1) * HOP + NFFT;
constexpr float DB = 4.342944819032518f;  // 10 / ln 10

// power[r][f] = re^2 + im^2 of frames r = 0..15 (frame r starts at
// frames + r * HOP, bf16) against the windowed bf16 basis re, im
// [NFFT, F], into ps [TILE][LDP] f32: bf16 products, f32 sums over
// k = 0, 16, .. in order.  Warp w of 8 takes columns w * 64 .. w * 64 + 63.
__device__ __forceinline__ void dft_power_tile(
    const __nv_bfloat16* frames, const __nv_bfloat16* __restrict__ re,
    const __nv_bfloat16* __restrict__ im, float* ps, int warp) {
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cr[4], ci[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(cr[j], 0.0f);
    wmma::fill_fragment(ci[j], 0.0f);
  }
  for (int k = 0; k < NFFT; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa;
    wmma::load_matrix_sync(fa, frames + k, HOP);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> br, bi;
      const int col = warp * 64 + j * 16;
      wmma::load_matrix_sync(br, re + (long long)k * F + col, F);
      wmma::load_matrix_sync(bi, im + (long long)k * F + col, F);
      wmma::mma_sync(cr[j], fa, br, cr[j]);
      wmma::mma_sync(ci[j], fa, bi, ci[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // the two accumulators share one element layout
#pragma unroll
    for (int e = 0; e < cr[j].num_elements; ++e)
      cr[j].x[e] = __fadd_rn(__fmul_rn(cr[j].x[e], cr[j].x[e]),
                             __fmul_rn(ci[j].x[e], ci[j].x[e]));
    wmma::store_matrix_sync(ps + warp * 64 + j * 16, cr[j], LDP,
                            wmma::mem_row_major);
  }
}

// out[r][mel] = DB ln(max(sum_f ps[r][f] fb[f][mel], 1e-10)) for the f32
// mel projection, f = 0 .. F - 1 in order; thread (mel, rows r0 .. r0+3).
// Rows at or past nrows are not written.
__device__ __forceinline__ void mel_db_tile(const float* ps,
                                            const float* __restrict__ fb,
                                            float* out, int nrows, int tid) {
  const int mel = tid & (NM - 1), r0 = (tid / NM) * 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int f = 0; f < F; ++f) {
    const float w = fb[f * NM + mel];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[i] = fmaf(ps[(r0 + i) * LDP + f], w, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (r0 + i < nrows)
      out[(r0 + i) * NM + mel] = DB * logf(fmaxf(acc[i], 1e-10f));
}

}  // namespace ttg_mel
