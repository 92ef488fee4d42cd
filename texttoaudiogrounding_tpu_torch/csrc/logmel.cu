// Fused log-mel frontend: windowed DFT -> power -> slaney mel -> dB.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/logmel.py:438
// fused_log_mel_spectrogram.  Same arithmetic: the reflect-padded waveform
// is bf16, the windowed DFT basis is bf16 and trimmed to the 512 bins
// below the last mel-active one, the DFT accumulates in f32, power and the
// mel projection are f32, out = 10 / ln 10 * ln(max(mel, 1e-10)).
//
// No frame tensor exists: frame t of a clip starts at sample t * hop of the
// padded waveform, so a tile of 16 frames is a row-major matrix with leading
// dimension hop, read straight into WMMA fragments.  A block of 8 warps
// takes 16 frames x all 512 bins (each warp 64 real + 64 imaginary
// columns), so the power tile stays in shared memory for the mel product.
//
// Bound on the H100: operations are 2.1 GFLOP bf16 per 10 s clip (2.1 us
// at 989 TFLOP/s) against 1.28 MB of f32 waveform in and 0.26 MB of
// output (0.46 us at 3.35 TB/s): operations.  This version streams the
// basis from L2 for every 16 frames and does not pipeline its loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int HOP = 320, NFFT = 1024, F = 512, NM = 64, TILE = 16;
constexpr int LDP = F + 4;

__global__ void __launch_bounds__(256)
    logmel_kernel(const __nv_bfloat16* __restrict__ xpad, long long npad,
                  const __nv_bfloat16* __restrict__ re,
                  const __nv_bfloat16* __restrict__ im,
                  const float* __restrict__ fb, float* __restrict__ out,
                  int T) {
  using namespace nvcuda;
  __shared__ __align__(128) float ps[TILE * LDP];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y, f0 = blockIdx.x * TILE;
  const __nv_bfloat16* frames = xpad + b * npad + (long long)f0 * HOP;

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
  __syncthreads();

  const int mel = tid & (NM - 1), r0 = (tid / NM) * 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int f = 0; f < F; ++f) {
    const float w = fb[f * NM + mel];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[i] = fmaf(ps[(r0 + i) * LDP + f], w, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = f0 + r0 + i;
    if (t < T)
      out[((long long)b * T + t) * NM + mel] =
          4.342944819032518f * logf(fmaxf(acc[i], 1e-10f));
  }
}

}  // namespace

// xpad [B, npad] bf16: reflect-padded waveform, zero beyond, with
// npad >= (ceil(T / 16) * 16 - 1) * hop + n_fft and npad % 16 == 0;
// re, im [1024, 512] bf16 windowed DFT basis; fb [512, 64] f32;
// out [B, T, 64] f32.
extern "C" int ttg_logmel(const void* xpad, long long npad, int B, int T,
                          const void* re, const void* im, const float* fb,
                          float* out, void* stream) {
  dim3 grid((T + TILE - 1) / TILE, B);
  logmel_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xpad), npad,
      static_cast<const __nv_bfloat16*>(re),
      static_cast<const __nv_bfloat16*>(im), fb, out, T);
  return (int)cudaGetLastError();
}
