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
// columns), so the power tile stays in shared memory for the mel product
// (logmel.cuh, shared with the v3 and v4 kernels).
//
// Bound on the H100: operations are 2.1 GFLOP bf16 per 10 s clip (2.1 us
// at 989 TFLOP/s) against 1.28 MB of f32 waveform in and 0.26 MB of
// output (0.46 us at 3.35 TB/s): operations.  This version streams the
// basis from L2 for every 16 frames and does not pipeline its loads.
#include "logmel.cuh"

namespace {

using namespace ttg_mel;

__global__ void __launch_bounds__(256)
    logmel_kernel(const __nv_bfloat16* __restrict__ xpad, long long npad,
                  const __nv_bfloat16* __restrict__ re,
                  const __nv_bfloat16* __restrict__ im,
                  const float* __restrict__ fb, float* __restrict__ out,
                  int T) {
  __shared__ __align__(128) float ps[TILE * LDP];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y, f0 = blockIdx.x * TILE;
  dft_power_tile(xpad + b * npad + (long long)f0 * HOP, re, im, ps, warp);
  __syncthreads();
  mel_db_tile(ps, fb, out + ((long long)b * T + f0) * NM, T - f0, tid);
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
