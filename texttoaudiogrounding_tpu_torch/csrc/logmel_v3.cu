// Log-mel frontend without the reflect-pad copy: exact-K DFT on the
// waveform, bf16 mel projection.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/logmel.py:350
// fused_log_mel_spectrogram_v3.  Frame t covers samples [t hop - 512,
// t hop + 512) of the waveform itself; for the frames whose window lies
// inside the clip, t in [t_lo, t_hi), that is the centre-padded frame, and
// the other four frames of a clip (t < 2 and t >= t_hi) are the caller's
// (the TPU path recomputes them with XLA and splices them in).  A block
// takes 16 frames of one clip: it reads their 5824 f32 samples once,
// rounds them to bf16 in shared memory (the TPU path casts the waveform
// to bf16), runs the 1024-row windowed DFT on the tensor cores with f32
// sums (logmel.cuh), forms the f32 power, rounds it to bf16 and projects
// it onto the bf16 slaney filterbank on the tensor cores with f32 sums
// (logmel.py:335), then 10 / ln 10 ln(max(mel, 1e-10)).
//
// Bound on the H100: operations, 2.1 GFLOP bf16 of DFT and 0.07 GFLOP of
// mel projection per 10 s clip (2.2 us at 989 TFLOP/s) against 1.28 MB of
// f32 waveform read and 0.26 MB written (0.46 us at 3.35 TB/s).
#include "logmel.cuh"

namespace {

using namespace ttg_mel;

constexpr int LDB = F + 16;                     // bf16 power row stride
constexpr int LDM = NM + 4;                     // f32 mel row stride
constexpr int PS_BYTES = TILE * LDP * 4;
constexpr int PB_BYTES = TILE * LDB * 2;
constexpr int XS_BYTES = WIN * 2;
constexpr int SMEM = PS_BYTES + PB_BYTES + XS_BYTES;
static_assert(PS_BYTES % 32 == 0 && PB_BYTES % 32 == 0, "WMMA alignment");

__global__ void __launch_bounds__(256)
    logmel_v3_kernel(const float* __restrict__ x, long long n,
                     const __nv_bfloat16* __restrict__ re,
                     const __nv_bfloat16* __restrict__ im,
                     const __nv_bfloat16* __restrict__ fb,
                     float* __restrict__ out, int T, int t_lo, int t_hi) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ps = reinterpret_cast<float*>(smem);
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(smem + PS_BYTES);
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(smem + PS_BYTES + PB_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y, f0 = t_lo + blockIdx.x * TILE;
  const long long s0 = (long long)f0 * HOP - NFFT / 2;
  const float* clip = x + (long long)b * n;
  for (int i = tid; i < WIN; i += blockDim.x) {
    const long long s = s0 + i;
    xs[i] = __float2bfloat16_rn(s >= 0 && s < n ? clip[s] : 0.0f);
  }
  __syncthreads();
  dft_power_tile(xs, re, im, ps, warp);
  __syncthreads();
  for (int e = tid; e < TILE * F; e += blockDim.x)
    pb[(e / F) * LDB + e % F] =
        __float2bfloat16_rn(ps[(e / F) * LDP + e % F]);
  __syncthreads();
  float* mel = ps;  // [TILE][LDM], ps is free now
  if (warp < NM / 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < F; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fw;
      wmma::load_matrix_sync(fa, pb + k, LDB);
      wmma::load_matrix_sync(fw, fb + k * NM + warp * 16, NM);
      wmma::mma_sync(acc, fa, fw, acc);
    }
    wmma::store_matrix_sync(mel + warp * 16, acc, LDM, wmma::mem_row_major);
  }
  __syncthreads();
  const int m = tid & (NM - 1), r0 = (tid / NM) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = f0 + r0 + i;
    if (t < t_hi)
      out[((long long)b * T + t) * NM + m] =
          DB * logf(fmaxf(mel[(r0 + i) * LDM + m], 1e-10f));
  }
}

}  // namespace

// x [B, n] f32 waveform; re, im [1024, 512] bf16 windowed DFT basis; fb
// [512, 64] bf16 filterbank; out [B, T, 64] f32, of which frames
// [t_lo, t_hi) are written (2 <= t_lo, t_hi <= (n - 512) / 320 + 1).
extern "C" int ttg_logmel_v3(const float* x, long long n, int B, int T,
                             int t_lo, int t_hi, const void* re,
                             const void* im, const void* fb, float* out,
                             void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      logmel_v3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t_hi - t_lo + TILE - 1) / TILE, B);
  logmel_v3_kernel<<<grid, 256, SMEM, static_cast<cudaStream_t>(stream)>>>(
      x, n, static_cast<const __nv_bfloat16*>(re),
      static_cast<const __nv_bfloat16*>(im),
      static_cast<const __nv_bfloat16*>(fb), out, T, t_lo, t_hi);
  return (int)cudaGetLastError();
}
