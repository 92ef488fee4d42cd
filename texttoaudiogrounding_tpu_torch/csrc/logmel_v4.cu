// Log-mel frontend with the next tile's load under the current epilogue.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/logmel.py:175
// fused_log_mel_spectrogram_v4: row 1's function (logmel.cu), bit for bit,
// on the TPU kernel's schedule.  There a tile's power -> mel -> dB
// epilogue is deferred so that it overlaps the next tile's DFT (ping-pong
// re/im scratch).  Here each block walks several 16-frame tiles (block i
// takes tiles i, i + grid, ...): the next tile's 5824 waveform samples
// are copied into the second of two shared-memory buffers with cp.async
// while the current tile's DFT, power, mel projection and dB run.  Every
// output is the same sequence of the same operations as in logmel.cu
// (logmel.cuh's tile functions; the fragments are loaded from shared
// memory instead of device memory), so the result is bit-identical.
//
// Bound on the H100: as row 1, operations (2.1 GFLOP bf16 per 10 s clip)
// against 1.28 MB of waveform in and 0.26 MB out per clip.
#include "logmel.cuh"

namespace {

using namespace ttg_mel;

constexpr int PS_BYTES = TILE * LDP * 4;
constexpr int XS_BYTES = WIN * 2;                  // one bf16 tile window
constexpr int SMEM = PS_BYTES + 2 * XS_BYTES;
static_assert(XS_BYTES % 32 == 0 && PS_BYTES % 32 == 0, "WMMA alignment");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// stage tile `tile` (clip tile / tiles, frames from (tile % tiles) * 16)
__device__ __forceinline__ void stage(__nv_bfloat16* xs,
                                      const __nv_bfloat16* xpad,
                                      long long npad, int tile, int tiles) {
  const __nv_bfloat16* src = xpad + (long long)(tile / tiles) * npad +
                             (long long)(tile % tiles) * TILE * HOP;
  for (int i = threadIdx.x; i < XS_BYTES / 16; i += blockDim.x)
    cp_async16(reinterpret_cast<unsigned char*>(xs) + 16 * i,
               reinterpret_cast<const unsigned char*>(src) + 16 * i);
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(256)
    logmel_v4_kernel(const __nv_bfloat16* __restrict__ xpad, long long npad,
                     const __nv_bfloat16* __restrict__ re,
                     const __nv_bfloat16* __restrict__ im,
                     const float* __restrict__ fb, float* __restrict__ out,
                     int B, int T) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ps = reinterpret_cast<float*>(smem);
  __nv_bfloat16* xs[2] = {
      reinterpret_cast<__nv_bfloat16*>(smem + PS_BYTES),
      reinterpret_cast<__nv_bfloat16*>(smem + PS_BYTES + XS_BYTES)};
  const int tid = threadIdx.x, warp = tid >> 5;
  const int tiles = (T + TILE - 1) / TILE, total = B * tiles;
  int buf = 0;
  if (blockIdx.x < total) stage(xs[0], xpad, npad, blockIdx.x, tiles);
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < total) {
      stage(xs[buf ^ 1], xpad, npad, next, tiles);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    dft_power_tile(xs[buf], re, im, ps, warp);
    __syncthreads();
    const int b = tile / tiles, f0 = (tile % tiles) * TILE;
    mel_db_tile(ps, fb, out + ((long long)b * T + f0) * NM, T - f0, tid);
    __syncthreads();  // ps and xs[buf] are rewritten next
    buf ^= 1;
  }
}

}  // namespace

// As ttg_logmel (logmel.cu): xpad [B, npad] bf16 reflect-padded waveform,
// npad >= (ceil(T / 16) * 16 - 1) * hop + n_fft, npad % 16 == 0; re, im
// [1024, 512] bf16; fb [512, 64] f32; out [B, T, 64] f32.  The grid is the
// card's resident blocks, at most one per tile.
extern "C" int ttg_logmel_v4(const void* xpad, long long npad, int B, int T,
                             const void* re, const void* im, const float* fb,
                             float* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      logmel_v4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, logmel_v4_kernel,
                                                256, SMEM);
  const int total = B * ((T + TILE - 1) / TILE);
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  grid = grid < total ? grid : total;
  logmel_v4_kernel<<<grid, 256, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xpad), npad,
      static_cast<const __nv_bfloat16*>(re),
      static_cast<const __nv_bfloat16*>(im), fb, out, B, T);
  return (int)cudaGetLastError();
}
