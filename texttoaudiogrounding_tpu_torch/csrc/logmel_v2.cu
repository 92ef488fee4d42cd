// Row 1 of the port, second design (sm_90a): the fused log-mel frontend,
// windowed DFT -> power -> slaney mel -> dB, as a wgmma GEMM over 128-frame
// tiles fed by an asynchronous shared-memory ring.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/logmel.py:438
// fused_log_mel_spectrogram.  The function is the first design's
// (logmel.cu): the reflect-padded waveform in bf16, the windowed bf16 DFT
// basis trimmed to the 512 bins below the last mel-active one, f32 sums,
// f32 power and mel projection, out = 10 / ln 10 ln(max(mel, 1e-10)).
// What changes is how the card gets there:
//
// 1. wave_pad_kernel, one wide pass (8 samples a thread), reads the f32
//    waveform once and writes the reflect-padded, zero-extended bf16 xpad
//    [B, npad] that the first design built with three PyTorch launches.
// 2. logmel_v2_kernel: M = frames, N = bins, K = 1024.  A block takes 128
//    frames of one clip (two consumer warpgroups of 64) and all 512 bins in
//    four passes of 256 columns.  Frame r starts at xpad + (f0 + r) 320:
//    its rows are 640-byte aligned, so A is unpredicated 16-byte cp.async
//    copies, the same mainloop as a one-tap implicit GEMM with row stride
//    320 (conv_igemm_sm90.cuh's 4-slot ring, 64-byte swizzle, two stages
//    ahead, wgmma m64n256k16 bf16 -> f32).  The 128 stages of a tile (4
//    passes x 32 K chunks) run as one stream, so the next pass's loads fly
//    during a pass's epilogue.  B is the basis with re and im interleaved
//    by bin (row 2f real, 2f + 1 imaginary, K-major), so a thread's
//    accumulator pair (columns 2f, 2f + 1) is one bin's (re, im) and the
//    power re re + im im is formed in registers.  Against the first
//    design's 16-frame blocks, which stream the whole 2 MB basis from L2
//    for every 16 frames (~4 GB a call at 32 clips x 10 s), the basis is
//    read once per 128 frames.
// 3. The mel projection is band-limited: the pass's power (128 frames x 128
//    bins, f32) goes to shared memory, bin-major, and each mel sums only
//    its filter's nonzero bins in ascending f, into accumulators in shared
//    memory that carry across the four passes.  A product with a zero
//    weight adds an exact zero, so each sum is the full ascending f32
//    projection (__fmul_rn then __fadd_rn, bin by bin).  Thread (frame,
//    mel parity) walks its 32 mels with warp-uniform bounds.
//
// Bound on the H100: operations, 2.1 GFLOP of bf16 a 10 s clip (2.1 us at
// 989 TFLOP/s), against 1.28 MB of f32 waveform in and 0.26 MB of output.
// What this design leaves on the table: each tile reads its 2 MB of basis
// and, four times, its frames from L2 (~24 KB a stage against ~2.1 MFLOP);
// a 2-block cluster with the basis multicast would halve the former.
#include "conv_igemm_sm90.cuh"
#include "logmel_v2.cuh"

namespace {

using ttg::bf16;
namespace v2 = ttg::v2;
using ttg_mel_v2::wave_pad_kernel;

constexpr int HOP = 320, NFFT = 1024, NBIN = 512, NM = 64;
constexpr int BMF = 128;                    // frames of a tile
constexpr int BNC = 256;                    // columns of a pass: 128 bins
constexpr int PBIN = BNC / 2;
constexpr int NPASS = NBIN / PBIN;          // 4
constexpr int KST = NFFT * 2 / v2::KB;      // 32 K stages of a pass
constexpr int NTH = 256;
constexpr int A_STAGE = BMF * v2::KB, B_STAGE = BNC * v2::KB;
constexpr int LDP = BMF + 8;                // power [bin][frame]
constexpr int LDM = BMF + 1;                // mel sums [mel][frame]
constexpr int RING = v2::STAGES * (A_STAGE + B_STAGE);
constexpr int SMEM = RING + PBIN * LDP * 4 + NM * LDM * 4 + 1024;
constexpr float DB = 4.342944819032518f;    // 10 / ln 10

// One tile: frames [f0, f0 + 128) of clip blockIdx.y, f0 = 128 blockIdx.x.
//   xpad [B, npad] bf16; basis [1024 (2 NBIN) rows, NFFT] bf16, row 2f + e
//   the real (e = 0) or imaginary part of bin f, K-major; band [NM, 3]
//   int (first bin, end bin, offset into wts) of each mel's nonzero
//   weights; out [B, T, NM] f32.
__global__ void __launch_bounds__(NTH, 1)
    logmel_v2_kernel(const bf16* __restrict__ xpad, long long npad,
                     const bf16* __restrict__ basis,
                     const int* __restrict__ band,
                     const float* __restrict__ wts, float* __restrict__ out,
                     int T) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (base & 1023)) & 1023);
  unsigned char* As = smem;
  unsigned char* Bs = smem + v2::STAGES * A_STAGE;
  float* pw = reinterpret_cast<float*>(smem + RING);   // [PBIN][LDP]
  float* ms = pw + PBIN * LDP;                          // [NM][LDM]

  const int tid = threadIdx.x, wg = tid >> 7;
  const int b = blockIdx.y, f0 = blockIdx.x * BMF;
  for (int i = tid; i < NM * LDM; i += NTH) ms[i] = 0.0f;

  // 16-byte piece q of a stage: row (q / 8 CPR) * 8 + q % 8, chunk
  // (q / 8) % CPR, as in igemm_kernel
  constexpr int A_PT = BMF * v2::CPR / NTH, B_PT = BNC * v2::CPR / NTH;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(
      xpad + (long long)b * npad);
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(basis);
  long long a_off[A_PT];
  int a_dst[A_PT], b_off[B_PT], b_dst[B_PT];
#pragma unroll
  for (int i = 0; i < A_PT; ++i) {
    const int q = tid + i * NTH;
    const int row = (q / (8 * v2::CPR)) * 8 + (q & 7), c = (q >> 3) % v2::CPR;
    a_off[i] = (long long)(f0 + row) * HOP * 2 + c * 16;
    a_dst[i] = v2::piece_offset(row, c);
  }
#pragma unroll
  for (int i = 0; i < B_PT; ++i) {
    const int q = tid + i * NTH;
    const int row = (q / (8 * v2::CPR)) * 8 + (q & 7), c = (q >> 3) % v2::CPR;
    b_off[i] = row * NFFT * 2 + c * 16;
    b_dst[i] = v2::piece_offset(row, c);
  }
  constexpr int S = NPASS * KST;
  auto load = [&](int s) {
    const int pass = s / KST, kc = s % KST;
    unsigned char* as = As + (s % v2::STAGES) * A_STAGE;
    unsigned char* bs = Bs + (s % v2::STAGES) * B_STAGE;
    const long long pass_b = (long long)pass * BNC * NFFT * 2 + kc * v2::KB;
#pragma unroll
    for (int i = 0; i < A_PT; ++i)
      v2::cp_async16(as + a_dst[i], xb + a_off[i] + kc * v2::KB);
#pragma unroll
    for (int i = 0; i < B_PT; ++i)
      v2::cp_async16(bs + b_dst[i], wb + b_off[i] + pass_b);
  };

  float acc[BNC / 2];
#pragma unroll
  for (int i = 0; i < BNC / 2; ++i) acc[i] = 0.0f;
  v2::fence_acc(acc);

  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row0 = wg * 64 + warp * 16 + (lane >> 2);
  // the mel projection: thread (frame fr, mels of parity par)
  const int fr = tid & (BMF - 1), par = tid >> 7;

#pragma unroll
  for (int s = 0; s < v2::AHEAD; ++s) {
    load(s);
    v2::cp_async_commit();
  }
  for (int s = 0; s < S; ++s) {
    v2::cp_async_wait<v2::AHEAD - 1>();
    v2::fence_async_shared();
    __syncthreads();
    if (s + v2::AHEAD < S) load(s + v2::AHEAD);
    v2::cp_async_commit();
    const unsigned char* as = As + (s % v2::STAGES) * A_STAGE + wg * 64 * v2::KB;
    const unsigned char* bs = Bs + (s % v2::STAGES) * B_STAGE;
    v2::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < v2::KB / 32; ++ks)
      v2::wgmma_bf16_n256(acc, v2::smem_desc(as + ks * 32),
                          v2::smem_desc(bs + ks * 32));
    v2::wgmma_commit();
    v2::wgmma_wait<1>();
    if (s % KST != KST - 1) continue;

    // end of pass p: power of bins 128 p + [0, 128) into pw, then each
    // mel's in-band bins of the pass
    const int p = s / KST;
    v2::wgmma_wait<0>();
    v2::fence_acc(acc);
#pragma unroll
    for (int j = 0; j < BNC / 8; ++j) {
      const int bin = 4 * j + (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float re = acc[4 * j + 2 * h], im = acc[4 * j + 2 * h + 1];
        pw[bin * LDP + row0 + 8 * h] =
            __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
      }
    }
#pragma unroll
    for (int i = 0; i < BNC / 2; ++i) acc[i] = 0.0f;
    v2::fence_acc(acc);
    __syncthreads();
    const int lo_p = p * PBIN, hi_p = lo_p + PBIN;
    for (int i = 0; i < NM / 2; ++i) {
      const int mel = 2 * i + par;
      const int lo = max(band[3 * mel], lo_p);
      const int hi = min(band[3 * mel + 1], hi_p);
      const int wo = band[3 * mel + 2] - band[3 * mel];
      float m = ms[mel * LDM + fr];
      for (int f = lo; f < hi; ++f)
        m = __fadd_rn(m, __fmul_rn(pw[(f - lo_p) * LDP + fr], wts[wo + f]));
      ms[mel * LDM + fr] = m;
    }
    // pw is written again only 32 stages (and barriers) later
  }
  __syncthreads();
  for (int i = tid; i < BMF * NM; i += NTH) {
    const int r = i / NM, mel = i % NM;
    if (f0 + r < T)
      out[((long long)b * T + f0 + r) * NM + mel] =
          DB * logf(fmaxf(ms[mel * LDM + r], 1e-10f));
  }
}

}  // namespace

// x [B, N] f32 (N > pad = n_fft / 2); xpad [B, npad] bf16 scratch with
// npad % 8 == 0 and npad >= (ceil(T / 128) 128 - 1) 320 + 1024; basis
// [1024, 1024] bf16 (interleaved re / im rows); band [64, 3] int32;
// wts f32 (the mels' nonzero weights, band order); out [B, T, 64] f32.
extern "C" int ttg_logmel_v2(const float* x, int B, int N, void* xpad,
                             long long npad, int T, const void* basis,
                             const int* band, const float* wts, float* out,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* xp = static_cast<bf16*>(xpad);
  const long long nvec = (long long)B * npad / 8;
  wave_pad_kernel<<<v2::blocks_for(nvec, 256), 256, 0, st>>>(
      x, xp, N, NFFT / 2, npad, nvec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  static bool configured = false;
  if (!configured) {
    e = cudaFuncSetAttribute(logmel_v2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((unsigned)((T + BMF - 1) / BMF), (unsigned)B);
  logmel_v2_kernel<<<grid, NTH, SMEM, st>>>(
      xp, npad, static_cast<const bf16*>(basis), band, wts, out, T);
  return (int)cudaGetLastError();
}
