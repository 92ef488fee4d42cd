// Row 9 of the port, second design (sm_90a): the log-mel frontend without
// the reflect-pad copy, exact-K DFT on the waveform and a bf16 mel
// projection, on row 1's wgmma DFT (logmel_v2.cu), with the four edge
// frames a clip in the same launch.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/logmel.py:350
// fused_log_mel_spectrogram_v3.  The contract carried over, the first
// design's (logmel_v3.cu):
//   * frame t in [t_lo, t_hi) covers samples [t hop - n_fft / 2, t hop +
//     n_fft / 2) of the waveform cast to bf16, no reflect copy (:399-401,
//     the shifted basis parts :285): K is exactly n_fft rows;
//   * the windowed DFT as bf16 products with f32 sums against the basis
//     trimmed to 512 bins, f32 power (:330);
//   * the power rounded to bf16 and projected onto the bf16 slaney
//     filterbank with f32 sums (:335), then 10 / ln 10 ln(max(mel, 1e-10));
//   * the frames t < t_lo and t >= t_hi, four a clip, are the f32
//     centred-reflect log-mel of the whole clip at that frame (:426-436,
//     the XLA path on waveform slices whose own reflect padding is the
//     clip's): an f32 windowed DFT of reflect-indexed samples, f32 power,
//     f32 mel projection, dB.
//
// The design:
//   1. wave_cast_kernel, one wide pass (8 samples a thread), writes the
//      waveform as bf16 xb [B, npad], each clip up to its last interior
//      frame's window (zero past the clip's end).
//   2. logmel_v3_kernel's tiles are row 1's: 128 frames, K = 1024, the
//      re / im-interleaved basis in four passes of 128 bins, wgmma
//      m64n256k16 from the 4-slot cp.async ring.  Frame t of clip b reads
//      its A row at xb + b npad + t 320 - 512: its byte offset 640 t - 1024
//      is 16-byte aligned, so the loads are the same unpredicated cp.async
//      rows as row 1's, and a row may be any clip's, so the tiles run over
//      the call's interior frames clip after clip (250 tiles at 32 clips x
//      10 s, against 256 of 128 frames a clip).  The power is formed in
//      registers and rounded to bf16; each mel then sums its filter's
//      nonzero bins in ascending f against the bf16 weights (a product of
//      two bf16 values is exact in f32), carried across the passes in
//      shared memory.
//   3. The first blocks of the same launch take the edge frames, EF = 24
//      frames a block: the reflect-indexed f32 samples staged in shared
//      memory, a direct f32 DFT on the CUDA cores over the bins that some
//      mel weights (two bins a thread, all EF frames at once, so the f32
//      basis is read once a block), the f32 power, the band-limited f32
//      mel sum and dB.  They run on their own SMs beside both waves of
//      tiles: at 32 clips 6 edge blocks and 250 tiles are 256 blocks, as
//      many as row 1's two waves hold, and an edge block takes about as
//      long as two tiles (of 8, 12, 16 and 24 frames a block, timed on the
//      H100, only 24 ran the launch in row 1's time).
//
// Bound on the H100: operations, 2.1 GFLOP of bf16 DFT a 10 s clip and
// 7 MFLOP of f32 for its four edge frames (2.2 us at the peaks), against
// 1.28 MB of f32 waveform in and 0.26 MB out.  What this design leaves on
// the table: as row 1, each tile reads its 2 MB of basis and, four times,
// its frames from L2; the edge blocks read the 3.7 MB f32 basis each and
// run ~96 K FMA a thread on the CUDA cores at about half the f32 rate, and
// their size suits 32 clips (another batch may leave an SM idle or add a
// wave).
#include "conv_igemm_sm90.cuh"

namespace {

using ttg::bf16;
namespace v2 = ttg::v2;

constexpr int HOP = 320, NFFT = 1024, PAD = NFFT / 2, NBIN = 512, NM = 64;
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
constexpr int EF = 24;                      // edge frames a block
constexpr int KU = 8;                       // k steps a batch of loads
constexpr float DB = 4.342944819032518f;    // 10 / ln 10
static_assert((NFFT + NBIN) * EF * 4 <= SMEM, "edge blocks' shared memory");

// xb[b, i] = bf16(x[b, i]) for i < n, else 0 (i < npad); thread v writes
// the 8 samples [8 v, 8 v + 8) of the flat [B, npad].
__global__ void wave_cast_kernel(const float* __restrict__ x,
                                 bf16* __restrict__ xb, long long n,
                                 long long npad, long long nvec) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nvec) return;
  const long long b = (8 * v) / npad;
  const long long i0 = 8 * v - b * npad;
  const float* clip = x + b * n;
  uint4 o;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long i = i0 + 2 * e;
    h[e] = __floats2bfloat162_rn(i < n ? clip[i] : 0.0f,
                                 i + 1 < n ? clip[i + 1] : 0.0f);
  }
  reinterpret_cast<uint4*>(xb)[v] = o;
}

// Edge frames e0 .. e0 + EF - 1 of the call's B ne (ne = t_lo + T - t_hi
// a clip; frame j < t_lo of a clip is t = j, else t_hi + j - t_lo).
//   x [B, n] f32; eb [NFFT, NBIN] float2 (re, im) of the windowed f32
//   basis; band [NM, 3] (first bin, end bin, offset into wts) of the f32
//   filterbank's nonzero weights wts; bins [blo, bhi) cover every band,
//   bhi - blo <= 2 NTH.
__device__ __forceinline__ void edge_frames(
    const float* __restrict__ x, long long n, const float2* __restrict__ eb,
    const int* __restrict__ band, const float* __restrict__ wts,
    float* __restrict__ out, int B, int T, int t_lo, int t_hi, int e0,
    int blo, int bhi, unsigned char* smem) {
  float* es = reinterpret_cast<float*>(smem);  // [NFFT][EF] samples
  float* ep = es + NFFT * EF;                  // [EF][NBIN] power
  const int ne = t_lo + T - t_hi, E = B * ne, tid = threadIdx.x;
  auto frame = [&](int f, int& b, int& t) {
    const int e = e0 + f;
    b = e / ne;
    const int j = e - b * ne;
    t = j < t_lo ? j : t_hi + j - t_lo;
    return e < E;
  };
  for (int i = tid; i < EF * NFFT; i += NTH) {
    const int f = i / NFFT, k = i - f * NFFT;
    int b, t;
    float v = 0.0f;
    if (frame(f, b, t)) {
      long long s = (long long)t * HOP - PAD + k;
      s = s < 0 ? -s : (s >= n ? 2 * (n - 1) - s : s);
      v = x[(long long)b * n + s];
    }
    es[k * EF + f] = v;
  }
  __syncthreads();

  // bins fa and fb of all EF frames: re and im sums in k order (fmaf);
  // the basis of the next KU steps is loaded while the products of these
  // KU run, so that the block's eight warps hide the L2 latency
  const int fa = min(blo + tid, bhi - 1), fb = min(blo + tid + NTH, bhi - 1);
  float ar[EF], ai[EF], br[EF], bi[EF];
#pragma unroll
  for (int f = 0; f < EF; ++f) ar[f] = ai[f] = br[f] = bi[f] = 0.0f;
  const float4* es4 = reinterpret_cast<const float4*>(es);
  float2 na[KU], nb[KU];
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    na[u] = eb[(long long)u * NBIN + fa];
    nb[u] = eb[(long long)u * NBIN + fb];
  }
  for (int k0 = 0; k0 < NFFT; k0 += KU) {
    float2 ca[KU], cb[KU];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
    }
    if (k0 + KU < NFFT) {
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        na[u] = eb[(long long)(k0 + KU + u) * NBIN + fa];
        nb[u] = eb[(long long)(k0 + KU + u) * NBIN + fb];
      }
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
#pragma unroll
      for (int q = 0; q < EF / 4; ++q) {
        const float4 s = es4[(k0 + u) * (EF / 4) + q];
        const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = 4 * q + e;
          ar[f] = fmaf(sv[e], ca[u].x, ar[f]);
          ai[f] = fmaf(sv[e], ca[u].y, ai[f]);
          br[f] = fmaf(sv[e], cb[u].x, br[f]);
          bi[f] = fmaf(sv[e], cb[u].y, bi[f]);
        }
      }
    }
  }
  const bool ha = blo + tid < bhi, hb = blo + tid + NTH < bhi;
#pragma unroll
  for (int f = 0; f < EF; ++f) {
    if (ha)
      ep[f * NBIN + fa] =
          __fadd_rn(__fmul_rn(ar[f], ar[f]), __fmul_rn(ai[f], ai[f]));
    if (hb)
      ep[f * NBIN + fb] =
          __fadd_rn(__fmul_rn(br[f], br[f]), __fmul_rn(bi[f], bi[f]));
  }
  __syncthreads();

  // thread (mel, frames tid / NM + 4 q): each mel's nonzero bins in
  // ascending f, f32
  static_assert(EF * NM % NTH == 0, "whole (mel, frame) rounds");
  const int mel = tid & (NM - 1);
  const int lo = band[3 * mel], hi = band[3 * mel + 1];
  const int wo = band[3 * mel + 2] - lo;
#pragma unroll
  for (int q = 0; q < EF * NM / NTH; ++q) {
    const int f = tid / NM + q * (NTH / NM);
    int b, t;
    if (!frame(f, b, t)) continue;
    float m = 0.0f;
    for (int bin = lo; bin < hi; ++bin)
      m = __fadd_rn(m, __fmul_rn(ep[f * NBIN + bin], wts[wo + bin]));
    out[((long long)b * T + t) * NM + mel] = DB * logf(fmaxf(m, 1e-10f));
  }
}

// Blocks [0, nedge): edge frames, EF a block, first so that they run in
// the first wave beside the tiles; then block nedge + i is tile i: the
// call's interior frames NI = t_hi - t_lo a clip in a row, clip by clip,
// the tile's row r being frame p = 128 i + r of them (clip p / NI, time
// t_lo + p % NI), so that only the call's last tile is partial.
//   xb [B, npad] bf16; basis [1024 (2 NBIN) rows, NFFT] bf16, row 2f + e
//   the real (e = 0) or imaginary part of bin f, K-major; band16 / wts16
//   the bf16 filterbank's nonzero weights as f32, band order; out [B, T,
//   NM] f32.
__global__ void __launch_bounds__(NTH, 1)
    logmel_v3_kernel(const bf16* __restrict__ xb, long long npad,
                     const bf16* __restrict__ basis,
                     const int* __restrict__ band16,
                     const float* __restrict__ wts16,
                     const float* __restrict__ x, long long n,
                     const float2* __restrict__ eb,
                     const int* __restrict__ band,
                     const float* __restrict__ wts, float* __restrict__ out,
                     int B, int T, int t_lo, int t_hi, int nedge,
                     int blo, int bhi) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (base & 1023)) & 1023);
  const int blk = (int)blockIdx.x;
  if (blk < nedge) {
    edge_frames(x, n, eb, band, wts, out, B, T, t_lo, t_hi, blk * EF, blo,
                bhi, smem);
    return;
  }
  const long long p0 = (long long)(blk - nedge) * BMF;
  const int ni = t_hi - t_lo;
  const long long P = (long long)B * ni;
  unsigned char* As = smem;
  unsigned char* Bs = smem + v2::STAGES * A_STAGE;
  float* pw = reinterpret_cast<float*>(smem + RING);   // [PBIN][LDP]
  float* ms = pw + PBIN * LDP;                          // [NM][LDM]

  const int tid = threadIdx.x, wg = tid >> 7;
  for (int i = tid; i < NM * LDM; i += NTH) ms[i] = 0.0f;

  // 16-byte piece q of a stage: row (q / 8 CPR) * 8 + q % 8, chunk
  // (q / 8) % CPR, as in igemm_kernel
  constexpr int A_PT = BMF * v2::CPR / NTH, B_PT = BNC * v2::CPR / NTH;
  const unsigned char* xbb = reinterpret_cast<const unsigned char*>(xb);
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(basis);
  long long a_off[A_PT];
  int a_dst[A_PT], b_off[B_PT], b_dst[B_PT];
#pragma unroll
  for (int i = 0; i < A_PT; ++i) {
    const int q = tid + i * NTH;
    const int row = (q / (8 * v2::CPR)) * 8 + (q & 7), c = (q >> 3) % v2::CPR;
    // rows past the call's last frame read its last frame
    const long long p = min(p0 + row, P - 1), b = p / ni;
    const long long t = t_lo + (p - b * ni);
    a_off[i] = (b * npad + t * HOP - PAD) * 2 + c * 16;
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
      v2::cp_async16(as + a_dst[i], xbb + a_off[i] + kc * v2::KB);
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

    // end of pass p: the power of bins 128 p + [0, 128), rounded to bf16,
    // into pw, then each mel's in-band bins of the pass
    const int p = s / KST;
    v2::wgmma_wait<0>();
    v2::fence_acc(acc);
#pragma unroll
    for (int j = 0; j < BNC / 8; ++j) {
      const int bin = 4 * j + (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float re = acc[4 * j + 2 * h], im = acc[4 * j + 2 * h + 1];
        pw[bin * LDP + row0 + 8 * h] = __bfloat162float(__float2bfloat16_rn(
            __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im))));
      }
    }
#pragma unroll
    for (int i = 0; i < BNC / 2; ++i) acc[i] = 0.0f;
    v2::fence_acc(acc);
    __syncthreads();
    const int lo_p = p * PBIN, hi_p = lo_p + PBIN;
    for (int i = 0; i < NM / 2; ++i) {
      const int mel = 2 * i + par;
      const int lo = max(band16[3 * mel], lo_p);
      const int hi = min(band16[3 * mel + 1], hi_p);
      const int wo = band16[3 * mel + 2] - band16[3 * mel];
      float m = ms[mel * LDM + fr];
      for (int f = lo; f < hi; ++f)
        m = __fadd_rn(m, __fmul_rn(pw[(f - lo_p) * LDP + fr], wts16[wo + f]));
      ms[mel * LDM + fr] = m;
    }
    // pw is written again only 32 stages (and barriers) later
  }
  __syncthreads();
  for (int i = tid; i < BMF * NM; i += NTH) {
    const int r = i / NM, mel = i % NM;
    const long long p = p0 + r, b = p / ni;
    if (p < P)
      out[(b * T + t_lo + (p - b * ni)) * NM + mel] =
          DB * logf(fmaxf(ms[mel * LDM + r], 1e-10f));
  }
}

}  // namespace

// x [B, n] f32 waveform; xb [B, npad] bf16 scratch, npad % 8 == 0 and
// npad >= (t_hi - 1) 320 + 512; basis [1024, 1024] bf16 (interleaved re /
// im rows); band16, wts16: the bf16 filterbank's nonzero weights (band
// [64, 3] int32, f32 weights); eb [1024, 512, 2] f32 windowed basis (re,
// im); band, wts: the f32 filterbank's; bins [blo, bhi) cover every band,
// bhi - blo <= 512; out [B, T, 64] f32 (2 <= t_lo < t_hi <= T).
extern "C" int ttg_logmel_v3_v2(const float* x, int B, long long n, void* xb,
                                long long npad, int T, int t_lo, int t_hi,
                                const void* basis, const int* band16,
                                const float* wts16, const float* eb,
                                const int* band, const float* wts, int blo,
                                int bhi, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bhi - blo > 2 * NTH || t_hi <= t_lo || npad % 8)
    return (int)cudaErrorInvalidValue;
  bf16* xp = static_cast<bf16*>(xb);
  const long long nvec = (long long)B * npad / 8;
  wave_cast_kernel<<<v2::blocks_for(nvec, 256), 256, 0, st>>>(x, xp, n, npad,
                                                              nvec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  static bool configured = false;
  if (!configured) {
    e = cudaFuncSetAttribute(logmel_v3_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int ntiles = (int)(((long long)B * (t_hi - t_lo) + BMF - 1) / BMF);
  const int nedge = (B * (t_lo + T - t_hi) + EF - 1) / EF;
  logmel_v3_kernel<<<(unsigned)(nedge + ntiles), NTH, SMEM, st>>>(
      xp, npad, static_cast<const bf16*>(basis), band16, wts16, x, n,
      reinterpret_cast<const float2*>(eb), band, wts, out, B, T, t_lo, t_hi,
      nedge, blo, bhi);
  return (int)cudaGetLastError();
}
