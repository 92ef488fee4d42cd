// Fused PANNs block 1 (1 -> 64 -> 64, 2 x 2 avg+max pool) at M = 64 mels.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/conv_block1_pair.py:346
// fused_block1_pair (quantize="conv1", False or True).  The TPU kernel
// runs conv1 as one banded K=192 dot and lays conv2's operand out for the
// MXU; here the same function runs in two to four launches:
//   * conv1 on CUDA cores (K = 9 per output, 0.07 GFLOP per 10 s clip).
//     quantize="conv1" / True: x is int8 with one per-clip scale
//     max|x| / 127, computed in bf16 as the TPU path does; w1 is quantized
//     per column of the banded matrix, i.e. per (output mel, channel), so
//     the two edge mels take their scale over their 6 in-band taps only;
//     int32 sums; affine (a1 s_w) s_x, b1; ReLU.  "conv1" / False store y1
//     as bf16, with no requantize.
//   * quantize=True only: conv1 runs per time chunk of tc output frames,
//     over times [j tc - h, j tc + tc + h) (x zero outside the clip), into
//     f32 rows, with a halo h of 1 (the TPU kernel's triple staging) or 2
//     (mode="single", conv_block1_pair.py:239 _kernel_single, whose chunk
//     stages tc + 4 rows); one scale per chunk, max(y1) / 127 over all of
//     those rows,
//     also the ones outside the clip (their values come from the zero
//     padded input and the BN bias, as in the TPU kernel, whose scale
//     sees them before conv2's staging zeroes them); then y1 is
//     requantized to int8 with the chunk's scale and the out-of-clip rows
//     zeroed (conv2's zero padding).
//   * conv2 + BN + ReLU on the tensor cores (common.cuh): bf16 x bf16
//     with f32 sums, or int8 x int8 with int32 sums and the chunk's y1
//     scale in the affine; y2 rounded to bf16 and pooled in bf16, time
//     pairs then mel pairs, as the TPU kernel pools.
//
// Bound on the H100: operations (4.8 GFLOP bf16 per 10 s clip for conv2,
// 4.8 us at 989 TFLOP/s; in int8 2.4 us at 1979 TOP/s) against 2.2 MB of
// input and output, 0.7 us at 3.35 TB/s.  The y1 round trip through
// device memory (8 MB per clip each way in bf16, 16 + 4 MB in the int8
// mode) is this version's cost, not the function's.
#include "common.cuh"

namespace {

using ttg::bf16;

// per-clip scale of the int8 conv1 input, in bf16 arithmetic:
// sx = bf16(max(max|x|, bf16(1e-6)) / 127), inv = bf16(1 / sx)
__global__ void clip_scale_kernel(const bf16* __restrict__ x,
                                  float* __restrict__ sx, long long n) {
  const bf16* clip = x + blockIdx.x * n;
  float m = 0.0f;
  for (long long i = threadIdx.x; i < n; i += blockDim.x)
    m = fmaxf(m, fabsf(ttg::to_f32(clip[i])));
  m = ttg::block_max(m);
  if (threadIdx.x == 0) {
    const float mm = fmaxf(m, ttg::round_bf16(1e-6f));
    const float s = ttg::round_bf16(mm / 127.0f);
    sx[2 * blockIdx.x] = s;
    sx[2 * blockIdx.x + 1] = ttg::round_bf16(1.0f / s);
  }
}

// y1[g, r, mo, c] = relu(conv1(x)[b, t, mo, c] * mul + b1[c]) for group
// g = b * nch + j and row r of R, at time t = j * tc + r + toff (x is zero
// outside [0, T)); a block computes 8 rows of one group, thread (c,
// quarter of the mels).  The whole clip at once is nch = 1, tc = 0,
// R = T, toff = 0.
template <bool Q, typename Out>
__global__ void __launch_bounds__(256)
    conv1_kernel(const bf16* __restrict__ x, const void* __restrict__ w,
                 const float* __restrict__ alpha,
                 const float* __restrict__ beta,
                 const float* __restrict__ sx, Out* __restrict__ y1, int T,
                 int nch, int tc, int R, int toff) {
  constexpr int M = 64, C = 64, TT = 8;
  __shared__ float xs[TT + 2][M + 2];  // times t0-1 .. t0+8, mels -1 .. 64
  const int g = blockIdx.y, b = g / nch, r0 = blockIdx.x * TT;
  const int t0 = (g % nch) * tc + r0 + toff, tid = threadIdx.x;
  const float inv = Q ? sx[2 * b + 1] : 1.0f;
  for (int i = tid; i < (TT + 2) * (M + 2); i += blockDim.x) {
    const int tt = i / (M + 2), mm = i % (M + 2);
    const int t = t0 - 1 + tt, m = mm - 1;
    float v = 0.0f;
    if (t >= 0 && t < T && m >= 0 && m < M) {
      v = ttg::to_f32(x[((long long)b * T + t) * M + m]);
      if (Q) v = (float)ttg::quant_i8(v, inv);
    }
    xs[tt][mm] = v;
  }
  __syncthreads();
  const int c = tid & 63, mg = tid >> 6;
  for (int mo = mg * 16; mo < mg * 16 + 16; ++mo) {
    float wv[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      wv[k] = Q ? (float)static_cast<const int8_t*>(w)[(mo * 9 + k) * C + c]
                : ttg::to_f32(static_cast<const bf16*>(w)[k * C + c]);
    const float mul = Q ? __fmul_rn(alpha[mo * C + c], sx[2 * b]) : alpha[c];
    for (int tt = 0; tt < TT; ++tt) {
      const int r = r0 + tt;
      if (r >= R) break;
      float y;
      if (Q) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 9; ++k)
          acc += __float2int_rn(xs[tt + k / 3][mo + k % 3]) *
                 __float2int_rn(wv[k]);
        y = __fmul_rn((float)acc, mul);
      } else {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 9; ++k)
          acc = fmaf(xs[tt + k / 3][mo + k % 3], wv[k], acc);
        y = __fmul_rn(acc, mul);
      }
      y = fmaxf(__fadd_rn(y, beta[c]), 0.0f);
      ttg::store<Out>(y1 + (((long long)g * R + r) * M + mo) * C + c, y);
    }
  }
}

// One block per group g = b * nch + j of R rows of L values (y1 >= 0):
// sy[g] = max(max y1, 1e-6) / 127, y1q = round(y1 / sy) (clip at 127),
// zero for rows at times j * tc + r - halo outside [0, T).
__global__ void requant_kernel(const float* __restrict__ y1,
                               int8_t* __restrict__ y1q,
                               float* __restrict__ sy, int nch, int tc,
                               int T, int R, int L, int halo) {
  const int g = blockIdx.x, j = g % nch;
  const long long n = (long long)R * L;
  const float* src = y1 + (long long)g * n;
  float m = 0.0f;
  for (long long i = threadIdx.x; i < n; i += blockDim.x)
    m = fmaxf(m, src[i]);
  m = ttg::block_max(m);
  const float s = fmaxf(m, 1e-6f) / 127.0f, inv = 1.0f / s;
  if (threadIdx.x == 0) sy[g] = s;
  int8_t* dst = y1q + (long long)g * n;
  for (long long e = threadIdx.x; e < n; e += blockDim.x) {
    const int t = j * tc + (int)(e / L) - halo;
    dst[e] = (t >= 0 && t < T) ? ttg::quant_i8(src[e], inv) : (int8_t)0;
  }
}

}  // namespace

// x [B, T, 64] bf16 (bn0 output).  quant (1 = "conv1", 2 = True): w1
// int8 [64 mel, 9, 64] and a1 [64 mel, 64] (BN scale x weight scale);
// else w1 bf16 [9, 64] and a1 [64].  w2 [64, 9 * 64]: bf16, or int8 with
// a2 = BN scale x weight scale for quant 2.  sx [B, 2] f32 scratch;
// y1: [B, T, 64, 64] bf16 scratch, or for quant 2 [G, tc + 2, 64, 64]
// f32 (G = B ceil(T / tc)) with y1q [G, tc + 2, 64, 64] int8 and sy [G]
// f32 scratch, tc + 4 rows each for halo 2; out [B, T / 2, 32, 64] bf16.
extern "C" int ttg_conv_block1(int quant, int halo, const void* x, int B,
                               int T, int tc, const void* w1,
                               const float* a1, const float* b1,
                               const void* w2,
                               const float* a2, const float* b2, float* sx,
                               void* y1, void* y1q, float* sy, void* out,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const int nch = quant == 2 ? (T + tc - 1) / tc : 1;
  if (quant != 2) halo = 1;
  const int R = quant == 2 ? tc + 2 * halo : T;
  if (quant) clip_scale_kernel<<<B, 512, 0, st>>>(xb, sx, (long long)T * 64);
  dim3 grid1((R + 7) / 8, B * nch);
  if (quant == 2)
    conv1_kernel<true, float><<<grid1, 256, 0, st>>>(
        xb, w1, a1, b1, sx, static_cast<float*>(y1), T, nch, tc, R, -halo);
  else if (quant)
    conv1_kernel<true, bf16><<<grid1, 256, 0, st>>>(
        xb, w1, a1, b1, sx, static_cast<bf16*>(y1), T, 1, 0, T, 0);
  else
    conv1_kernel<false, bf16><<<grid1, 256, 0, st>>>(
        xb, w1, a1, b1, sx, static_cast<bf16*>(y1), T, 1, 0, T, 0);
  ttg::ConvArgs c2{};
  c2.src = y1;
  c2.wt = w2;
  c2.alpha = a2;
  c2.beta = b2;
  c2.gscale = nullptr;
  c2.dst = out;
  c2.G = B;
  c2.nch = 1;
  c2.tc = T;
  c2.T = T;
  c2.R_in = T;
  c2.R_out = (T / 2) * 2;
  c2.M = 64;
  c2.Cin = 64;
  c2.Cout = 64;
  c2.in_off = -1;
  c2.pt = 2;
  c2.pm = 2;
  c2.time_off = 0;
  c2.T_out = T / 2;
  if (quant == 2) {
    requant_kernel<<<B * nch, 512, 0, st>>>(static_cast<const float*>(y1),
                                            static_cast<int8_t*>(y1q), sy,
                                            nch, tc, T, R, 64 * 64, halo);
    c2.src = y1q;
    c2.gscale = sy;
    c2.G = B * nch;
    c2.nch = nch;
    c2.tc = tc;
    c2.R_in = R;
    c2.R_out = tc;
    c2.in_off = halo - 1;
    if (c2.T_out > 0) ttg::launch_conv<int8_t, 3>(c2, st);
  } else if (c2.R_out > 0) {
    ttg::launch_conv<bf16, 3>(c2, st);
  }
  return (int)cudaGetLastError();
}
