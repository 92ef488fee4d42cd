// Winograd F(2 x 2, 3 x 3) PANNs block: (conv3x3 -> BN -> ReLU) x 2 -> 2 x 2
// avg+max pool.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/conv_block_wino.py:264
// fused_block_wino.  Each conv is y = A^T [U_k (.) V_k] A over 2 x 2 output
// tiles with U_k = G w G^T (prepared by the wrapper) and V_k = B^T d B, 16
// pointwise products [tiles, Cin] x [Cin, Cout].  Per conv, three launches:
//   * transform: one block per (group g = (clip, time chunk), k) computes
//     V_k over the group's tiles in f32 in the butterfly's order of
//     additions, zero outside the clip and the mel axis.  int8: a first
//     pass takes sv = max(max|V_k|, 1e-6) / 127 over the group (halo tiles
//     included), a second stores round(V_k / sv) as int8; bf16: V_k
//     rounded to bf16;
//   * products: the 16 GEMMs on the tensor cores (common.cuh's tile), int8
//     x int8 into int32 scaled by sv * su[k, cout], or bf16 x bf16 into
//     f32, each M_k written to device memory in f32;
//   * output transform: the two-stage A^T M A in the TPU kernel's order,
//     BN (multiply, then add) and ReLU; conv1's rows outside the clip
//     zeroed and stored in bf16 as chunk rows [G, tc + 4, M, Cout] (times
//     t0 - 2 .. t0 + tc + 1) for conv2's transform; conv2's outputs pooled
//     as (z00 + z01 + z10 + z11) * 0.25 + max and stored in bf16.
//
// Bound on the H100: the Winograd products' operations, 2 * 16 * Cin *
// Cout per 2 x 2 output tile and conv (16 / 36 of the direct conv's), in
// int8 1979 TOP/s, against the input and output bytes; the int8 result is
// fixed by the per-(k, chunk) scales of V_k, so a direct conv does not
// compute it.  This version loses far more than the cut in multiplies by
// writing V_k (1 or 2 bytes) and M_k (4 bytes) for every tile and k to
// device memory and reading them again.
#include "common.cuh"

namespace {

using ttg::bf16;

// the butterfly's rows: s = d[xa] (+/-) d[xb] (conv_block_wino.py:99)
__constant__ int kXA[4] = {0, 1, 2, 1};
__constant__ int kXB[4] = {2, 2, 1, 3};
__constant__ float kSG[4] = {-1.0f, 1.0f, -1.0f, -1.0f};

__device__ __forceinline__ float comb(float a, float b, float sign) {
  return sign > 0.0f ? __fadd_rn(a, b) : __fsub_rn(a, b);
}

struct Src {
  const bf16* p;   // [groups, rows, M, C]
  int rows;        // rows per source group (zero outside [0, rows))
  int per_clip;    // 1: source group = g / nch, first row (g % nch) tc + off
  int off;         //    0: source group = g, first row off
};

// V_k at tile row r (u = r / mp, mel pair bb = r % mp), channel c of group
// g: the 4 inputs of tap (i, j) in d = src(row0 + 2 u + x, 2 bb + y - 1)
__device__ __forceinline__ float wino_v(const Src& s, int g, int nch, int tc,
                                        int M, int C, int k, int r, int c) {
  const int mp = M / 2, u = r / mp, bb = r % mp, i = k >> 2, j = k & 3;
  const int sg = s.per_clip ? g / nch : g;
  const int row0 = (s.per_clip ? (g % nch) * tc : 0) + s.off + 2 * u;
  const int mel0 = 2 * bb - 1;
  const bf16* base = s.p + (long long)sg * s.rows * M * C + c;
  auto at = [&](int x, int y) -> float {
    const int t = row0 + x, m = mel0 + y;
    return (t >= 0 && t < s.rows && m >= 0 && m < M)
               ? ttg::to_f32(base[((long long)t * M + m) * C])
               : 0.0f;
  };
  const float si = kSG[i], sj = kSG[j];
  const float a = comb(at(kXA[i], kXA[j]), at(kXB[i], kXA[j]), si);
  const float b = comb(at(kXA[i], kXB[j]), at(kXB[i], kXB[j]), si);
  return comb(a, b, sj);
}

// v [16, G * R, C]: V_k of group g's R tiles; sv [16, G] (int8 only)
template <bool QUANT>
__global__ void __launch_bounds__(256)
    wino_transform(Src s, void* __restrict__ v, float* __restrict__ sv,
                   int G, int nch, int tc, int M, int C, int R) {
  const int g = blockIdx.x, k = blockIdx.y;
  const long long n = (long long)R * C;
  const long long out0 = ((long long)k * G + g) * n;
  if constexpr (QUANT) {
    float m = 0.0f;
    for (long long e = threadIdx.x; e < n; e += blockDim.x)
      m = fmaxf(m, fabsf(wino_v(s, g, nch, tc, M, C, k, (int)(e / C),
                                (int)(e % C))));
    m = ttg::block_max(m);
    const float scale = fmaxf(m, 1e-6f) / 127.0f, inv = 1.0f / scale;
    if (threadIdx.x == 0) sv[k * G + g] = scale;
    int8_t* dst = static_cast<int8_t*>(v) + out0;
    for (long long e = threadIdx.x; e < n; e += blockDim.x)
      dst[e] = ttg::quant_i8(
          wino_v(s, g, nch, tc, M, C, k, (int)(e / C), (int)(e % C)), inv);
  } else {
    bf16* dst = static_cast<bf16*>(v) + out0;
    for (long long e = threadIdx.x; e < n; e += blockDim.x)
      dst[e] = __float2bfloat16_rn(
          wino_v(s, g, nch, tc, M, C, k, (int)(e / C), (int)(e % C)));
  }
}

// mout[k, p, n] = sum_c v[k, p, c] u[k, n, c] for the P = G R tile rows:
// int8 scaled by sv[k, p / R] su[k, n], or bf16 with f32 sums
template <typename T>
__global__ void __launch_bounds__(ttg::NT)
    wino_gemm(const T* __restrict__ v, const T* __restrict__ u,
              const float* __restrict__ sv, const float* __restrict__ su,
              float* __restrict__ mout, long long P, int R, int G, int K,
              int N) {
  using namespace nvcuda;
  using AT = typename ttg::Mma<T>::acc_t;
  constexpr int BM = ttg::BM, BN = ttg::BN, NT = ttg::NT;
  constexpr int KC = ttg::Mma<T>::KC, SLAB = 16 * sizeof(T);
  constexpr int A_BYTES = (KC / 16) * BM * SLAB, LDC = BN + 4;
  __shared__ __align__(128) unsigned char smem[BM * LDC * 4];
  unsigned char* As = smem;
  unsigned char* Bs = smem + A_BYTES;
  AT* Cs = reinterpret_cast<AT*>(smem);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2, k = blockIdx.z;
  const long long p0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const T* a = v + (long long)k * P * K;
  const T* b = u + (long long)k * N * K;

  ttg::AccFrag<T> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], (AT)0);

  for (int c0 = 0; c0 < K; c0 += KC) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * NT, row = idx >> 2, q = idx & 3;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (p0 + row < P)
        val = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const unsigned char*>(a + (p0 + row) * K + c0) +
            q * 16);
      *reinterpret_cast<uint4*>(As + (q * 16) / SLAB * BM * SLAB +
                                row * SLAB + (q * 16) % SLAB) = val;
    }
    {
      const int nb = tid >> 2, q = tid & 3;
      const uint4 val = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const unsigned char*>(
              b + (long long)(n0 + nb) * K + c0) +
          q * 16);
      *reinterpret_cast<uint4*>(Bs + (q * 16) / SLAB * BN * SLAB +
                                nb * SLAB + (q * 16) % SLAB) = val;
    }
    __syncthreads();
    ttg::mma_step<T>(As, Bs, acc, wm, wn);
    __syncthreads();
  }
  ttg::store_acc<T>(Cs, acc, LDC, wm, wn);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += NT) {
    const int row = idx / BN, c = idx % BN;
    const long long p = p0 + row;
    if (p >= P) continue;
    const int n = n0 + c;
    float y = (float)Cs[row * LDC + c];
    if constexpr (std::is_same<T, int8_t>::value)
      y = __fmul_rn(y, __fmul_rn(sv[k * G + (int)(p / R)], su[k * N + n]));
    mout[((long long)k * P + p) * N + n] = y;
  }
}

// One thread per (tile row p of the P = G R, channel n): the output
// transform of the 16 M_k (conv_block_wino.py:203-210), then conv1's BN,
// ReLU and clip mask into the bf16 chunk rows y1 [G, tc + 4, M, N], or
// conv2's BN, ReLU and pool into out [B, T / 2, M / 2, N].
template <bool CONV1>
__global__ void __launch_bounds__(256)
    wino_output(const float* __restrict__ mm, const float* __restrict__ alpha,
                const float* __restrict__ beta, bf16* __restrict__ dst,
                long long P, int R, int nch, int tc, int T, int M, int N) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P * N) return;
  const int n = (int)(e % N);
  const long long p = e / N;
  const int g = (int)(p / R), r = (int)(p % R), mp = M / 2;
  const int u = r / mp, bb = r % mp;
  float m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = mm[((long long)k * P + p) * N + n];
  float s0[4], s1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s0[j] = __fadd_rn(__fadd_rn(m[j], m[4 + j]), m[8 + j]);
    s1[j] = __fsub_rn(__fsub_rn(m[4 + j], m[8 + j]), m[12 + j]);
  }
  float y[2][2];
  const float* sp[2] = {s0, s1};
#pragma unroll
  for (int tau = 0; tau < 2; ++tau) {
    y[tau][0] = __fadd_rn(__fadd_rn(sp[tau][0], sp[tau][1]), sp[tau][2]);
    y[tau][1] = __fsub_rn(__fsub_rn(sp[tau][1], sp[tau][2]), sp[tau][3]);
  }
  const float a = alpha[n], b = beta[n];
#pragma unroll
  for (int tau = 0; tau < 2; ++tau)
#pragma unroll
    for (int mu = 0; mu < 2; ++mu)
      y[tau][mu] = fmaxf(__fadd_rn(__fmul_rn(y[tau][mu], a), b), 0.0f);
  const int j = g % nch;
  if constexpr (CONV1) {
#pragma unroll
    for (int tau = 0; tau < 2; ++tau) {
      const int t = j * tc - 2 + 2 * u + tau;
      const bool ok = t >= 0 && t < T;
#pragma unroll
      for (int mu = 0; mu < 2; ++mu)
        dst[(((long long)g * (tc + 4) + 2 * u + tau) * M + 2 * bb + mu) * N +
            n] = __float2bfloat16_rn(ok ? y[tau][mu] : 0.0f);
    }
  } else {
    const int tout = j * (tc / 2) + u;
    if (tout >= T / 2) return;
    const float s =
        __fadd_rn(__fadd_rn(__fadd_rn(y[0][0], y[0][1]), y[1][0]), y[1][1]);
    const float mx = fmaxf(fmaxf(y[0][0], y[0][1]), fmaxf(y[1][0], y[1][1]));
    dst[(((long long)(g / nch) * (T / 2) + tout) * mp + bb) * N + n] =
        __float2bfloat16_rn(__fadd_rn(__fmul_rn(s, 0.25f), mx));
  }
}

template <typename T>
void conv(bool quant, Src s, int G, int nch, int tc, int M, int Cin,
          int Cout, int R, const void* u, const float* su, void* v,
          float* sv, float* mbuf, cudaStream_t st) {
  const long long P = (long long)G * R;
  dim3 tgrid(G, 16);
  if (quant)
    wino_transform<true><<<tgrid, 256, 0, st>>>(s, v, sv, G, nch, tc, M, Cin,
                                                R);
  else
    wino_transform<false><<<tgrid, 256, 0, st>>>(s, v, sv, G, nch, tc, M,
                                                 Cin, R);
  dim3 ggrid((unsigned)((P + ttg::BM - 1) / ttg::BM), Cout / ttg::BN, 16);
  wino_gemm<T><<<ggrid, ttg::NT, 0, st>>>(static_cast<const T*>(v),
                                          static_cast<const T*>(u), sv, su,
                                          mbuf, P, R, G, Cin, Cout);
}

}  // namespace

// x [B, T, M, Cin] bf16 (M even); the clip is zero-padded to tpad, a
// multiple of the even chunk tc.  u1 [16, Cout, Cin], u2 [16, Cout, Cout]:
// int8 with su1 / su2 [16, Cout] (quant) or bf16; a / b [Cout] f32 BN
// affines.  Scratch: v [16, G max(R1 Cin, R2 Cout)] int8 or bf16, sv
// [2, 16, G] f32, mbuf [16, G R1, Cout] f32, y1 [G, tc + 4, M, Cout] bf16
// with G = B tpad / tc, R1 = (tc / 2 + 2) M / 2, R2 = tc / 2 * M / 2.
// out [B, T / 2, M / 2, Cout] bf16.
extern "C" int ttg_conv_block_wino(int quant, const void* x, int B, int T,
                                   int M, int Cin, int Cout, int tc,
                                   int tpad, const void* u1,
                                   const float* su1, const float* a1,
                                   const float* b1, const void* u2,
                                   const float* su2, const float* a2,
                                   const float* b2, void* v, float* sv,
                                   float* mbuf, void* y1, void* out,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = tpad / tc, G = B * nch, mp = M / 2;
  const int R1 = (tc / 2 + 2) * mp, R2 = tc / 2 * mp;
  bf16* y1b = static_cast<bf16*>(y1);
  // conv1: tiles at times t0 - 2 + 2u, inputs from t0 - 3 (zero past T)
  const Src s1{static_cast<const bf16*>(x), T, 1, -3};
  // conv2: y1's chunk rows, tile u's inputs from row 2u + 1
  const Src s2{y1b, tc + 4, 0, 1};
  const long long P1 = (long long)G * R1, P2 = (long long)G * R2;
  if (quant)
    conv<int8_t>(true, s1, G, nch, tc, M, Cin, Cout, R1, u1, su1, v, sv,
                 mbuf, st);
  else
    conv<bf16>(false, s1, G, nch, tc, M, Cin, Cout, R1, u1, su1, v, sv,
               mbuf, st);
  wino_output<true><<<(unsigned)((P1 * Cout + 255) / 256), 256, 0, st>>>(
      mbuf, a1, b1, y1b, P1, R1, nch, tc, T, M, Cout);
  if (quant)
    conv<int8_t>(true, s2, G, nch, tc, M, Cout, Cout, R2, u2, su2, v,
                 sv + 16 * G, mbuf, st);
  else
    conv<bf16>(false, s2, G, nch, tc, M, Cout, Cout, R2, u2, su2, v,
               sv + 16 * G, mbuf, st);
  wino_output<false><<<(unsigned)((P2 * Cout + 255) / 256), 256, 0, st>>>(
      mbuf, a2, b2, static_cast<bf16*>(out), P2, R2, nch, tc, T, M, Cout);
  return (int)cudaGetLastError();
}
