// Shared device code of the port's conv-block kernels (sm_90a).
//
// conv3x3_gemm: a 3x3 convolution as an implicit GEMM on the tensor cores
// (WMMA, i.e. mma.sync): output positions x output channels, K = 9 taps x
// Cin.  A 128 x 64 output tile per block of 8 warps (each warp 32 x 32 as
// 2 x 2 fragments of 16 x 16); each K step stages a [128 x KC] slice of
// the shifted input (zero outside the clip and the mel axis) and a
// [KC x 64] weight slice in shared memory.  int8 operands accumulate in
// int32 (exact), bf16 operands in f32.  Its epilogue is either the conv1
// one (folded BN affine, ReLU, out-of-clip rows zeroed) or the conv2 one
// (affine, ReLU, avg+max pool, bf16 store).
//
// gather: copies the input of every (clip, time chunk) group, with its
// time halo, into a chunk-major buffer, and for int8 quantizes it with one
// scale per group taken over a flat window of the source — the dynamic
// activation-scale contract of the TPU kernels (per clip or per chunk).
//
// Both are plain and correct first: no cp.async pipelining, no wgmma.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace ttg {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// clamp(round(v * inv), -127, 127): multiply by the f32 reciprocal, round
// half to even (jnp.round / torch.round)
__device__ __forceinline__ int8_t quant_i8(float v, float inv) {
  float q = rintf(__fmul_rn(v, inv));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

template <typename T> __device__ __forceinline__ void store(T* p, float v);
template <> __device__ __forceinline__ void store<float>(float* p, float v) {
  *p = v;
}
template <> __device__ __forceinline__ void store<bf16>(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ void store<int8_t>(int8_t* p,
                                                          float v) {
  *p = static_cast<int8_t>(v);
}

// max over the block of non-negative values; every thread gets the result
__device__ __forceinline__ float block_max(float v) {
  __shared__ float red[32];
  __shared__ float result;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    v = lane < nw ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) result = v;
  }
  __syncthreads();
  return result;
}

// One block per group g = b * nch + j.  Destination row r of the group is
// source time j * tc + r - shift of clip b (zero outside [0, T)); a row is
// L elements.  With QUANT, the group's scale is max|src| over the flat
// element window [j * win_step + win_lo, j * win_step + win_hi) of clip b
// (clipped to the clip), floored at 1e-6, over 127 — written to scale[g] —
// and the rows are stored as int8.
template <typename Ts, typename Td, bool QUANT>
__global__ void gather_kernel(const Ts* __restrict__ src, Td* __restrict__ dst,
                              float* __restrict__ scale, int nch, int T,
                              int L, int tc, int shift, int R,
                              long long win_step, long long win_lo,
                              long long win_hi) {
  const int g = blockIdx.x;
  const int b = g / nch, j = g % nch;
  const Ts* clip = src + (long long)b * T * L;
  float inv = 1.0f;
  if (QUANT) {
    const long long n = (long long)T * L;
    long long lo = j * win_step + win_lo, hi = j * win_step + win_hi;
    lo = lo < 0 ? 0 : lo;
    hi = hi > n ? n : hi;
    float m = 0.0f;
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
      m = fmaxf(m, fabsf(to_f32(clip[i])));
    m = block_max(m);
    const float s = fmaxf(m, 1e-6f) / 127.0f;
    inv = 1.0f / s;
    if (threadIdx.x == 0) scale[g] = s;
  }
  Td* out = dst + (long long)g * R * L;
  const long long total = (long long)R * L;
  for (long long e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = (int)(e / L);
    const int c = (int)(e - (long long)r * L);
    const int t = j * tc + r - shift;
    const float v =
        (t >= 0 && t < T) ? to_f32(clip[(long long)t * L + c]) : 0.0f;
    if (QUANT)
      store<Td>(out + e, (float)quant_i8(v, inv));
    else
      store<Td>(out + e, v);
  }
}

template <typename T> struct Mma;
template <> struct Mma<int8_t> {
  using frag_t = signed char;
  using acc_t = int;
  static constexpr int KC = 64;  // K elements staged per step (64 bytes)
};
template <> struct Mma<bf16> {
  using frag_t = __nv_bfloat16;
  using acc_t = float;
  static constexpr int KC = 32;
};

struct ConvArgs {
  const void* src;      // [G, R_in, M, Cin]
  const void* wt;       // [Cout, 9 * Cin], k = (dt * 3 + dm) * Cin + ci
  const float* alpha;   // [Cout] folded BN scale (x weight scale for int8)
  const float* beta;    // [Cout] folded BN shift
  const float* gscale;  // [G] activation scale of the group, or null
  void* dst;
  int G, nch, tc, T;    // groups, groups per clip, chunk length, clip length
  int R_in, R_out, M, Cin, Cout;
  int in_off;           // input row of output row r at time tap dt
  int pt, pm;           // pool window; (1, 1) for the conv1 epilogue
  int time_off;         // conv1: time of row r of group (b, j) is
                        //   j * tc + r + time_off; zero outside [0, T)
  int T_out;            // conv2: pooled time rows per clip in dst
};

constexpr int BM = 128, BN = 64, NT = 256;

template <typename T>
using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                       typename Mma<T>::acc_t>;

// One staged K step of a BM x BN tile on the tensor cores: acc += A B^T
// over the step's KC elements, A in As as KC / 16 slices of [a_rows][16]
// (the tile's rows first) and B^T in Bs as slices of [BN][16] (row-major,
// 16 elements a row); warp (wm, wn) of the 4 x 2 warps owns rows wm * 32
// and columns wn * 32 as 2 x 2 fragments.
template <typename T>
__device__ __forceinline__ void mma_step(const unsigned char* As,
                                         const unsigned char* Bs,
                                         AccFrag<T> (&acc)[2][2], int wm,
                                         int wn, int a_rows = BM) {
  using namespace nvcuda;
  using FT = typename Mma<T>::frag_t;
  constexpr int SLAB = 16 * sizeof(T), NKS = Mma<T>::KC / 16;
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, FT, wmma::row_major> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, FT, wmma::col_major> fb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(
          fa[i],
          reinterpret_cast<const FT*>(As + ks * a_rows * SLAB +
                                      (wm * 32 + i * 16) * SLAB),
          16);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(
          fb[j],
          reinterpret_cast<const FT*>(Bs + ks * BN * SLAB +
                                      (wn * 32 + j * 16) * SLAB),
          16);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

// the tile's sums into Cs [BM][ldc] in shared memory
template <typename T>
__device__ __forceinline__ void store_acc(typename Mma<T>::acc_t* Cs,
                                          AccFrag<T> (&acc)[2][2], int ldc,
                                          int wm, int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(
          Cs + (wm * 32 + i * 16) * ldc + wn * 32 + j * 16, acc[i][j], ldc,
          nvcuda::wmma::mem_row_major);
}

// output position p -> (group, row, mel), enumerated pool window major so
// that a tile holds whole pool windows
struct Pos {
  long long g;
  int r, m;
};

__device__ __forceinline__ Pos decode(long long p, const ConvArgs& a) {
  const int win = a.pt * a.pm;
  const int Mo = a.M / a.pm, Ro = a.R_out / a.pt;
  const long long w = p / win;
  const int ii = (int)(p - w * win);
  const long long g = w / ((long long)Ro * Mo);
  const int rem = (int)(w - g * Ro * Mo);
  Pos q;
  q.g = g;
  q.r = (rem / Mo) * a.pt + ii / a.pm;
  q.m = (rem % Mo) * a.pm + ii % a.pm;
  return q;
}

// MODE 0: conv1 epilogue, f32 rows; 1: conv1 epilogue, bf16 rows;
// 2: conv2 epilogue, f32 pool (mel pairs, then time pairs);
// 3: conv2 epilogue, y rounded to bf16 and pooled in bf16 (time pairs,
//    then mel pairs) — block 1's order.
template <typename T, int MODE>
__global__ void __launch_bounds__(NT) conv3x3_gemm(ConvArgs a) {
  using namespace nvcuda;
  using AT = typename Mma<T>::acc_t;
  constexpr int KC = Mma<T>::KC;
  constexpr int ES = sizeof(T);
  constexpr int SLAB = 16 * ES;          // bytes of 16 k-elements of a row
  constexpr int NKS = KC / 16;           // 16-wide k slices per step
  constexpr int A_BYTES = NKS * BM * SLAB;
  constexpr int LDC = BN + 4;
  __shared__ __align__(128) unsigned char smem[BM * LDC * 4];
  unsigned char* As = smem;              // [NKS][BM][16] row-major slices
  unsigned char* Bs = smem + A_BYTES;    // [NKS][BN][16] (B^T) slices
  AT* Cs = reinterpret_cast<AT*>(smem);  // [BM][LDC] after the K loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const long long p0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long P = (long long)a.G * a.R_out * a.M;
  const int Ktot = 9 * a.Cin;
  const T* src = static_cast<const T*>(a.src);
  const T* wt = static_cast<const T*>(a.wt);

  // each thread stages two 16-byte pieces of A rows and one of B per step
  int rowA[2], qA[2], rA[2], mA[2];
  long long gA[2];
  bool okA[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * NT;
    rowA[i] = idx >> 2;
    qA[i] = idx & 3;
    const long long p = p0 + rowA[i];
    okA[i] = p < P;
    const Pos q = decode(okA[i] ? p : 0, a);
    gA[i] = q.g;
    rA[i] = q.r;
    mA[i] = q.m;
  }
  const int nB = tid >> 2, qB = tid & 3;

  AccFrag<T> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], (AT)0);

  for (int tap = 0; tap < 9; ++tap) {
    const int dt = tap / 3, dm = tap % 3;
    for (int c0 = 0; c0 < a.Cin; c0 += KC) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        const int ri = rA[i] + dt + a.in_off, mi = mA[i] + dm - 1;
        if (okA[i] && ri >= 0 && ri < a.R_in && mi >= 0 && mi < a.M) {
          const T* row =
              src + ((gA[i] * a.R_in + ri) * a.M + mi) * (long long)a.Cin +
              c0;
          v = *reinterpret_cast<const uint4*>(
              reinterpret_cast<const unsigned char*>(row) + qA[i] * 16);
        }
        const int ks = (qA[i] * 16) / SLAB, part = (qA[i] * 16) % SLAB;
        *reinterpret_cast<uint4*>(As + ks * BM * SLAB + rowA[i] * SLAB +
                                  part) = v;
      }
      {
        const T* col = wt + (long long)(n0 + nB) * Ktot + tap * a.Cin + c0;
        const uint4 v = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const unsigned char*>(col) + qB * 16);
        const int ks = (qB * 16) / SLAB, part = (qB * 16) % SLAB;
        *reinterpret_cast<uint4*>(Bs + ks * BN * SLAB + nB * SLAB + part) =
            v;
      }
      __syncthreads();
      mma_step<T>(As, Bs, acc, wm, wn);
      __syncthreads();
    }
  }

  store_acc<T>(Cs, acc, LDC, wm, wn);
  __syncthreads();

  if constexpr (MODE == 0 || MODE == 1) {
    using Td = typename std::conditional<MODE == 0, float, bf16>::type;
    Td* dst = static_cast<Td*>(a.dst);
    for (int idx = tid; idx < BM * BN; idx += NT) {
      const int row = idx / BN, c = idx % BN;
      const long long p = p0 + row;
      if (p >= P) continue;
      const long long g = p / ((long long)a.R_out * a.M);
      const int r = (int)((p / a.M) % a.R_out);
      const int t = (int)(g % a.nch) * a.tc + r + a.time_off;
      const int n = n0 + c;
      const float mul =
          a.gscale ? __fmul_rn(a.alpha[n], a.gscale[g]) : a.alpha[n];
      float y = __fadd_rn(__fmul_rn((float)Cs[row * LDC + c], mul), a.beta[n]);
      y = (t >= 0 && t < a.T) ? fmaxf(y, 0.0f) : 0.0f;
      store<Td>(dst + p * a.Cout + n, y);
    }
  } else {
    bf16* dst = static_cast<bf16*>(a.dst);
    const int win = a.pt * a.pm;
    const int Mo = a.M / a.pm, Ro = a.R_out / a.pt;
    const int nwin = BM / win;
    for (int idx = tid; idx < nwin * BN; idx += NT) {
      const int wi = idx / BN, c = idx % BN;
      const long long pf = p0 + (long long)wi * win;
      if (pf >= P) continue;
      const long long w = pf / win;
      const long long g = w / ((long long)Ro * Mo);
      const int rem = (int)(w - g * Ro * Mo);
      const int ro = rem / Mo, mo = rem % Mo;
      const int n = n0 + c;
      const float mul =
          a.gscale ? __fmul_rn(a.alpha[n], a.gscale[g]) : a.alpha[n];
      float v[2][2];
      for (int di = 0; di < a.pt; ++di)
        for (int dj = 0; dj < a.pm; ++dj) {
          const int row = wi * win + di * a.pm + dj;
          float y = __fadd_rn(__fmul_rn((float)Cs[row * LDC + c], mul),
                              a.beta[n]);
          y = fmaxf(y, 0.0f);
          v[di][dj] = MODE == 3 ? round_bf16(y) : y;
        }
      float out;
      if constexpr (MODE == 2) {
        float s[2], mx[2];
        for (int di = 0; di < a.pt; ++di) {
          s[di] = a.pm == 2 ? __fadd_rn(v[di][0], v[di][1]) : v[di][0];
          mx[di] = a.pm == 2 ? fmaxf(v[di][0], v[di][1]) : v[di][0];
        }
        const float S = a.pt == 2 ? __fadd_rn(s[0], s[1]) : s[0];
        const float MX = a.pt == 2 ? fmaxf(mx[0], mx[1]) : mx[0];
        out = __fadd_rn(__fmul_rn(S, 1.0f / (float)win), MX);
      } else {
        const float s0 = round_bf16(__fadd_rn(v[0][0], v[1][0]));
        const float s1 = round_bf16(__fadd_rn(v[0][1], v[1][1]));
        const float mx = fmaxf(fmaxf(v[0][0], v[1][0]), fmaxf(v[0][1], v[1][1]));
        const float S = round_bf16(__fadd_rn(s0, s1));
        out = round_bf16(__fadd_rn(round_bf16(__fmul_rn(S, 0.25f)), mx));
      }
      const int b = (int)(g / a.nch), j = (int)(g % a.nch);
      const int tout = (j * a.tc + ro * a.pt) / a.pt;
      if (tout >= a.T_out) continue;  // past the clip (ragged last chunk)
      dst[(((long long)b * a.T_out + tout) * Mo + mo) * a.Cout + n] =
          __float2bfloat16_rn(out);
    }
  }
}

template <typename T, int MODE>
inline void launch_conv(const ConvArgs& a, cudaStream_t st) {
  const long long P = (long long)a.G * a.R_out * a.M;
  dim3 grid((unsigned)((P + BM - 1) / BM), (unsigned)(a.Cout / BN));
  conv3x3_gemm<T, MODE><<<grid, NT, 0, st>>>(a);
}

// Requantizes each group's conv1 rows y1 [G, tc + 2, M, C] (f32, or
// bf16 with y1_half) with one scale over all its rows into y1q int8, the
// scale to sy [G].
inline void requant_y1(bool y1_half, const void* y1, int8_t* y1q, float* sy,
                       int G, int tc, int M, int C, cudaStream_t st) {
  const long long n = (long long)(tc + 2) * M * C;
  if (y1_half)
    gather_kernel<bf16, int8_t, true><<<G, 512, 0, st>>>(
        static_cast<const bf16*>(y1), y1q, sy, 1, tc + 2, M * C, 0, 0,
        tc + 2, 0, 0, n);
  else
    gather_kernel<float, int8_t, true><<<G, 512, 0, st>>>(
        static_cast<const float*>(y1), y1q, sy, 1, tc + 2, M * C, 0, 0,
        tc + 2, 0, 0, n);
}

// The second half of a chunked block: y1 [G, tc + 2, M, C] holds the
// conv1 rows of group g = b * nch + j at times [j tc - 1, j tc + tc + 1),
// zero outside the clip: f32 for quant (bf16 with y1_half), bf16
// otherwise.  quant: requant_y1 into y1q and sy; then conv2 -> BN ->
// ReLU -> f32 avg+max pool into out [B, T / pt, M / pm, C] bf16.
inline cudaError_t conv2_pool(bool quant, bool y1_half, const void* y1,
                              int8_t* y1q, float* sy, int B, int nch, int T,
                              int M, int C, int tc, int pt, int pm,
                              const void* w2, const float* a2,
                              const float* b2, bf16* out, cudaStream_t st) {
  const int G = B * nch;
  const void* src = y1;
  if (quant) {
    requant_y1(y1_half, y1, y1q, sy, G, tc, M, C, st);
    src = y1q;
  }
  ConvArgs c{};
  c.src = src;
  c.wt = w2;
  c.alpha = a2;
  c.beta = b2;
  c.gscale = quant ? sy : nullptr;
  c.dst = out;
  c.G = G;
  c.nch = nch;
  c.tc = tc;
  c.T = T;
  c.R_in = tc + 2;
  c.R_out = tc;
  c.M = M;
  c.Cin = C;
  c.Cout = C;
  c.in_off = 0;
  c.pt = pt;
  c.pm = pm;
  c.time_off = 0;
  c.T_out = T / pt;
  if (quant)
    launch_conv<int8_t, 2>(c, st);
  else
    launch_conv<bf16, 2>(c, st);
  return cudaGetLastError();
}

// The first half of a chunked block, in direct 3x3 taps: gathers the
// input of every group with its two-time halo into xs [G, tc + 4, M, Cin]
// (int8 with quant, its scale to sx [G] taken over the flat element window
// [j * win_step + win_lo, j * win_step + win_hi) of clip b), then conv1 ->
// BN -> ReLU into y1 [G, tc + 2, M, Cout] (f32 for quant without y1_half,
// bf16 otherwise), rows outside the clip zeroed.
inline void conv1_direct(bool quant, bool y1_half, const bf16* x, int B,
                         int T, int M, int Cin, int Cout, int tc,
                         long long win_step, long long win_lo,
                         long long win_hi, const void* w1, const float* a1,
                         const float* b1, void* xs, void* y1, float* sx,
                         cudaStream_t st) {
  const int nch = (T + tc - 1) / tc, G = B * nch;  // last chunk ragged
  if (quant)
    gather_kernel<bf16, int8_t, true><<<G, 512, 0, st>>>(
        x, static_cast<int8_t*>(xs), sx, nch, T, M * Cin, tc, 2, tc + 4,
        win_step, win_lo, win_hi);
  else
    gather_kernel<bf16, bf16, false><<<G, 512, 0, st>>>(
        x, static_cast<bf16*>(xs), nullptr, nch, T, M * Cin, tc, 2, tc + 4,
        0, 0, 0);
  ConvArgs c1{};
  c1.src = xs;
  c1.wt = w1;
  c1.alpha = a1;
  c1.beta = b1;
  c1.gscale = quant ? sx : nullptr;
  c1.dst = y1;
  c1.G = G;
  c1.nch = nch;
  c1.tc = tc;
  c1.T = T;
  c1.R_in = tc + 4;
  c1.R_out = tc + 2;
  c1.M = M;
  c1.Cin = Cin;
  c1.Cout = Cout;
  c1.in_off = 0;
  c1.pt = 1;
  c1.pm = 1;
  c1.time_off = -1;
  c1.T_out = 0;
  if (quant && !y1_half)
    launch_conv<int8_t, 0>(c1, st);
  else if (quant)
    launch_conv<int8_t, 1>(c1, st);
  else
    launch_conv<bf16, 1>(c1, st);
}

// The fused block of the TPU kernels: conv3x3 -> BN -> ReLU -> conv3x3 ->
// BN -> ReLU -> avg+max pool over chunks of tc output times.
//   x   [B, T, M, Cin] bf16; the last chunk may be ragged
//   w1  [Cout, 9 Cin], w2 [Cout, 9 Cout]: int8 (quant) or bf16
//   a*, b*: [Cout] f32 (int8: BN scale x per-channel weight scale)
//   xs  [G, tc + 4, M, Cin] scratch, int8 or bf16 (G = B ceil(T / tc))
//   y1  [G, tc + 2, M, Cout] scratch, f32 (quant) or bf16 (also for
//       quant with y1_half)
//   y1q [G, tc + 2, M, Cout] int8 scratch (quant only)
//   sx, sy [G] f32 scratch: per-group activation scales (quant only)
//   out [B, T / pt, M / pm, Cout] bf16
// The x scale of group (b, j) is taken over the flat element window
// [j * win_step + win_lo, j * win_step + win_hi) of clip b; the y1 scale
// over the group's conv1 rows (times [j tc - 1, j tc + tc + 1), zeroed
// outside the clip), as f32 or, with y1_half, rounded to bf16 first.
inline cudaError_t double_conv(bool quant, const bf16* x, int B, int T,
                               int M, int Cin, int Cout, int tc, int pt,
                               int pm, long long win_step, long long win_lo,
                               long long win_hi, const void* w1,
                               const float* a1, const float* b1,
                               const void* w2, const float* a2,
                               const float* b2, void* xs, void* y1,
                               int8_t* y1q, float* sx, float* sy, bf16* out,
                               cudaStream_t st, bool y1_half = false) {
  conv1_direct(quant, y1_half, x, B, T, M, Cin, Cout, tc, win_step, win_lo,
               win_hi, w1, a1, b1, xs, y1, sx, st);
  return conv2_pool(quant, y1_half, y1, y1q, sy, B, (T + tc - 1) / tc, T, M,
                    Cout, tc, pt, pm, w2, a2, b2, out, st);
}

}  // namespace ttg
