// Train-mode BatchNorm -> ReLU -> avg + max pool, forward and closed-form
// backward (sm_90a).
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/bn_pool.py:376
// bn_relu_dual_pool (forward :123, backward :240).  x [B, T, M, C]
// channel-last, f32 or bf16; the batch statistics (f32, over B, T, M) come
// from plain reductions in the wrapper, as the JAX wrapper takes them from
// XLA.  Window (pt, 2) = stride, pt in {1, 2}, floor pooling over T.
//
// Forward, one pass: h = relu(x sc + sh) in f32 (sc = gamma rsqrt(var +
// eps), sh = beta - mean sc), out = avg_pool(h) + max_pool(h) rounded once
// to x's type.
//
// Backward, one entry point, three launches:
//  1. route: one pass over (x, g) recomputes n = (x - mean) inv and h =
//     relu(n gamma + beta), routes each window's gradient (g / K plus g at
//     the first maximal element in window order (dt, dm), 0 where h = 0),
//     writes ac dz (ac = gamma inv) in x's type and per-block partial sums
//     s1 = sum dz and s2 = sum dz n of its windows;
//  2. reduce: the partials summed per channel in a fixed order (no float
//     atomics: every run gives the same bits); dbeta = s1, dgamma = s2 and
//     the correction terms c1 = ac (s1 / N), c2 = ac (s2 / N), N = B T M
//     over the full T;
//  3. apply: dx = ac dz - c1 - n c2 over the whole of x, in place over ac dz
//     (the rows floor pooling drops have dz = 0 and get -c1 - n c2).
//
// The TPU kernel packs block 1's 64 channels two mels to a 128-lane row (a
// TPU layout device); here one thread takes one window and 16 bytes of
// channels at every geometry.  Bound on the H100: bytes (x read once and a
// quarter or half of it written forward; x and g read, dx written, and
// the ac dz intermediate written and read again backward).
#include "pool_window.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, int PT>
__global__ void __launch_bounds__(THREADS)
    bn_pool_fwd(const T* __restrict__ x, const float* __restrict__ sc,
                const float* __restrict__ sh, T* __restrict__ out, int B,
                int Tn, int M, int C) {
  constexpr int V = pool::Vec<T>::N, K = 2 * PT;
  const int cv = C / V, m2 = M / 2, tos = Tn / PT;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * tos * m2 * cv) return;
  int b, to, mo, c;
  pool::split(i, cv, V, m2, tos, b, to, mo, c);
  float a[V], s[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = sc[c + j];
    s[j] = sh[c + j];
  }
  float e[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    pool::load16(x + pool::elem_offset(b, to, mo, k, PT, Tn, M, C, c), e[k]);
#pragma unroll
    for (int j = 0; j < V; ++j)
      e[k][j] = fmaxf(__fadd_rn(__fmul_rn(e[k][j], a[j]), s[j]), 0.0f);
  }
  float o[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = e[k][j];
    o[j] = pool::window_out<K>(w);
  }
  pool::store16(out + (size_t)i * V, o);
}

// prm [5][C]: mean, inv, gamma, beta, ac.  Block (cv, R): thread (tx, ty)
// takes channels tx V .. tx V + V - 1 of windows w0 + ty, w0 + ty + R, ...
// of the block's wpb windows, and the block's partials are summed over ty
// in a fixed order: part[blk][0][c] = s1, part[blk][1][c] = s2.
template <typename T, int PT>
__global__ void __launch_bounds__(THREADS)
    bn_pool_route(const T* __restrict__ x, const T* __restrict__ g,
                  const float* __restrict__ prm, T* __restrict__ dz,
                  float* __restrict__ part, int B, int Tn, int M, int C,
                  int wpb) {
  constexpr int V = pool::Vec<T>::N, K = 2 * PT;
  __shared__ float red[2 * THREADS * V];
  const int cv = C / V, m2 = M / 2, tos = Tn / PT, R = blockDim.y;
  const int c = threadIdx.x * V;
  float mu[V], iv[V], ga[V], be[V], ac[V], s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mu[j] = prm[c + j];
    iv[j] = prm[C + c + j];
    ga[j] = prm[2 * C + c + j];
    be[j] = prm[3 * C + c + j];
    ac[j] = prm[4 * C + c + j];
    s1[j] = s2[j] = 0.0f;
  }
  const long long nwin = (long long)B * tos * m2;
  const long long w0 = (long long)blockIdx.x * wpb;
  const long long w1 = w0 + wpb < nwin ? w0 + wpb : nwin;
  for (long long w = w0 + threadIdx.y; w < w1; w += R) {
    const int mo = (int)(w % m2), to = (int)(w / m2 % tos),
              b = (int)(w / m2 / tos);
    float gv[V];
    pool::load16(g + (size_t)w * C + c, gv);
    float n[K][V], h[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      pool::load16(x + pool::elem_offset(b, to, mo, k, PT, Tn, M, C, c),
                   n[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        n[k][j] = __fmul_rn(__fsub_rn(n[k][j], mu[j]), iv[j]);
        h[k][j] = fmaxf(__fadd_rn(__fmul_rn(n[k][j], ga[j]), be[j]), 0.0f);
      }
    }
    float d[K][V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float hw[K], dw[K];
#pragma unroll
      for (int k = 0; k < K; ++k) hw[k] = h[k][j];
      pool::window_grad<K>(hw, gv[j], dw);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        s1[j] += dw[k];
        s2[j] = fmaf(dw[k], n[k][j], s2[j]);
        d[k][j] = __fmul_rn(dw[k], ac[j]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      pool::store16(dz + pool::elem_offset(b, to, mo, k, PT, Tn, M, C, c),
                    d[k]);
  }
  float* r1 = red;
  float* r2 = red + R * C;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    r1[threadIdx.y * C + c + j] = s1[j];
    r2[threadIdx.y * C + c + j] = s2[j];
  }
  __syncthreads();
  const int tid = threadIdx.y * cv + threadIdx.x;
  for (int ch = tid; ch < C; ch += cv * R) {
    float a = 0.0f, q = 0.0f;
    for (int r = 0; r < R; ++r) {
      a += r1[r * C + ch];
      q += r2[r * C + ch];
    }
    part[((size_t)blockIdx.x * 2) * C + ch] = a;
    part[((size_t)blockIdx.x * 2 + 1) * C + ch] = q;
  }
}

// Block (32, 32) per 32 channels: lane tx's channel, rows ty, ty + 32, ...
// of the partials, then the 32 row sums added in order by ty = 0.
__global__ void __launch_bounds__(1024)
    bn_pool_reduce(const float* __restrict__ part, int nblk,
                   const float* __restrict__ prm, float* __restrict__ s1,
                   float* __restrict__ s2, float* __restrict__ coef, int C,
                   float count) {
  __shared__ float r1[32][33], r2[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float a = 0.0f, q = 0.0f;
  if (c < C) {
    for (int j = threadIdx.y; j < nblk; j += 32) {
      a += part[(size_t)j * 2 * C + c];
      q += part[((size_t)j * 2 + 1) * C + c];
    }
  }
  r1[threadIdx.y][threadIdx.x] = a;
  r2[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y || c >= C) return;
  a = q = 0.0f;
  for (int r = 0; r < 32; ++r) {
    a += r1[r][threadIdx.x];
    q += r2[r][threadIdx.x];
  }
  s1[c] = a;
  s2[c] = q;
  const float ac = prm[4 * C + c];
  coef[c] = __fmul_rn(ac, __fdiv_rn(a, count));
  coef[C + c] = __fmul_rn(ac, __fdiv_rn(q, count));
}

// dx = (ac dz - c1) - n c2 over every element of x, in place over ac dz;
// rows t >= t2 (dropped by floor pooling) have dz = 0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    bn_pool_apply(const T* __restrict__ x, T* dzdx,
                  const float* __restrict__ prm,
                  const float* __restrict__ coef, int B, int Tn, int M, int C,
                  int t2) {
  constexpr int V = pool::Vec<T>::N;
  const int cv = C / V;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * Tn * M * cv) return;
  const int c = (int)(i % cv) * V;
  const int t = (int)(i / cv / M % Tn);
  float xv[V], dv[V];
  pool::load16(x + (size_t)i * V, xv);
  if (t < t2) {
    pool::load16(dzdx + (size_t)i * V, dv);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dv[j] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float n = __fmul_rn(__fsub_rn(xv[j], prm[c + j]), prm[C + c + j]);
    dv[j] = __fsub_rn(__fsub_rn(dv[j], coef[c + j]),
                      __fmul_rn(n, coef[C + c + j]));
  }
  pool::store16(dzdx + (size_t)i * V, dv);
}

unsigned blocks(long long items) {
  return (unsigned)((items + THREADS - 1) / THREADS);
}

template <typename T>
int fwd(const void* x, const float* sc, const float* sh, void* out, int B,
        int Tn, int M, int C, int pt, cudaStream_t s) {
  const long long items =
      (long long)B * (Tn / pt) * (M / 2) * (C / pool::Vec<T>::N);
  if (items == 0) return 0;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (pt == 2)
    bn_pool_fwd<T, 2><<<blocks(items), THREADS, 0, s>>>(xt, sc, sh, ot, B, Tn,
                                                       M, C);
  else
    bn_pool_fwd<T, 1><<<blocks(items), THREADS, 0, s>>>(xt, sc, sh, ot, B, Tn,
                                                       M, C);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* g, const float* prm, void* dx,
        float* part, float* s1, float* s2, float* coef, int B, int Tn, int M,
        int C, int pt, int wpb, cudaStream_t s) {
  const int cv = C / pool::Vec<T>::N, tos = Tn / pt;
  const long long nwin = (long long)B * tos * (M / 2);
  const int nblk = (int)((nwin + wpb - 1) / wpb);
  const T* xt = static_cast<const T*>(x);
  T* dt = static_cast<T*>(dx);
  if (nblk > 0) {
    const dim3 block(cv, THREADS / cv);
    if (pt == 2)
      bn_pool_route<T, 2><<<nblk, block, 0, s>>>(
          xt, static_cast<const T*>(g), prm, dt, part, B, Tn, M, C, wpb);
    else
      bn_pool_route<T, 1><<<nblk, block, 0, s>>>(
          xt, static_cast<const T*>(g), prm, dt, part, B, Tn, M, C, wpb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  bn_pool_reduce<<<(C + 31) / 32, dim3(32, 32), 0, s>>>(
      part, nblk, prm, s1, s2, coef, C, (float)((long long)B * Tn * M));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)B * Tn * M * cv;
  if (items == 0) return 0;
  bn_pool_apply<T><<<blocks(items), THREADS, 0, s>>>(xt, dt, prm, coef, B, Tn,
                                                     M, C, tos * pt);
  return (int)cudaGetLastError();
}

bool bad_shape(int M, int C, int pt, int bf16) {
  const int v = bf16 ? 8 : 4;
  return (pt != 1 && pt != 2) || M % 2 || C % v || C / v > THREADS;
}

}  // namespace

// x [B, T, M, C], sc / sh [C] f32 -> out [B, T / pt, M / 2, C]; bf16 != 0:
// x and out bf16, else f32.  Pointers 16-byte aligned, C a multiple of 8
// (bf16) or 4 (f32) and at most 256 16-byte words.
extern "C" int ttg_bn_pool_fwd(const void* x, const float* sc,
                               const float* sh, void* out, int B, int T,
                               int M, int C, int pt, int bf16, void* stream) {
  if (bad_shape(M, C, pt, bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd<__nv_bfloat16>(x, sc, sh, out, B, T, M, C, pt, s)
              : fwd<float>(x, sc, sh, out, B, T, M, C, pt, s);
}

// g [B, T / pt, M / 2, C]; prm [5, C] f32 (mean, inv, gamma, beta, ac) ->
// dx [B, T, M, C] in x's type, s1 = dbeta and s2 = dgamma [C] f32.
// Scratch: part [ceil(B (T / pt) (M / 2) / wpb), 2, C] and coef [2, C] f32.
extern "C" int ttg_bn_pool_bwd(const void* x, const void* g, const float* prm,
                               void* dx, float* part, float* s1, float* s2,
                               float* coef, int B, int T, int M, int C,
                               int pt, int bf16, int wpb, void* stream) {
  if (bad_shape(M, C, pt, bf16) || wpb <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd<__nv_bfloat16>(x, g, prm, dx, part, s1, s2, coef, B, T, M,
                                   C, pt, wpb, s)
              : bwd<float>(x, g, prm, dx, part, s1, s2, coef, B, T, M, C, pt,
                           wpb, s);
}
