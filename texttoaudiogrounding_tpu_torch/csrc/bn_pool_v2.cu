// Train-mode BatchNorm -> ReLU -> avg + max pool on Hopper, second design:
// the backward in two streaming passes without the ac dz round trip, and
// the batch statistics in one pass (sm_90a).
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/bn_pool.py:376
// bn_relu_dual_pool: its backward (_op_bwd :343, _run_bwd :240,
// _bwd_kernel :166) and the batch statistics its wrapper takes with XLA
// reductions (:395-398).  The forward stays bn_pool.cu's bn_pool_fwd; the
// first design of the backward (three launches, ac dz written in full and
// read again) stays in bn_pool.cu.
//
// What bounds it on the H100: bytes.  Under 20 f32 operations an element
// against 2-4 bytes of x read, so every pass streams.  The backward reads
// x and g twice and writes dx once, (3 + 1 / pt) |x| against the first
// design's ~(5 + 1 / (2 pt)) |x|; its bound counts x read once, which only
// an on-chip copy of x could reach.
//
// Backward, two launches on one persistent grid (one CTA of THREADS
// threads an SM; CTA k takes window rows [k rpc, (k + 1) rpc), a window row
// being the pt contiguous time rows (b, to) that M / 2 windows cover):
//  1. bn_pool_bwd_sums reads x and g, recomputes n = (x - mean) inv, h =
//     relu(n gamma + beta) and the route of pool_window.cuh (g / K to every
//     window element, plus g at the first maximal one in window order, 0
//     where h = 0), and sums s1 = sum dz and s2 = sum dz n: each thread in
//     its windows' order, then the CTA's threads in a fixed tree into one
//     row of part [grid, 2, C].  The last CTA to finish (a done counter
//     behind __threadfence) sums part in a fixed order and writes dbeta =
//     s1, dgamma = s2 and c1 = ac s1 / N, c2 = ac s2 / N (ac = gamma inv, N
//     = B T M over the full T).  No float atomics: every run gives the
//     same bits, whichever CTA ends last.
//  2. bn_pool_bwd_apply reads x and g again, walking each CTA's windows in
//     the reverse order of pass 1 (the last tens of MB that pass 1 read are
//     still in the 50 MB L2), recomputes the route and writes dx =
//     round_x(ac dz) - c1 - n c2 with streaming stores.  ac dz is rounded
//     to x's type in registers, as the JAX kernel rounds it when it stores
//     it (bn_pool.py:190).  The rows t >= t2 that floor pooling drops get
//     -c1 - n c2.
//
// Statistics, one launch: bn_pool_stats reads x [rows, C] once with
// 16-byte loads; each thread sums its rows (strided by the CTA's thread
// rows) eight at a time, each eight in a fixed tree, then the CTA's threads
// in a fixed tree into part, and the last CTA sums part in a fixed order:
// mean = sum x / N, var = max(sum x^2 / N - mean^2, 0), flax's fast
// variance.  No sum runs longer than a few hundred terms in one register.
//
// Bytes in flight: each thread issues the loads of 2 windows (pt = 2: 10
// 16-byte loads), 3 windows (pt = 1: 9) or 8 rows (statistics) before it
// uses the first: 48-80 KB an SM.  Measured on an H100 against throwaway
// variants (readings in PERF.md): a 4-stage ring of 1-D
// cp.async.bulk copies feeding pass 1 took about 1 % less time than these
// loads, so the loads stay, needing no dynamic shared memory or mbarriers;
// walking pass 2 forward instead of back took about 2 % more.
//
// Sums never contract a multiply into an add (__fadd_rn, __fmul_rn), so
// ops/kernels/bn_pool.py's emulations reproduce them on the CPU.
#include "pool_window.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int ROWS_AHEAD = 8;    // rows a statistics thread loads at once

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// v rounded to T and widened back (the JAX kernel's store of ac dz)
template <typename T>
__device__ __forceinline__ float round_as(float v);

template <>
__device__ __forceinline__ float round_as<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Element j (0 .. V - 1) of a 16-byte word of T, as f32 (bf16 element 2i
// is the low half of 32-bit word i).
template <typename T>
__device__ __forceinline__ float elem(const uint4& a, int j);

template <>
__device__ __forceinline__ float elem<float>(const uint4& a, int j) {
  return __uint_as_float(reinterpret_cast<const unsigned*>(&a)[j]);
}

template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& a, int j) {
  const unsigned w = reinterpret_cast<const unsigned*>(&a)[j / 2];
  return __uint_as_float(j & 1 ? w & 0xffff0000u : w << 16);
}

// v rounded to T into element j of a 16-byte word (zeroed beforehand)
template <typename T>
__device__ __forceinline__ void put(uint4& a, int j, float v);

template <>
__device__ __forceinline__ void put<float>(uint4& a, int j, float v) {
  reinterpret_cast<unsigned*>(&a)[j] = __float_as_uint(v);
}

template <>
__device__ __forceinline__ void put<__nv_bfloat16>(uint4& a, int j, float v) {
  const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  reinterpret_cast<unsigned*>(&a)[j / 2] |= j & 1 ? h << 16 : h;
}

__device__ __forceinline__ int thread_id() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

// Rows 0..n-1 of red [n][w] summed into row 0 in a fixed tree: with p the
// largest power of two below n, row r += row r + p (r < p, r + p < n), then
// p halves.  Every thread of the CTA calls it.
__device__ void tree_rows(float* red, int n, int w) {
  const int tid = thread_id(), nt = blockDim.x * blockDim.y;
  int p = 1;
  while (2 * p < n) p *= 2;
  for (; p > 0; p /= 2) {
    __syncthreads();
    for (int i = tid; i < p * w; i += nt) {
      const int r = i / w;
      if (r + p < n) red[i] = __fadd_rn(red[i], red[i + p * w]);
    }
  }
  __syncthreads();
}

// True in every thread of the last CTA to get here, once every CTA's part
// row is visible to it.  atomicInc wraps the counter back to 0 at the last
// CTA, so each launch leaves it as it found it.
__device__ __forceinline__ bool last_cta(unsigned* done) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (thread_id() == 0) last = atomicInc(done, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// part [G][w] summed over G into red[0 .. w) in a fixed order: float4
// column q of lane r (L = nt / (w / 4) lanes, or 1 when the columns
// outnumber the threads) adds rows r, r + L, r + 2 L, ... in turn, eight
// loads at a time, then the lanes are summed in tree_rows' tree.
__device__ void sum_parts(const float* part, int G, int w, float* red) {
  const int tid = thread_id(), nt = blockDim.x * blockDim.y, w4 = w / 4;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  float4* r4 = reinterpret_cast<float4*>(red);
  const int lanes = w4 <= nt ? nt / w4 : 1;
  const int step = w4 <= nt ? w4 : nt;
  for (int q0 = 0; q0 < w4; q0 += step) {
    const int q = q0 + tid % step, lane = tid / step;
    if (lane < lanes && q < w4) {
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int k = lane;
      for (; k + 7 * lanes < G; k += 8 * lanes) {
        float4 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = __ldcg(p4 + (size_t)(k + i * lanes) * w4 + q);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          a.x = __fadd_rn(a.x, v[i].x);
          a.y = __fadd_rn(a.y, v[i].y);
          a.z = __fadd_rn(a.z, v[i].z);
          a.w = __fadd_rn(a.w, v[i].w);
        }
      }
      for (; k < G; k += lanes) {
        const float4 v = __ldcg(p4 + (size_t)k * w4 + q);
        a.x = __fadd_rn(a.x, v.x);
        a.y = __fadd_rn(a.y, v.y);
        a.z = __fadd_rn(a.z, v.z);
        a.w = __fadd_rn(a.w, v.w);
      }
      r4[lane * w4 + q] = a;
    }
  }
  if (lanes > 1) tree_rows(red, lanes, w);
  else __syncthreads();
}

// The per-thread sums s[V] (columns c..) and q[V] (columns C + c..) of
// thread row ty summed over the CTA's thread rows into part[blockIdx.x].
template <int V>
__device__ __forceinline__ void cta_sums_to_part(const float* s,
                                                 const float* q, float* red,
                                                 float* part, int C) {
  const int R = blockDim.y, c = threadIdx.x * V, nt = blockDim.x * R;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[threadIdx.y * 2 * C + c + j] = s[j];
    red[threadIdx.y * 2 * C + C + c + j] = q[j];
  }
  tree_rows(red, R, 2 * C);
  for (int i = thread_id(); i < 2 * C; i += nt)
    part[(size_t)blockIdx.x * 2 * C + i] = red[i];
}

// n = (x - mean) inv and the routed gradient d of one window's K elements
// (raw 16-byte words xr, g's word gr) at channel j of the words.
template <typename T, int K>
__device__ __forceinline__ void route(const uint4* xr, const uint4& gr, int j,
                                      float mu, float iv, float ga, float be,
                                      float* n, float* d) {
  float h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    n[k] = __fmul_rn(__fsub_rn(elem<T>(xr[k], j), mu), iv);
    h[k] = fmaxf(__fadd_rn(__fmul_rn(n[k], ga), be), 0.0f);
  }
  pool::window_grad<K>(h, elem<T>(gr, j), d);
}

// The window's x words (and g's) of window ww, windows ordered (b, to, mo).
template <int PT>
__device__ __forceinline__ void window_words(const void* xv, const void* gv,
                                             int es, long long ww, int Tn,
                                             int M, int C, int c, uint4* xr,
                                             uint4& gr) {
  const int m2 = M / 2, tos = Tn / PT;
  const int mo = (int)(ww % m2);
  const long long row = ww / m2;
  const int to = (int)(row % tos), b = (int)(row / tos);
  const char* x = static_cast<const char*>(xv);
  gr = ld16(static_cast<const char*>(gv) + (size_t)(ww * C + c) * es);
#pragma unroll
  for (int k = 0; k < 2 * PT; ++k)
    xr[k] = ld16(x + pool::elem_offset(b, to, mo, k, PT, Tn, M, C, c) * es);
}

template <typename T>
__device__ __forceinline__ void load_params(const float* mean,
                                            const float* inv,
                                            const float* gamma,
                                            const float* beta, int c,
                                            float* mu, float* iv, float* ga,
                                            float* be) {
#pragma unroll
  for (int j = 0; j < pool::Vec<T>::N; ++j) {
    mu[j] = mean[c + j];
    iv[j] = inv[c + j];
    ga[j] = gamma[c + j];
    be[j] = beta[c + j];
  }
}

// Pass 1.  Block (cv, R): thread (tx, ty) takes channels tx V .. tx V + V - 1
// of the CTA's windows w0 + ty, w0 + ty + R, ... in that order.
template <typename T, int PT>
__global__ void __launch_bounds__(THREADS, 1)
    bn_pool_bwd_sums(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ mean,
                     const float* __restrict__ inv,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* part,
                     unsigned* done, float* __restrict__ s1o,
                     float* __restrict__ s2o, float* __restrict__ coef,
                     int B, int Tn, int M, int C, int rpc, float count) {
  constexpr int V = pool::Vec<T>::N, K = 2 * PT, U = PT == 2 ? 2 : 3;
  __shared__ __align__(16) float red[2 * THREADS * V];
  const int R = blockDim.y, c = threadIdx.x * V, m2 = M / 2;
  float mu[V], iv[V], ga[V], be[V], s1[V], s2[V];
  load_params<T>(mean, inv, gamma, beta, c, mu, iv, ga, be);
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.0f;
  const long long nwin = (long long)B * (Tn / PT) * m2;
  const long long w0 = (long long)blockIdx.x * rpc * m2;
  const long long w1 = min(w0 + (long long)rpc * m2, nwin);
  for (long long w = w0 + threadIdx.y; w < w1; w += U * R) {
    uint4 xr[U][K], gr[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (w + (long long)u * R < w1)
        window_words<PT>(x, g, sizeof(T), w + (long long)u * R, Tn, M, C, c,
                         xr[u], gr[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (w + (long long)u * R >= w1) break;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float n[K], d[K];
        route<T, K>(xr[u], gr[u], j, mu[j], iv[j], ga[j], be[j], n, d);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          s1[j] = __fadd_rn(s1[j], d[k]);
          s2[j] = __fadd_rn(s2[j], __fmul_rn(d[k], n[k]));
        }
      }
    }
  }
  cta_sums_to_part<V>(s1, s2, red, part, C);
  if (!last_cta(done)) return;
  sum_parts(part, gridDim.x, 2 * C, red);
  for (int ch = thread_id(); ch < C; ch += blockDim.x * R) {
    const float a = red[ch], q = red[C + ch];
    const float ac = __fmul_rn(gamma[ch], inv[ch]);
    s1o[ch] = a;
    s2o[ch] = q;
    coef[ch] = __fmul_rn(ac, __fdiv_rn(a, count));
    coef[C + ch] = __fmul_rn(ac, __fdiv_rn(q, count));
  }
}

// Pass 2: the same CTAs and thread rows as pass 1, each thread's windows
// in reverse; then the rows floor pooling drops, strided over the grid.
template <typename T, int PT>
__global__ void __launch_bounds__(THREADS, 1)
    bn_pool_bwd_apply(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ mean,
                      const float* __restrict__ inv,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const float* __restrict__ coef, T* __restrict__ dx,
                      int B, int Tn, int M, int C, int rpc) {
  constexpr int V = pool::Vec<T>::N, K = 2 * PT, U = PT == 2 ? 2 : 3;
  const int R = blockDim.y, c = threadIdx.x * V, m2 = M / 2, tos = Tn / PT;
  float mu[V], iv[V], ga[V], be[V], c1[V], c2[V];
  load_params<T>(mean, inv, gamma, beta, c, mu, iv, ga, be);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    c1[j] = coef[c + j];
    c2[j] = coef[C + c + j];
  }
  const long long nwin = (long long)B * tos * m2;
  const long long w0 = (long long)blockIdx.x * rpc * m2;
  const long long w1 = min(w0 + (long long)rpc * m2, nwin);
  const long long span = w1 - w0 - threadIdx.y;
  const long long nj = span > 0 ? (span + R - 1) / R : 0;
  for (long long j = nj - 1; j >= 0; j -= U) {
    uint4 xr[U][K], gr[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j - u >= 0)
        window_words<PT>(x, g, sizeof(T), w0 + threadIdx.y + (j - u) * R,
                         Tn, M, C, c, xr[u], gr[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j - u < 0) break;
      uint4 o[K];
#pragma unroll
      for (int k = 0; k < K; ++k) o[k] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float n[K], d[K];
        route<T, K>(xr[u], gr[u], i, mu[i], iv[i], ga[i], be[i], n, d);
        const float ac = __fmul_rn(ga[i], iv[i]);
#pragma unroll
        for (int k = 0; k < K; ++k)
          put<T>(o[k], i,
                 __fsub_rn(__fsub_rn(round_as<T>(__fmul_rn(d[k], ac)), c1[i]),
                           __fmul_rn(n[k], c2[i])));
      }
      const long long ww = w0 + threadIdx.y + (j - u) * R;
      const int mo = (int)(ww % m2);
      const long long row = ww / m2;
      const int to = (int)(row % tos), b = (int)(row / tos);
#pragma unroll
      for (int k = 0; k < K; ++k)
        __stcs(reinterpret_cast<uint4*>(
                   dx + pool::elem_offset(b, to, mo, k, PT, Tn, M, C, c)),
               o[k]);
    }
  }
  const int t2 = tos * PT, rest = Tn - t2;
  if (rest == 0) return;
  const int cv = C / V, nt = blockDim.x * R;
  const long long items = (long long)B * rest * M * cv;
  for (long long i = (long long)blockIdx.x * nt + thread_id(); i < items;
       i += (long long)gridDim.x * nt) {
    const int cc = (int)(i % cv) * V;
    long long r = i / cv;
    const int m = (int)(r % M);
    r /= M;
    const int t = t2 + (int)(r % rest), b = (int)(r / rest);
    const size_t off = (((size_t)b * Tn + t) * M + m) * C + cc;
    const uint4 xv = ld16(x + off);
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float n =
          __fmul_rn(__fsub_rn(elem<T>(xv, k), mean[cc + k]), inv[cc + k]);
      put<T>(o, k, __fsub_rn(__fsub_rn(0.0f, coef[cc + k]),
                             __fmul_rn(n, coef[C + cc + k])));
    }
    __stcs(reinterpret_cast<uint4*>(dx + off), o);
  }
}

// Statistics.  Block (cv, R): thread (tx, ty) takes channels tx V .. of the
// CTA's rows r0 + ty, r0 + ty + R, ..., ROWS_AHEAD at a time: their values
// (and squares) summed in a tree (row u += row u + p, p = 4, 2, 1; rows past
// the CTA's end count 0), the eight's sum then added to the running sum.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    bn_pool_stats(const T* __restrict__ x, float* part, unsigned* done,
                  float* __restrict__ mean, float* __restrict__ var,
                  long long rows, int C, long long rpc, float count) {
  constexpr int V = pool::Vec<T>::N, U = ROWS_AHEAD;
  __shared__ __align__(16) float red[2 * THREADS * V];
  const int R = blockDim.y, c = threadIdx.x * V;
  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.0f;
  const long long r0 = (long long)blockIdx.x * rpc;
  const long long r1 = min(r0 + rpc, rows);
  for (long long r = r0 + threadIdx.y; r < r1; r += U * R) {
    uint4 e[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      e[u] = r + (long long)u * R < r1
                 ? ld16(x + (r + (long long)u * R) * C + c)
                 : make_uint4(0u, 0u, 0u, 0u);
    float a[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j) a[u][j] = elem<T>(e[u], j);
#pragma unroll
    for (int p = U / 2; p > 0; p /= 2)
#pragma unroll
      for (int u = 0; u < p; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) a[u][j] = __fadd_rn(a[u][j], a[u + p][j]);
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = __fadd_rn(s[j], a[0][j]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = elem<T>(e[u], j);
        a[u][j] = __fmul_rn(v, v);
      }
#pragma unroll
    for (int p = U / 2; p > 0; p /= 2)
#pragma unroll
      for (int u = 0; u < p; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) a[u][j] = __fadd_rn(a[u][j], a[u + p][j]);
#pragma unroll
    for (int j = 0; j < V; ++j) q[j] = __fadd_rn(q[j], a[0][j]);
  }
  cta_sums_to_part<V>(s, q, red, part, C);
  if (!last_cta(done)) return;
  sum_parts(part, gridDim.x, 2 * C, red);
  for (int ch = thread_id(); ch < C; ch += blockDim.x * R) {
    const float m = __fdiv_rn(red[ch], count);
    mean[ch] = m;
    var[ch] = fmaxf(__fsub_rn(__fdiv_rn(red[C + ch], count), __fmul_rn(m, m)),
                    0.0f);
  }
}

dim3 block_of(int C, int v) {
  const int cv = C / v;
  return dim3(cv, THREADS / cv);
}

bool bad_channels(int C, int bf16) {
  const int v = bf16 ? 8 : 4;
  return C <= 0 || C % v || C / v > THREADS;
}

template <typename T, int PT>
int bwd(const void* x, const void* g, const float* mean, const float* inv,
        const float* gamma, const float* beta, void* dx, float* part,
        unsigned* done, float* s1, float* s2, float* coef, int B, int Tn,
        int M, int C, int grid, int rpc, cudaStream_t s) {
  const dim3 block = block_of(C, pool::Vec<T>::N);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  bn_pool_bwd_sums<T, PT><<<grid, block, 0, s>>>(
      xt, gt, mean, inv, gamma, beta, part, done, s1, s2, coef, B, Tn, M, C,
      rpc, (float)((long long)B * Tn * M));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_pool_bwd_apply<T, PT><<<grid, block, 0, s>>>(
      xt, gt, mean, inv, gamma, beta, coef, static_cast<T*>(dx), B, Tn, M, C,
      rpc);
  return (int)cudaGetLastError();
}

}  // namespace

// x [rows, C] (any leading shape) -> mean, var [C] f32.  part [grid, 2, C]
// f32 scratch, done a zeroed counter (left at 0); grid CTAs of rpc rows
// each, grid rpc >= rows.  x 16-byte aligned, C a multiple of 8 (bf16) or
// 4 (f32) and at most THREADS 16-byte words.
extern "C" int ttg_bn_pool_stats(const void* x, float* part, unsigned* done,
                                 float* mean, float* var, long long rows,
                                 int C, int bf16, int grid, long long rpc,
                                 void* stream) {
  if (bad_channels(C, bf16) || grid <= 0 || rpc <= 0 ||
      (long long)grid * rpc < rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float count = (float)rows;
  if (bf16)
    bn_pool_stats<__nv_bfloat16><<<grid, block_of(C, 8), 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), part, done, mean, var, rows, C,
        rpc, count);
  else
    bn_pool_stats<float><<<grid, block_of(C, 4), 0, s>>>(
        static_cast<const float*>(x), part, done, mean, var, rows, C, rpc,
        count);
  return (int)cudaGetLastError();
}

// x [B, T, M, C], g [B, T / pt, M / 2, C] in x's type; mean, inv = rsqrt(var
// + eps), gamma, beta [C] f32 -> dx [B, T, M, C] in x's type, s1 = dbeta, s2
// = dgamma [C] f32.  Scratch: part [grid, 2, C], coef [2, C] f32, done a
// zeroed counter (left at 0); grid CTAs of rpc window rows each, grid rpc >=
// B (T / pt).
extern "C" int ttg_bn_pool_bwd_v2(const void* x, const void* g,
                                  const float* mean, const float* inv,
                                  const float* gamma, const float* beta,
                                  void* dx, float* part, unsigned* done,
                                  float* s1, float* s2, float* coef, int B,
                                  int T, int M, int C, int pt, int bf16,
                                  int grid, int rpc, void* stream) {
  if (bad_channels(C, bf16) || (pt != 1 && pt != 2) || M % 2 || grid <= 0 ||
      rpc <= 0 || (long long)grid * rpc < (long long)B * (T / pt))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return pt == 2 ? bwd<__nv_bfloat16, 2>(x, g, mean, inv, gamma, beta, dx,
                                           part, done, s1, s2, coef, B, T, M,
                                           C, grid, rpc, s)
                   : bwd<__nv_bfloat16, 1>(x, g, mean, inv, gamma, beta, dx,
                                           part, done, s1, s2, coef, B, T, M,
                                           C, grid, rpc, s);
  return pt == 2 ? bwd<float, 2>(x, g, mean, inv, gamma, beta, dx, part, done,
                                 s1, s2, coef, B, T, M, C, grid, rpc, s)
                 : bwd<float, 1>(x, g, mean, inv, gamma, beta, dx, part, done,
                                 s1, s2, coef, B, T, M, C, grid, rpc, s);
}
