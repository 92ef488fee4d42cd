// ReLU -> avg + max pool with a mask-recompute backward (sm_90a).
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/dual_pool.py:263
// dual_pool_relu (forward :123/:209, backward :144/:229):
//   out = avg_pool(relu(x)) + max_pool(relu(x)), window (pt, 2) = stride,
//   pt in {1, 2}, floor pooling over T; x [B, T, M, C] channel-last, f32 or
//   bf16, out [B, T / pt, M / 2, C] in x's type, accumulated in f32 and
//   rounded once.  The backward recomputes each window's ReLU and max from
//   the saved x: the max share goes to the first maximal element in window
//   order (dt, dm), ReLU's gradient is 0 at 0, and the rows that floor
//   pooling drops (odd T) get zero gradient.
//
// The TPU kernel packs block 1's 64 channels two mels to a 128-lane row;
// that is a TPU layout device.  Here every geometry takes one layout: one
// thread per (window, 16 bytes of channels), so a warp reads whole 16-byte
// words of neighbouring channels and mels and every byte once.
//
// Bound on the H100: bytes.  Forward reads x once and writes a quarter (pt
// = 2) or half (pt = 1) of it; backward reads x and g and writes dx.  A few
// f32 operations per byte, far below the card's ~20 f32 operations per byte
// of bandwidth.
#include "pool_window.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, int PT>
__global__ void __launch_bounds__(THREADS)
    dual_pool_fwd(const T* __restrict__ x, T* __restrict__ out, int B, int Tn,
                  int M, int C) {
  constexpr int V = pool::Vec<T>::N, K = 2 * PT;
  const int cv = C / V, m2 = M / 2, tos = Tn / PT;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * tos * m2 * cv) return;
  int b, to, mo, c;
  pool::split(i, cv, V, m2, tos, b, to, mo, c);
  float e[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    pool::load16(x + pool::elem_offset(b, to, mo, k, PT, Tn, M, C, c), e[k]);
#pragma unroll
    for (int j = 0; j < V; ++j) e[k][j] = fmaxf(e[k][j], 0.0f);
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

// Windows run over ceil(T / pt) rows: a last, partial window (odd T with
// pt = 2) writes zeros to the rows floor pooling drops.
template <typename T, int PT>
__global__ void __launch_bounds__(THREADS)
    dual_pool_bwd(const T* __restrict__ x, const T* __restrict__ g,
                  T* __restrict__ dx, int B, int Tn, int M, int C) {
  constexpr int V = pool::Vec<T>::N, K = 2 * PT;
  const int cv = C / V, m2 = M / 2, tos = Tn / PT, tall = (Tn + PT - 1) / PT;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * tall * m2 * cv) return;
  int b, to, mo, c;
  pool::split(i, cv, V, m2, tall, b, to, mo, c);
  if (to >= tos) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (to * PT + k / 2 < Tn)
        pool::store_zero(dx + pool::elem_offset(b, to, mo, k, PT, Tn, M, C, c));
    return;
  }
  float gv[V];
  pool::load16(g + (((size_t)b * tos + to) * m2 + mo) * C + c, gv);
  float h[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    pool::load16(x + pool::elem_offset(b, to, mo, k, PT, Tn, M, C, c), h[k]);
#pragma unroll
    for (int j = 0; j < V; ++j) h[k][j] = fmaxf(h[k][j], 0.0f);
  }
  float d[K][V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float w[K], dw[K];
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = h[k][j];
    pool::window_grad<K>(w, gv[j], dw);
#pragma unroll
    for (int k = 0; k < K; ++k) d[k][j] = dw[k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    pool::store16(dx + pool::elem_offset(b, to, mo, k, PT, Tn, M, C, c), d[k]);
}

unsigned blocks(long long items) {
  return (unsigned)((items + THREADS - 1) / THREADS);
}

template <typename T>
int fwd(const void* x, void* out, int B, int Tn, int M, int C, int pt,
        cudaStream_t s) {
  const long long items =
      (long long)B * (Tn / pt) * (M / 2) * (C / pool::Vec<T>::N);
  if (items == 0) return 0;
  if (pt == 2)
    dual_pool_fwd<T, 2><<<blocks(items), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), B, Tn, M, C);
  else
    dual_pool_fwd<T, 1><<<blocks(items), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out), B, Tn, M, C);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* g, void* dx, int B, int Tn, int M, int C,
        int pt, cudaStream_t s) {
  const long long items = (long long)B * ((Tn + pt - 1) / pt) * (M / 2) *
                          (C / pool::Vec<T>::N);
  if (items == 0) return 0;
  if (pt == 2)
    dual_pool_bwd<T, 2><<<blocks(items), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<T*>(dx), B, Tn, M, C);
  else
    dual_pool_bwd<T, 1><<<blocks(items), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<T*>(dx), B, Tn, M, C);
  return (int)cudaGetLastError();
}

bool bad_shape(int M, int C, int pt, int bf16) {
  return (pt != 1 && pt != 2) || M % 2 || C % (bf16 ? 8 : 4);
}

}  // namespace

// x [B, T, M, C] -> out [B, T / pt, M / 2, C]; bf16 != 0: both bf16, else
// both f32.  Pointers 16-byte aligned, C a multiple of 8 (bf16) or 4 (f32).
extern "C" int ttg_dual_pool_fwd(const void* x, void* out, int B, int T,
                                 int M, int C, int pt, int bf16,
                                 void* stream) {
  if (bad_shape(M, C, pt, bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd<__nv_bfloat16>(x, out, B, T, M, C, pt, s)
              : fwd<float>(x, out, B, T, M, C, pt, s);
}

// g [B, T / pt, M / 2, C] (the gradient of out) -> dx [B, T, M, C].
extern "C" int ttg_dual_pool_bwd(const void* x, const void* g, void* dx,
                                 int B, int T, int M, int C, int pt, int bf16,
                                 void* stream) {
  if (bad_shape(M, C, pt, bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd<__nv_bfloat16>(x, g, dx, B, T, M, C, pt, s)
              : bwd<float>(x, g, dx, B, T, M, C, pt, s);
}
