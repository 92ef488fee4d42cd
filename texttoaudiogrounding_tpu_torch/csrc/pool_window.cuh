// 16-byte vector loads and stores of f32 or bf16 activations (as f32), and
// the avg+max pool window arithmetic shared by dual_pool.cu and bn_pool.cu.
//
// Activations are channel-last [B, T, M, C]; a pool window (pt, 2) with
// stride equal to the window holds the 2 pt elements (dt, dm) of rows
// t = to pt + dt and mels m = 2 mo + dm, in torch's window order (dt, dm).
// One thread takes one window and V = 16 / sizeof(T) consecutive channels,
// so neighbouring threads read neighbouring 16-byte words.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pool {

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}

template <typename T>
__device__ __forceinline__ void store_zero(T* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
}

// Offset of window element k = (dt, dm) of window (b, to, mo) at channel c.
__device__ __forceinline__ size_t elem_offset(int b, int to, int mo, int k,
                                              int pt, int T, int M, int C,
                                              int c) {
  const int t = to * pt + k / 2, m = 2 * mo + k % 2;
  return (((size_t)b * T + t) * M + m) * C + c;
}

// Splits a flat (window, channel vector) index into (b, to, mo, c), windows
// ordered (b, to, mo) with `tos` window rows per clip.
__device__ __forceinline__ void split(long long i, int cv, int V, int m2,
                                      int tos, int& b, int& to, int& mo,
                                      int& c) {
  c = (int)(i % cv) * V;
  long long w = i / cv;
  mo = (int)(w % m2);
  w /= m2;
  to = (int)(w % tos);
  b = (int)(w / tos);
}

// avg + max of the K = 2 pt window elements, in f32, in the order the plain
// versions use: ((e0 + e1) + (e2 + e3)) * 1/K + max.  No contraction: the
// plain versions round the product and the sum separately (the product by a
// power of two is exact anyway).
template <int K>
__device__ __forceinline__ float window_out(const float* e) {
  float s, mx;
  if (K == 4) {
    s = __fadd_rn(__fadd_rn(e[0], e[1]), __fadd_rn(e[2], e[3]));
    mx = fmaxf(fmaxf(e[0], e[1]), fmaxf(e[2], e[3]));
  } else {
    s = __fadd_rn(e[0], e[1]);
    mx = fmaxf(e[0], e[1]);
  }
  return __fadd_rn(__fmul_rn(s, 1.0f / K), mx);
}

// Gradient of avg + max at each window element (h = the ReLU output):
// g / K everywhere, plus g at the first element equal to the window's max
// (torch's first-argmax routing in window order), and 0 where h is 0
// (ReLU's gradient at 0 is 0).
template <int K>
__device__ __forceinline__ void window_grad(const float* h, float g,
                                            float* d) {
  float mx = h[0];
#pragma unroll
  for (int k = 1; k < K; ++k) mx = fmaxf(mx, h[k]);
  const float gavg = __fmul_rn(g, 1.0f / K);
  bool taken = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool hit = h[k] == mx && !taken;
    taken = taken || hit;
    const float dk = hit ? __fadd_rn(gavg, g) : gavg;
    d[k] = h[k] > 0.0f ? dk : 0.0f;
  }
}

}  // namespace pool
