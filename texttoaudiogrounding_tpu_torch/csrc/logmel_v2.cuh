// The wide pad pass of the log-mel second designs (rows 1 and 10,
// logmel_v2.cu and logmel_v4_v2.cu): it reads the f32 waveform once and
// writes the reflect-padded, zero-extended bf16 xpad [B, npad] whose
// 640-byte-aligned frame rows the wgmma DFT reads in place.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ttg_mel_v2 {

using bf16 = __nv_bfloat16;

// xpad[b, i] = bf16(x[b, reflect(i - pad)]) for i < N + 2 pad, else 0;
// thread v writes the 8 samples [8 v, 8 v + 8) of the flat [B, npad].
static __global__ void wave_pad_kernel(const float* __restrict__ x,
                                       bf16* __restrict__ xpad, int N,
                                       int pad, long long npad,
                                       long long nvec) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nvec) return;
  const long long b = (8 * v) / npad;
  const long long i0 = 8 * v - b * npad;
  const float* clip = x + b * N;
  float f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    long long j = i0 + e - pad;
    float val = 0.0f;
    if (j < (long long)N + pad) {
      j = j < 0 ? -j : (j >= N ? 2LL * (N - 1) - j : j);
      val = clip[j];
    }
    f[e] = val;
  }
  uint4 o;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
  reinterpret_cast<uint4*>(xpad)[v] = o;
}

}  // namespace ttg_mel_v2
