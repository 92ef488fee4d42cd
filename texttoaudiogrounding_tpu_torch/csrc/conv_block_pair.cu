// Fused PANNs block 2 (64 -> C -> C, 2 x 2 avg+max pool), int8 or bf16.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/conv_block_pair.py:211
// fused_block2_pair.  The TPU kernel packs mel pairs on the lane axis and
// splits the convs by mel parity; that layout is a TPU trick and is not
// carried over: this kernel computes the same function on the plain
// [B, T, M, C] layout.  What is carried over is the quantization contract:
// the input scale is per (clip, chunk of tc output times), taken over the
// chunk's zero-padded input window — flat mel-pair rows
// [t0 mp - 2 mp - 1, (t0 + tc + 2) mp + 1) of the [T mp, 2 Cin] view — so
// the conv1 halo rows of every chunk are recomputed from the chunk's own
// quantized input; the y1 scale is per (clip, chunk) over conv1 rows at
// times [t0 - 1, t0 + tc + 1) with out-of-clip rows zeroed; weights are
// int8 per output channel.
//
// The same function also ports conv_block_small.py:291 fused_block2 (the
// pair-dense block 2): its layouts are TPU tricks too, and what differs
// (the chunk rule, odd T, weights divided by their scales) is decided by
// the Python wrapper (ops/kernels/block2_small.py).
//
// Bound on the H100: operations (7.1 GOP int8 per 10 s clip, 3.6 us at
// 1979 TOP/s, against 3 MB of bf16 activations in and out, 0.9 us at
// 3.35 TB/s).  Same WMMA implicit-GEMM tiles as conv_block.cu.
#include "common.cuh"

extern "C" int ttg_conv_block_pair(int quant, const void* x, int B, int T,
                                   int M, int Cout, int tc, const void* w1,
                                   const float* a1, const float* b1,
                                   const void* w2, const float* a2,
                                   const float* b2, void* xs, void* y1,
                                   void* y1q, float* sx, float* sy,
                                   void* out, void* stream) {
  const int Cin = 64;
  const long long L = (long long)M * Cin;  // one time row = M / 2 pair rows
  return (int)ttg::double_conv(
      quant != 0, static_cast<const ttg::bf16*>(x), B, T, M, Cin, Cout, tc,
      2, 2, tc * L, -2 * L - 2 * Cin, (tc + 2) * L + 2 * Cin, w1, a1, b1, w2,
      a2, b2, xs, y1, static_cast<int8_t*>(y1q), sx, sy,
      static_cast<ttg::bf16*>(out), static_cast<cudaStream_t>(stream));
}
