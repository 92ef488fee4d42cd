// Fused PANNs block (conv3x3 -> BN -> ReLU) x 2 -> avg+max pool, direct
// 3x3 taps, int8 or bf16: blocks 3 and 4 of the Cnn8Rnn serving path.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/conv_block.py:370
// fused_double_conv_pool (direct9 mode).  Its quantization contract:
// a per-CLIP input scale max|x| / 127 over the whole clip, a per-(clip,
// chunk) y1 scale over conv1 rows at times [t0 - 1, t0 + tc + 1) (zero
// outside the clip; the chunk's halo rows are requantized with the chunk's
// own scale), per-output-channel weight scales folded into the BN affine,
// int32 accumulation.
//
// Bound on the H100: operations.  Blocks 3 / 4 do 7.1 / 14.2 GOP of int8
// per 10 s clip (3.6 / 7.2 us at 1979 TOP/s) against 2 MB of bf16
// activations in and out per clip (0.6 us at 3.35 TB/s) and 3.5 / 14 MB of
// f32 weights per call.  This first version runs them as WMMA (mma.sync)
// tiles staged without pipelining (see common.cuh), and adds the halo
// recompute (2 / tc of conv1) and the y1 round trip through device memory
// that the per-chunk scale needs.
#include "common.cuh"

extern "C" int ttg_conv_block(int quant, const void* x, int B, int T, int M,
                              int Cin, int Cout, int tc, int pt, int pm,
                              const void* w1, const float* a1,
                              const float* b1, const void* w2,
                              const float* a2, const float* b2, void* xs,
                              void* y1, void* y1q, float* sx, float* sy,
                              void* out, void* stream) {
  const long long clip = (long long)T * M * Cin;
  return (int)ttg::double_conv(
      quant != 0, static_cast<const ttg::bf16*>(x), B, T, M, Cin, Cout, tc,
      pt, pm, 0, 0, clip, w1, a1, b1, w2, a2, b2, xs, y1,
      static_cast<int8_t*>(y1q), sx, sy, static_cast<ttg::bf16*>(out),
      static_cast<cudaStream_t>(stream));
}
