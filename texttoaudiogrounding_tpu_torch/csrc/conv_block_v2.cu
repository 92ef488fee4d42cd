// Rows 3 and 4 in the second design: the chunked fused PANNs block on the
// wgmma implicit GEMM of conv_igemm_sm90.cuh (design notes there).
//
// ttg_conv_block_v2 replaces texttoaudiogrounding_tpu/ops/pallas/
// conv_block.py:370 fused_double_conv_pool in its direct9 mode (blocks 3
// and 4 of the serving path): a per-clip x scale, max|x| / 127 over the
// whole clip.  ttg_conv_block_pair_v2 replaces conv_block_pair.py:211
// fused_block2_pair (block 2, Cin = 64, pool (2, 2)): a per-(clip, chunk)
// x scale over the chunk's zero-padded window of flat mel-pair rows
// [t0 mp - 2 mp - 1, (t0 + tc + 2) mp + 1) of the [T mp, 2 Cin] view.
// Both take the y1 scale per (clip, chunk) over conv1 rows at times
// [t0 - 1, t0 + tc + 1), zero outside the clip.  Their int8 results are
// those of conv_block.cu / conv_block_pair.cu (the first design), bit for
// bit.
//
// Bound on the H100: operations, 7.1 GOP of int8 per 10 s clip for blocks
// 2 and 3 and 14.2 for block 4 (3.6 / 7.2 us at 1979 TOP/s).
#include "conv_igemm_sm90.cuh"

extern "C" int ttg_conv_block_v2(int quant, const void* x, int B, int T,
                                 int M, int Cin, int Cout, int tc, int pt,
                                 int pm, const void* w1, const float* a1,
                                 const float* b1, const void* w2,
                                 const float* a2, const float* b2, void* xs,
                                 void* y1, void* y1q, void* smax, void* out,
                                 void* stream) {
  return (int)ttg::v2::double_conv(
      quant != 0, static_cast<const ttg::bf16*>(x), B, T, M, Cin, Cout, tc,
      pt, pm, true, 0, 0, 0, w1, a1, b1, w2, a2, b2, xs, y1,
      static_cast<int8_t*>(y1q), static_cast<unsigned*>(smax),
      static_cast<ttg::bf16*>(out), static_cast<cudaStream_t>(stream));
}

extern "C" int ttg_conv_block_pair_v2(int quant, const void* x, int B, int T,
                                      int M, int Cout, int tc, const void* w1,
                                      const float* a1, const float* b1,
                                      const void* w2, const float* a2,
                                      const float* b2, void* xs, void* y1,
                                      void* y1q, void* smax, void* out,
                                      void* stream) {
  const int Cin = 64;
  const long long L = (long long)M * Cin;  // one time row = M / 2 pair rows
  return (int)ttg::v2::double_conv(
      quant != 0, static_cast<const ttg::bf16*>(x), B, T, M, Cin, Cout, tc,
      2, 2, false, tc * L, -2 * L - 2 * Cin, (tc + 2) * L + 2 * Cin, w1, a1,
      b1, w2, a2, b2, xs, y1, static_cast<int8_t*>(y1q),
      static_cast<unsigned*>(smax), static_cast<ttg::bf16*>(out),
      static_cast<cudaStream_t>(stream));
}
