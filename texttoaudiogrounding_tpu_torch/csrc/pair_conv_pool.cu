// Pair-packed PANNs block for Cout < 256: (conv3x3 -> BN -> ReLU) x 2 ->
// avg+max pool (pt, 2), int8 or bf16, with or without conv1.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/conv_block.py:691
// fused_pair_conv_pool (kernel _pair_kernel :619, staging _pair4_build
// :578).  The TPU kernel packs mel pairs on the lane axis and runs every
// conv as three banded K = 6 Cin dots, so that a 64- or 128-channel conv
// still fills the MXU; the card has no such need, so the same function
// runs on the plain [B, T, M, C] layout through the implicit-GEMM tiles
// of common.cuh.  What is carried over is the quantization contract:
//   * full block: the input scale per (clip, chunk of tc output times),
//     taken over the chunk's staged window of flat mel-pair rows
//     [t0 mp - 2 mp - 1, (t0 + tc + 2) mp + 1) of the [T mp, 2 Cin] view;
//     conv1 rows at times [t0 - 1, t0 + tc + 1), zeroed outside the clip,
//     stored as bf16 (the TPU kernel's compute dtype) before their
//     per-chunk scale is taken and they are requantized;
//   * w1 = null: x is the conv1 activation, int8 with one scale that the
//     caller folded into alpha2 (or bf16); conv2 runs over the whole clip
//     with zero time padding, and no scale is taken;
//   * weights int8 per output channel; f32 avg+max pool, mel pairs then
//     time pairs; bf16 output.
//
// Bound on the H100: operations.  At Cnn8Rnn's block 2 (64 -> 128, 32
// mels) 7.1 GOP of int8 per 10 s clip, 3.6 us at 1979 TOP/s, against
// 3 MB of bf16 in and out (0.9 us at 3.35 TB/s); at block 1 without conv1
// (64 -> 64, 64 mels) 4.7 GOP, 2.4 us, against 4.1 MB of int8 in and
// 2 MB of bf16 out (1.8 us).  This version adds the halo recompute (2 / tc
// of conv1) and the y1 round trip through device memory.
#include "common.cuh"

// x [B, T, M, Cin]: bf16, or int8 when skip and quant.  T % tc == 0,
// tc % pt == 0.  w1 [Cout, 9 Cin], w2 [Cout, 9 Cout] (int8 or bf16; w1,
// a1, b1 unread when skip), a*, b* [Cout] f32.  Scratch (full block
// only): xs [G, tc + 4, M, Cin] int8 or bf16, y1 [G, tc + 2, M, Cout]
// bf16, y1q [G, tc + 2, M, Cout] int8, sx, sy [G] f32 (G = B T / tc).
// out [B, T / pt, M / 2, Cout] bf16.
extern "C" int ttg_pair_conv_pool(int quant, int skip, const void* x, int B,
                                  int T, int M, int Cin, int Cout, int tc,
                                  int pt, const void* w1, const float* a1,
                                  const float* b1, const void* w2,
                                  const float* a2, const float* b2, void* xs,
                                  void* y1, void* y1q, float* sx, float* sy,
                                  void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!skip) {
    const long long L = (long long)M * Cin;  // one time row = M / 2 pairs
    return (int)ttg::double_conv(
        quant != 0, static_cast<const ttg::bf16*>(x), B, T, M, Cin, Cout, tc,
        pt, 2, tc * L, -2 * L - 2 * Cin, (tc + 2) * L + 2 * Cin, w1, a1, b1,
        w2, a2, b2, xs, y1, static_cast<int8_t*>(y1q), sx, sy,
        static_cast<ttg::bf16*>(out), st, /*y1_half=*/true);
  }
  ttg::ConvArgs c{};
  c.src = x;
  c.wt = w2;
  c.alpha = a2;
  c.beta = b2;
  c.gscale = nullptr;
  c.dst = out;
  c.G = B;
  c.nch = 1;
  c.tc = T;
  c.T = T;
  c.R_in = T;
  c.R_out = T;
  c.M = M;
  c.Cin = Cin;
  c.Cout = Cout;
  c.in_off = -1;
  c.pt = pt;
  c.pm = 2;
  c.time_off = 0;
  c.T_out = T / pt;
  if (quant)
    ttg::launch_conv<int8_t, 2>(c, st);
  else
    ttg::launch_conv<ttg::bf16, 2>(c, st);
  return (int)cudaGetLastError();
}
