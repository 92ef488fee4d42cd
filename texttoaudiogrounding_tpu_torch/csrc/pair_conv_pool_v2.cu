// Row 5, second design: the pair-packed PANNs block for Cout < 256,
// (conv3x3 -> BN -> ReLU) x 2 -> avg+max pool (pt, 2), with or without
// conv1, on conv_igemm_sm90.cuh's wgmma implicit GEMM (design notes
// there).
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/conv_block.py:691
// fused_pair_conv_pool (kernel _pair_kernel :619, staging _pair4_build
// :578).  The TPU kernel packs mel pairs on the lane axis so that a 64- or
// 128-channel conv fills the MXU; the card has no such need, and the same
// function runs on the plain [B, T, M, C] layout.  The int8 contract
// carried over:
//   * full block: the x scale per (clip, chunk of tc output times) over
//     the chunk's staged window (:653, :662) of flat mel-pair rows [t0 mp
//     - 2 mp - 1, (t0 + tc + 2) mp + 1) of the [T mp, 2 Cin] view (mp = M
//     / 2), row 3's window: window_max_kernel with win_step = tc L, win_lo
//     = -2 L - 2 Cin, win_hi = (tc + 2) L + 2 Cin, L = M Cin; conv1 rows
//     at times [t0 - 1, t0 + tc + 1), zero outside the clip, stored in
//     bf16 (:669) before their per-chunk scale is taken (:672): the MODE 4
//     epilogue and requant_kernel<bf16>; conv2 at pool (pt, 2) on MODE 2,
//     time pairs in-thread (2M divides 128);
//   * w1 = null: x is the conv1 activation, int8 with one scale that the
//     caller folded into alpha2 (:673, src_scale 1), or bf16; conv2 runs
//     over the whole clip (one group a clip) with zero time padding, and
//     no scale is taken.  The GEMM reads the caller's unpadded clip: a tap
//     cell past the clip's times or mels is a zero-filling cp.async
//     (igemm_kernel ZFILL), so no padded copy is written;
//   * weights int8 per output channel folded into the affine, f32 avg+max
//     pool (mel pairs, then time pairs), bf16 out.
// Its int8 result is the first design's (pair_conv_pool.cu) and the plain
// version's (ops/kernels/pair_conv_pool.py pair_conv_pool_plain), bit for
// bit.
//
// Bound on the H100: operations.  At Cnn8Rnn's block 2 (64 -> 128, 32
// mels) 7.1 GOP of int8 a 10 s clip, 0.114 ms at 32 clips; without conv1 at
// block 1 (64 -> 64, 64 mels) 4.7 GOP, 0.077 ms, against 4.1 MB of int8 in
// and 2 MB of bf16 out a clip.  What the design leaves on the table: the
// full block's y1 round trip (bf16) and its five launches, B staged again
// for every 128-row tile (at Cout 64 and 128 a tile's A and B stages are
// of one size), and two blocks an SM at BN <= 128.
#include "conv_igemm_sm90.cuh"

// x [B, T, M, Cin]: bf16, or int8 when skip and quant.  T % tc == 0, tc %
// pt == 0, M even (M in 8 / 16 / 32 / 64 with pt = 2).  w1 [Cout, 9 Cin],
// w2 [Cout, 9 Cout] (int8 or bf16; w1, a1, b1 unread when skip), a*, b*
// [Cout] f32.  Scratch (full block only) as ttg_conv_block_pair_v2's, y1
// bf16 [G, tc + 2, M, Cout] for int8.  out [B, T / pt, M / 2, Cout] bf16.
extern "C" int ttg_pair_conv_pool_v2(int quant, int skip, const void* x,
                                     int B, int T, int M, int Cin, int Cout,
                                     int tc, int pt, const void* w1,
                                     const float* a1, const float* b1,
                                     const void* w2, const float* a2,
                                     const float* b2, void* xs, void* y1,
                                     void* y1q, void* smax, void* out,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!skip) {
    const long long L = (long long)M * Cin;  // one time row = M / 2 pairs
    return (int)ttg::v2::double_conv<false, true>(
        quant != 0, static_cast<const ttg::bf16*>(x), B, T, M, Cin, Cout, tc,
        pt, 2, false, tc * L, -2 * L - 2 * Cin, (tc + 2) * L + 2 * Cin, w1,
        a1, b1, w2, a2, b2, xs, y1, static_cast<int8_t*>(y1q),
        static_cast<unsigned*>(smax), static_cast<ttg::bf16*>(out), st,
        false, false, quant != 0);
  }
  ttg::v2::IgemmArgs c{};
  c.src = x;
  c.wt = w2;
  c.alpha = a2;
  c.beta = b2;
  c.smax = nullptr;  // the x scale is in alpha2
  c.scale_div = 1;
  c.ymax = nullptr;
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
  c.time_off = 0;
  c.pt = pt;
  c.pm = 2;
  c.T_out = T / pt;
  return (int)(quant ? ttg::v2::launch_igemm<int8_t, 2, false, true>(c, st)
                     : ttg::v2::launch_igemm<ttg::bf16, 2, false, true>(c,
                                                                       st));
}
