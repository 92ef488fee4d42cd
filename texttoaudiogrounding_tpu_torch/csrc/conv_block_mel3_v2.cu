// Row 4's mel3 tap mode, second design: the chunked fused PANNs block
// (conv3x3 -> BN -> ReLU) x 2 -> avg+max pool on conv_igemm_sm90.cuh's
// wgmma implicit GEMM (design notes there), with a mel3 conv run in the
// GEMM's slab form (igemm_kernel SLAB) as tri's second design does.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/conv_block.py:370
// fused_double_conv_pool in its mel3 mode (:162 _mel3_build, :235
// _conv3).  The int8 contract carried over from the TPU kernel:
//   * conv1's x scale per (clip, chunk j): max|x| over the staged window
//     xc_ref (:287), the flat cells [(j tc - 2) M - 1, (j tc + tc + 2) M
//     + 1) of the clip, one cell past the staged times on each side
//     (_mel3_build's max over its src_ref, :174-175, with src_ref's lead
//     pad row); here window_max_kernel's window win_step = tc M Cin,
//     win_lo = -(2M + 1) Cin, win_hi = ((tc + 2) M + 1) Cin, zero outside
//     the clip;
//   * conv1 rows at times [j tc - 1, j tc + tc + 1), zero outside the
//     clip; with a mel3 conv2 they are stored in bf16 (:331) and conv2's
//     per-chunk scale is taken over those rounded values (:340): the
//     MODE 4 epilogue rounds each value with __float2bfloat16_rn, takes
//     the group max over the rounded values and stores bf16 y1, which
//     requant_kernel<bf16> requantizes; after a mel3 conv1 with a direct9
//     (or tri) conv2 the rows stay f32 (:325-328), MODE 0;
//   * weights int8 per output channel folded into the affine, int32 sums,
//     the f32 epilogue and pool in the first design's order.
// Its int8 result is the first mel3 design's (conv_block_mel3.cu) and the
// plain version's (ops/kernels/conv_block.py block_plain), bit for bit.
// In bf16 the mel3 block is tri's function at tri's chunk, so the wrapper
// runs it on tri's second design (conv_block_tri_v2.cu) and this entry is
// int8 only.
//
// Bound on the H100: operations, as direct9's (9 Cin Cout products an
// output row: blocks 3 / 4 7.1 / 14.2 GOP of int8 a 10 s clip, 0.114 /
// 0.229 ms at 32 clips).  Against the first design: the scale is a wide
// reduction instead of one block a group, the quantize pass one thread a
// 16-byte piece, the GEMM wgmma from a cp.async ring with tiles crossing
// groups (the first design computed a partial last tile in every group and
// did not pipeline), and y1 makes its round trip in bf16 (half the f32
// bytes).  What it leaves on the table: tri's (the slab form stages three
// weight slices a stage, so only 3 ring slots fit at BN = 256), the y1
// round trip itself (its scale is a max over the chunk), and the x window
// maxes read each halo row twice.
#include "conv_igemm_sm90.cuh"

// slab1 / slab2: conv1 / conv2 in the slab form (M a multiple of 8 up to
// 64; conv2 only at pool (1, .)), else direct9's per-tap GEMM; y1_half:
// conv1 rows stored in bf16 before their scale (mel3 conv2 after mel3
// conv1).  Buffers as ttg_conv_block_v2's, smax [2 G] (the x window maxes,
// then the y1 maxes) and y1 bf16 [G, tc + 2, M, Cout] with y1_half.
extern "C" int ttg_conv_block_mel3_v2(int slab1, int slab2, int y1_half,
                                      const void* x, int B, int T, int M,
                                      int Cin, int Cout, int tc, int pt,
                                      int pm, const void* w1,
                                      const float* a1, const float* b1,
                                      const void* w2, const float* a2,
                                      const float* b2, void* xs, void* y1,
                                      void* y1q, void* smax, void* out,
                                      void* stream) {
  const long long step = (long long)tc * M * Cin;
  return (int)ttg::v2::double_conv<true, true>(
      true, static_cast<const ttg::bf16*>(x), B, T, M, Cin, Cout, tc, pt, pm,
      false, step, -(2LL * M + 1) * Cin, ((tc + 2LL) * M + 1) * Cin, w1, a1,
      b1, w2, a2, b2, xs, y1, static_cast<int8_t*>(y1q),
      static_cast<unsigned*>(smax), static_cast<ttg::bf16*>(out),
      static_cast<cudaStream_t>(stream), slab1 != 0, slab2 != 0,
      y1_half != 0);
}
