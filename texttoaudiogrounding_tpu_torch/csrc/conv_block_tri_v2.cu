// Row 4's tri tap mode, second design: the chunked fused PANNs block
// (conv3x3 -> BN -> ReLU) x 2 -> avg+max pool with a tri conv run as the
// slab form of conv_igemm_sm90.cuh's wgmma implicit GEMM (design notes
// there, igemm_kernel SLAB).
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/conv_block.py:370
// fused_double_conv_pool in its tri mode (:191 _tri_build1, :212
// _tri_build2, :235 _conv3): a mel-im2col of K = 3 Cin and three time-tap
// dots.  tri's int8 scales are direct9's (a per-clip x scale, a per-chunk
// scale over conv1's f32 rows), so the block is direct9's pipeline at
// tri's chunk (window_max_kernel, pad_quant_kernel, requant_kernel and the
// epilogues, reused as they are) with each tri conv's GEMM in the slab
// form: one K stage is one (dm, 64-byte K chunk), a slab of 128 + 2M rows
// staged once by cp.async and read by three wgmma sets at row offsets dt
// M.  Its int8 result is direct9's at the same chunk, bit for bit, and so
// the first tri design's (conv_block_mel3.cu) and the plain version's.
//
// Bound on the H100: operations, as direct9's (9 Cin Cout products an
// output row: blocks 3 / 4 7.1 / 14.2 GOP of int8 a 10 s clip).  Against
// direct9's GEMM the slab moves 3 (128 + 2M) rows of A for each 64-byte
// K chunk instead of 9 x 128, and the same B; B (the three weight slices,
// 3 BN x 64 bytes a stage) is the larger share, so the ring holds 3
// stages at BN = 256.  Halo rows enumerated with the group's rows are
// junk products: 2 of tc + 4 (conv1), 2 of tc + 2 (conv2).
#include "conv_igemm_sm90.cuh"

// slab1 / slab2: conv1 / conv2 in the slab form (M a multiple of 8 up to
// 64; conv2 only at pool (1, .)); a conv not in it runs direct9's GEMM.
// Buffers as ttg_conv_block_v2's.
extern "C" int ttg_conv_block_tri_v2(int quant, int slab1, int slab2,
                                     const void* x, int B, int T, int M,
                                     int Cin, int Cout, int tc, int pt,
                                     int pm, const void* w1, const float* a1,
                                     const float* b1, const void* w2,
                                     const float* a2, const float* b2,
                                     void* xs, void* y1, void* y1q,
                                     void* smax, void* out, void* stream) {
  return (int)ttg::v2::double_conv<true>(
      quant != 0, static_cast<const ttg::bf16*>(x), B, T, M, Cin, Cout, tc,
      pt, pm, true, 0, 0, 0, w1, a1, b1, w2, a2, b2, xs, y1,
      static_cast<int8_t*>(y1q), static_cast<unsigned*>(smax),
      static_cast<ttg::bf16*>(out), static_cast<cudaStream_t>(stream),
      slab1 != 0, slab2 != 0);
}
