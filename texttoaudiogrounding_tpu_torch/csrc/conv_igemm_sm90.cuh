// Rows 3 and 4 of the port, second design (sm_90a): the chunked fused
// PANNs block (conv3x3 -> BN -> ReLU) x 2 -> avg+max pool as a wgmma
// implicit GEMM fed by an asynchronous shared-memory ring.  Row 2's second
// design (conv_block1_v2.cu) runs block 1's conv2 on the same GEMM (MODE
// 3, block 1's bf16 pool) and builds its fused form from its pieces;
// row 4's tri and mel3 (conv_block_tri_v2.cu, conv_block_mel3_v2.cu) run
// it in a slab form, row 5's (pair_conv_pool_v2.cu) as it is and from an
// unpadded source; row 1's (logmel_v2.cu) reuses the ring and the wgmma
// wrappers.
//
// The function and its int8 contract are the first design's (common.cuh
// double_conv): the same chunks tc, the same scale windows, int8 weights
// per output channel folded into the BN affine, int32 sums, the same f32
// epilogue arithmetic in the same order.  Its int8 output is bit for bit
// the first design's.  What changes is how the card gets there:
//
// 1. Scales as wide reductions.  window_max_kernel runs many blocks on
//    each scale window (the whole clip for row 4's per-clip x scale, the
//    chunk's flat pair-row window for row 3); each takes the max of its
//    piece and combines it with atomicMax on the bits of the non-negative
//    float, which is exact and order-free.  The targets are zeroed first,
//    in stream order.  A window that overlaps its neighbour's (row 3's
//    halo) is read by both groups' blocks.
// 2. One wide quantize/gather pass (pad_quant_kernel, one thread per 16
//    output bytes) writes xs [G, tc + 4, M + 2, Cin] with one zero mel
//    column on each side and zero rows outside the clip, so that every
//    tap's A rows are unpredicated 16-byte copies.
// 3. y1's group max in conv1's epilogue: conv1 writes y1 in f32 and
//    atomicMaxes each warp's max into its group's slot (the rows are >= 0
//    after the ReLU, out-of-clip rows 0).  requant_kernel is then one wide
//    elementwise pass, f32 y1 -> mel-padded int8 y1q, with no max pass.
//    In bf16 conv1 writes the mel-padded bf16 y1 that conv2 reads.  Where
//    the contract stores y1 in bf16 before its int8 scale (row 4's mel3,
//    row 5), MODE 4 rounds it in the epilogue, takes the maxes over the
//    rounded values and writes bf16 (half the round trip's bytes).
// 4. igemm_kernel: a 128-row x BN-column output tile per block of two
//    consumer warpgroups (64 rows each), BN the whole Cout up to 256 so
//    that A is staged once for all output channels (two blocks an SM when
//    BN <= 128).  Products are wgmma m64nBNk32 s8 -> s32 or m64nBNk16
//    bf16 -> f32, both operands K-major from shared memory in the 64-byte
//    swizzle layout.  Each K stage is one (tap, 64-byte K chunk); a 4-slot
//    ring in dynamic shared memory is filled by cp.async.cg (16 bytes a
//    copy, every thread), two stages ahead of the products: at stage k the
//    loads of k + 2 overlap the wgmma of k and the tail of k - 1.  Output
//    positions (group, t, mel) are enumerated row-major, so tiles cross
//    group edges and only the last tile of the call is partial; a pool
//    window (mel pair, time pair) still falls inside one tile when 2M
//    divides 128.  The epilogue runs from the accumulator registers: the
//    affine, the ReLU, the pool in the first design's f32 order, and the
//    stores.  Mel pairs are lanes l and l ^ 4; for time pairs (M a multiple
//    of 8) the tile's rows are permuted so that a thread's two fragment
//    rows are the two times of one mel, and the pool needs no shared
//    memory (exchanging time pairs through shared memory, measured first,
//    made conv2 at pool (2, 2) much slower than at (1, 2)).
//
// Bound on the H100: operations (blocks 3 / 4 7.1 / 14.2 GOP of int8 a
// 10 s clip, block 2 7.1).  What the design leaves on the table: the B
// tile (the weights, L2-resident) is staged again for every 128-row tile,
// so each stage moves 8 KB of A and BN x 64 bytes of B from L2; the f32 y1
// still makes a round trip through device memory (the y1 scale is a max
// over the whole chunk); the blocks are not persistent, so each tile fills
// and drains the ring.  A warp-specialized form (a producer warp filling
// mbarrier slots, B or A and B by TMA, the two warpgroups only
// multiplying) gave the same int8 bits but ran slower on the H100.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ttg {

using bf16 = __nv_bfloat16;

namespace v2 {

// clamp(round(v * inv), -127, 127): the f32 reciprocal multiply and round
// half to even of the first design (common.cuh quant_i8), copied so that
// this design builds without the first design's kernels
__device__ __forceinline__ int8_t quant_i8(float v, float inv) {
  float q = rintf(__fmul_rn(v, inv));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

// max over the block of non-negative values; every thread gets the result
__device__ __forceinline__ float block_max(float v) {
  __shared__ float red[32];
  __shared__ float result;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    v = lane < nw ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) result = v;
  }
  __syncthreads();
  return result;
}

constexpr int BM = 128;        // output rows of a tile: two warpgroups
constexpr int NT = 256;        // threads of a GEMM block
constexpr int KB = 64;         // bytes of K of a row in a stage
constexpr int CPR = KB / 16;   // its 16-byte chunks
constexpr int STAGES = 4;      // ring slots
constexpr int AHEAD = STAGES - 2;  // stages loaded ahead of the products

__device__ __forceinline__ float scale_of(unsigned bits) {
  return fmaxf(__uint_as_float(bits), 1e-6f) / 127.0f;
}

__device__ __forceinline__ void max_into(unsigned* slot, float m) {
  // non-negative floats order as their bits; -0.0 is cleared to +0.0
  atomicMax(slot, __float_as_uint(m) & 0x7fffffffu);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}
// 16 bytes, or 16 zero bytes when !full (a source size of 0: nothing is
// read, gmem must still be a valid address)
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of the accumulators across a wait
template <typename A, int R>
__device__ __forceinline__ void fence_acc(A (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (std::is_same<A, int>::value)
      asm volatile("" : "+r"(d[i])::"memory");
    else
      asm volatile("" : "+f"(d[i])::"memory");
  }
}

// A stage holds 64 bytes of K of each row, K-major, in the 64-byte swizzle
// layout: the 16-byte chunk c of row r is stored at chunk c ^ ((r >> 1) & 3)
// of its row, and the hardware applies the same XOR to the address bits it
// reads; 8 rows (512 bytes) are one swizzle atom.  Measured on the H100:
// the no-swizzle core-matrix layout ran the GEMMs slower, and 128-byte
// stages in the 128-byte swizzle were no faster in int8.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * KB) >> 4) << 32) | ((uint64_t)2 << 62);
}
// byte offset in a stage of the 16-byte piece (row, chunk c)
__device__ __forceinline__ int piece_offset(int row, int c) {
  return row * KB + ((c ^ ((row >> 1) & 3)) << 4);
}

// D[64 x N] += A[64 x 32 bytes] B[N x 32 bytes]^T, both K-major in shared
// memory (descriptors da, db), accumulators in the wgmma fragment layout.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


template <typename T, int BN> struct Acc;
template <int BN> struct Acc<int8_t, BN> { using type = int; };
template <int BN> struct Acc<bf16, BN> { using type = float; };

template <typename T, int BN>
__device__ __forceinline__ void wgmma_k32b(
    typename Acc<T, BN>::type (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, int8_t>::value) {
    if constexpr (BN == 64) wgmma_s8_n64(d, da, db);
    else if constexpr (BN == 128) wgmma_s8_n128(d, da, db);
    else wgmma_s8_n256(d, da, db);
  } else {
    if constexpr (BN == 64) wgmma_bf16_n64(d, da, db);
    else if constexpr (BN == 128) wgmma_bf16_n128(d, da, db);
    else wgmma_bf16_n256(d, da, db);
  }
}

struct IgemmArgs {
  const void* src;       // [G, R_in, M + 2, Cin], mel padded with zeros
  const void* wt;        // [Cout, 9 Cin], k = (dt * 3 + dm) * Cin + ci
  const float* alpha;    // [Cout] folded BN scale (x weight scale for int8)
  const float* beta;     // [Cout] folded BN shift
  const unsigned* smax;  // int8: max bits of group g's scale window at
  int scale_div;         //   smax[g / scale_div]; null for bf16
  unsigned* ymax;        // conv1 int8: y1 max bits by group, or null
  void* dst;
  int G, nch, tc, T;     // groups, groups per clip, chunk length, clip length
  int R_in, R_out, M, Cin, Cout;
  int time_off;          // conv1: row r of group (b, j) is time
                         //   j * tc + r + time_off; zero outside [0, T)
  int pt, pm, T_out;     // conv2: pool window, pooled time rows per clip
};

// MODE 0: conv1, f32 y1 [G, R_out, M, Cout] and its group maxes (int8);
// 4: conv1, y1 rounded to bf16 [G, R_out, M, Cout] and the group maxes of
//    the rounded values (int8 with a bf16-stored y1: row 4's mel3 conv2
//    after a mel3 conv1, row 5); rounding to nearest is monotone, so the
//    max of the rounded values is the rounded max and atomicMax on the
//    float bits stays exact;
// 1: conv1, bf16 y1 [G, R_out, M + 2, Cout], mel padded (bf16);
// 2: conv2 -> f32 avg+max pool (mel pairs, then time pairs) -> bf16 out
//    [B, T_out, M / pm, Cout];
// 3: block 1's conv2 (pool (2, 2) only) -> its bf16 pool (common.cuh MODE
//    3, the TPU kernel's order): y2 rounded to bf16, time pairs, then mel
//    pairs, each sum rounded to bf16, out = bf16(S / 4) + max in bf16.
// Two blocks an SM for BN <= 128 (faster on the H100 than one, or than
// 256-row tiles), one for BN = 256 (its accumulators take 128 registers).
//
// SLAB (row 4's tri mode, modes 0-2, pool (1, .), M in {8, 16, 32, 64}):
// the output positions are enumerated in the source's halo-padded space,
// p = (g R_in + r') M + m with R_in = R_out + 2, output row r = r' - 1;
// the rows r' = 0 and R_in - 1 of each group are junk products, computed
// and not stored.  Then every tap is a constant row offset: output p reads
// source (time row, mel) (p / M - 1 + dt, p % M + dm - 1).  A K stage is
// one (dm, 64-byte K chunk): one slab of BM + 2M source rows, flat rows p0
// - M .. p0 + BM + M of the mel-padded source at column mel + dm (the pad
// columns are the mel-edge zeros), staged once, and the three time taps'
// B slices (dt, dm); three wgmma sets read the slab at row offsets dt M,
// a whole number of 8-row swizzle atoms.  Slab rows past either end of
// the source feed only junk rows and are clamped to a valid row.
//
// ZFILL (per-tap form only; row 5's conv2 without conv1): the source is
// unpadded, [G, R_out, M, Cin], and output row r of a group reads time r
// + dt - 1, mel m + dm - 1 of its own group; a tap cell outside the
// group's rows or the mel range is a cp.async of source size 0, which
// fills its 16 bytes with zeros, so no padded copy is written.
constexpr int SLAB_MMAX = 64;  // largest M of the slab form

template <int BN>
__host__ __device__ constexpr int slab_stages() {
  return BN == 256 ? 3 : STAGES;
}
template <int BN>
__host__ __device__ constexpr int slab_smem() {
  return slab_stages<BN>() * ((BM + 2 * SLAB_MMAX) * KB + 3 * BN * KB) +
         1024;
}

template <typename T, int BN, int MODE, bool SLAB = false, bool ZFILL = false>
__global__ void __launch_bounds__(NT, BN <= 128 ? 2 : 1)
    igemm_kernel(IgemmArgs a) {
  static_assert(!(SLAB && ZFILL), "the slab form reads a padded source");
  using AT = typename Acc<T, BN>::type;
  constexpr int ES = sizeof(T);
  constexpr int NS = SLAB ? slab_stages<BN>() : STAGES;  // ring slots
  constexpr int AH = NS - 2;  // stages loaded ahead of the products
  constexpr int A_STAGE = (SLAB ? BM + 2 * SLAB_MMAX : BM) * KB;
  constexpr int B_STAGE = (SLAB ? 3 : 1) * BN * KB;
  constexpr int A_PER_THREAD = A_STAGE / 16 / NT;
  constexpr int B_PER_THREAD = BN * CPR / NT;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms must start on 1024-byte boundaries
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (base & 1023)) & 1023);
  unsigned char* As = smem;
  unsigned char* Bs = smem + NS * A_STAGE;

  const int tid = threadIdx.x, wg = tid >> 7;
  const long long p0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int R_pos = SLAB ? a.R_out + 2 : a.R_out;  // rows a group enumerates
  const long long P = (long long)a.G * R_pos * a.M;
  const int Mp = a.M + 2;
  const long long row_bytes = (long long)a.Cin * ES;
  const int kch = (int)(row_bytes / KB);  // K chunks of a tap
  const int S = (SLAB ? 3 : 9) * kch;     // stages of the tile

  // Tile row k holds position p0 + perm(k).  With time pairs (conv2, pt 2,
  // M a multiple of 8) the rows are permuted so that the two rows a thread
  // holds in the fragment layout, k and k + 8, are times r and r + 1 of
  // one mel, and rows k, k ^ 1 (lanes l, l ^ 4) mels m, m + 1: warp W of
  // the tile takes time pair W / (M / 8), mels 8 (W % (M / 8)) + [0, 8).
  const bool tpair = !SLAB && (MODE == 2 || MODE == 3) && a.pt == 2;
  auto perm = [&](int k) {
    if (!tpair) return k;
    const int W = k >> 4, mg = a.M >> 3;
    return (2 * (W / mg) + ((k >> 3) & 1)) * a.M + (W % mg) * 8 + (k & 7);
  };

  // 16-byte piece q of a stage: row (q / 8 CPR) * 8 + q % 8, chunk
  // (q / 8) % CPR: a warp copies 8 rows x 64 bytes
  const unsigned char* srcb = static_cast<const unsigned char*>(a.src);
  const unsigned char* wtb = static_cast<const unsigned char*>(a.wt);
  long long a_off[A_PER_THREAD];
  int a_dst[A_PER_THREAD];
  int a_r[ZFILL ? A_PER_THREAD : 1], a_m[ZFILL ? A_PER_THREAD : 1];
  const int a_pieces = SLAB ? (BM + 2 * a.M) * CPR : BM * CPR;
#pragma unroll
  for (int i = 0; i < A_PER_THREAD; ++i) {
    const int q = tid + i * NT;
    const int row = (q / (8 * CPR)) * 8 + (q & 7), c = (q >> 3) % CPR;
    if constexpr (SLAB) {
      // slab row: flat source row p0 - M + row (time row, mel)
      long long f = p0 - a.M + row;
      f = f < 0 ? 0 : (f < P ? f : P - 1);
      const long long fr = f / a.M;
      a_off[i] = (fr * Mp + (f - fr * a.M)) * row_bytes + c * 16;
    } else {
      long long p = p0 + perm(row);
      p = p < P ? p : P - 1;  // the partial last tile reads a valid row
      const long long g = p / ((long long)a.R_out * a.M);
      const int rem = (int)(p - g * a.R_out * a.M);
      const int r = rem / a.M, m = rem - (rem / a.M) * a.M;
      if constexpr (ZFILL) {
        a_off[i] = p * row_bytes + c * 16;  // the position's own cell
        a_r[i] = r;
        a_m[i] = m;
      } else {
        a_off[i] = ((g * a.R_in + r) * Mp + m) * row_bytes + c * 16;
      }
    }
    a_dst[i] = piece_offset(row, c);
  }
  const long long w_row = 9 * row_bytes;
  long long b_off[B_PER_THREAD];
  int b_dst[B_PER_THREAD];
#pragma unroll
  for (int i = 0; i < B_PER_THREAD; ++i) {
    const int q = tid + i * NT;
    const int row = (q / (8 * CPR)) * 8 + (q & 7), c = (q >> 3) % CPR;
    b_off[i] = (long long)(n0 + row) * w_row + c * 16;
    b_dst[i] = piece_offset(row, c);
  }
  auto load = [&](int s) {
    unsigned char* as = As + (s % NS) * A_STAGE;
    unsigned char* bs = Bs + (s % NS) * B_STAGE;
    if constexpr (SLAB) {
      const int dm = s / kch, kc = s - (s / kch) * kch;
      const long long slab_a = dm * row_bytes + kc * KB;
#pragma unroll
      for (int i = 0; i < A_PER_THREAD; ++i)
        if (tid + i * NT < a_pieces)
          cp_async16(as + a_dst[i], srcb + a_off[i] + slab_a);
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        const long long tap_b = (dt * 3 + dm) * row_bytes + kc * KB;
#pragma unroll
        for (int i = 0; i < B_PER_THREAD; ++i)
          cp_async16(bs + dt * BN * KB + b_dst[i], wtb + b_off[i] + tap_b);
      }
    } else {
      const int tap = s / kch, kc = s - (s / kch) * kch;
      const int dt = tap / 3, dm = tap - (tap / 3) * 3;
      const long long tap_b = tap * row_bytes + kc * KB;
      if constexpr (ZFILL) {
        const long long tap_a =
            ((long long)(dt - 1) * a.M + dm - 1) * row_bytes + kc * KB;
#pragma unroll
        for (int i = 0; i < A_PER_THREAD; ++i) {
          const int r = a_r[i] + dt - 1, m = a_m[i] + dm - 1;
          const bool in = r >= 0 && r < a.R_out && m >= 0 && m < a.M;
          cp_async16_zfill(as + a_dst[i], srcb + (in ? a_off[i] + tap_a : 0),
                           in);
        }
      } else {
        const long long tap_a = (dt * Mp + dm) * row_bytes + kc * KB;
#pragma unroll
        for (int i = 0; i < A_PER_THREAD; ++i)
          cp_async16(as + a_dst[i], srcb + a_off[i] + tap_a);
      }
#pragma unroll
      for (int i = 0; i < B_PER_THREAD; ++i)
        cp_async16(bs + b_dst[i], wtb + b_off[i] + tap_b);
    }
  };

  AT acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = (AT)0;
  fence_acc(acc);

#pragma unroll
  for (int s = 0; s < AH; ++s) {
    if (s < S) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < S; ++s) {
    cp_async_wait<AH - 1>();  // stage s has landed
    fence_async_shared();     // ... and is visible to the tensor cores
    __syncthreads();          // for both warpgroups; stage s - 2 is free
    if (s + AH < S) load(s + AH);
    cp_async_commit();
    const unsigned char* as = As + (s % NS) * A_STAGE + wg * 64 * KB;
    const unsigned char* bs = Bs + (s % NS) * B_STAGE;
    wgmma_fence();
    if constexpr (SLAB) {
#pragma unroll
      for (int dt = 0; dt < 3; ++dt)  // the time taps: dt M rows on
#pragma unroll
        for (int ks = 0; ks < KB / 32; ++ks)
          wgmma_k32b<T, BN>(acc, smem_desc(as + dt * a.M * KB + ks * 32),
                            smem_desc(bs + dt * BN * KB + ks * 32));
    } else {
#pragma unroll
      for (int ks = 0; ks < KB / 32; ++ks)  // k steps: 32 bytes into the rows
        wgmma_k32b<T, BN>(acc, smem_desc(as + ks * 32),
                          smem_desc(bs + ks * 32));
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // the fragment layout: thread (warp w, lane l) of warpgroup wg holds rows
  // wg * 64 + w * 16 + l / 4 (+ 8 for acc[4 j + 2..3]) and columns
  // 8 j + 2 (l % 4) + {0, 1}
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row0 = wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  long long pr[2], gr[2];
  int rr[2], mr[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pr[h] = p0 + perm(row0 + 8 * h);
    ok[h] = pr[h] < P;
    const long long p = ok[h] ? pr[h] : P - 1;
    gr[h] = p / ((long long)R_pos * a.M);
    const int rem = (int)(p - gr[h] * R_pos * a.M);
    rr[h] = rem / a.M;
    mr[h] = rem - rr[h] * a.M;
    if constexpr (SLAB) {
      // the halo-padded row r' = rr + 1; junk rows are not stored
      ok[h] = ok[h] && rr[h] >= 1 && rr[h] <= a.R_out;
      rr[h] = ok[h] ? rr[h] - 1 : 0;
      pr[h] = (gr[h] * a.R_out + rr[h]) * a.M + mr[h];
    }
  }
  float gs[2] = {1.0f, 1.0f};
  if (a.smax) {
#pragma unroll
    for (int h = 0; h < 2; ++h) gs[h] = scale_of(a.smax[gr[h] / a.scale_div]);
  }
  auto value = [&](int h, int i, int n) {
    const float mul = a.smax ? __fmul_rn(a.alpha[n], gs[h]) : a.alpha[n];
    return __fadd_rn(__fmul_rn((float)acc[i], mul), a.beta[n]);
  };

  if constexpr (MODE == 0 || MODE == 1 || MODE == 4) {
    float rowmax[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = (int)(gr[h] % a.nch) * a.tc + rr[h] + a.time_off;
      const bool in_clip = t >= 0 && t < a.T;
      const long long cell =
          MODE == 1 ? (gr[h] * a.R_out + rr[h]) * Mp + mr[h] + 1 : pr[h];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + col0;
        float y0 = value(h, 4 * j + 2 * h, n);
        float y1 = value(h, 4 * j + 2 * h + 1, n + 1);
        y0 = in_clip ? fmaxf(y0, 0.0f) : 0.0f;
        y1 = in_clip ? fmaxf(y1, 0.0f) : 0.0f;
        if (!ok[h]) continue;
        if constexpr (MODE == 0) {
          rowmax[h] = fmaxf(rowmax[h], fmaxf(y0, y1));
          *reinterpret_cast<float2*>(static_cast<float*>(a.dst) +
                                     cell * a.Cout + n) = make_float2(y0, y1);
        } else if constexpr (MODE == 4) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(y0, y1);
          const float2 f = __bfloat1622float2(v);
          rowmax[h] = fmaxf(rowmax[h], fmaxf(f.x, f.y));
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dst) +
                                             cell * a.Cout + n) = v;
        } else {
          bf16* d = static_cast<bf16*>(a.dst);
          *reinterpret_cast<__nv_bfloat162*>(d + cell * a.Cout + n) =
              __floats2bfloat162_rn(y0, y1);
          const __nv_bfloat162 z = __floats2bfloat162_rn(0.0f, 0.0f);
          if (mr[h] == 0)
            *reinterpret_cast<__nv_bfloat162*>(d + (cell - 1) * a.Cout + n) = z;
          if (mr[h] == a.M - 1)
            *reinterpret_cast<__nv_bfloat162*>(d + (cell + 1) * a.Cout + n) = z;
        }
      }
    }
    if constexpr (MODE == 0 || MODE == 4) {
      // the warp's maxes into their groups: one atomic when the warp's 16
      // rows lie in one group, else one a row (rows past P add 0)
      const unsigned g_lo = (unsigned)gr[0], g_hi = (unsigned)gr[1];
      const unsigned gmin = __reduce_min_sync(0xffffffffu, min(g_lo, g_hi));
      const unsigned gmax = __reduce_max_sync(0xffffffffu, max(g_lo, g_hi));
      if (gmin == gmax) {
        const float m = fmaxf(rowmax[0], rowmax[1]);
        const unsigned bits = __reduce_max_sync(
            0xffffffffu, __float_as_uint(m) & 0x7fffffffu);
        if (lane == 0) atomicMax(a.ymax + gmin, bits);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = rowmax[h];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          if ((lane & 3) == 0) max_into(a.ymax + gr[h], m);
        }
      }
    }
  } else if constexpr (MODE == 3) {
    // a thread's rows h = 0, 1 are one mel's two times, lanes l and l ^ 4
    // the mel pair.  Two columns at a time in bf16x2 arithmetic: a sum of
    // two non-negative bf16 values rounded once to bf16 is the first
    // design's f32 sum rounded to bf16 (exact in f32 when their exponents
    // differ by at most 15, and else far from a bf16 tie), S / 4 is exact,
    // and the order of the operands within a pair does not matter.
    bf16* out = static_cast<bf16*>(a.dst);
    const int b = (int)(gr[0] / a.nch), jc = (int)(gr[0] % a.nch);
    const int tout = (jc * a.tc + rr[0]) / 2;
    const bool lead = ok[0] && (lane & 4) == 0 && tout < a.T_out;
    bf16* d = out + (((long long)b * a.T_out + tout) * (a.M / 2) +
                     mr[0] / 2) * a.Cout + n0 + col0;
    const __nv_bfloat162 quarter = __floats2bfloat162_rn(0.25f, 0.25f);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + col0;
      const __nv_bfloat162 v0 = __floats2bfloat162_rn(
          fmaxf(value(0, 4 * j, n), 0.0f),
          fmaxf(value(0, 4 * j + 1, n + 1), 0.0f));
      const __nv_bfloat162 v1 = __floats2bfloat162_rn(
          fmaxf(value(1, 4 * j + 2, n), 0.0f),
          fmaxf(value(1, 4 * j + 3, n + 1), 0.0f));
      const __nv_bfloat162 s = __hadd2(v0, v1), mx = __hmax2(v0, v1);
      const __nv_bfloat162 S = __hadd2(s, __shfl_xor_sync(0xffffffffu, s, 4));
      const __nv_bfloat162 MX =
          __hmax2(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const __nv_bfloat162 o = __hadd2(__hmul2(S, quarter), MX);
      if (lead) *reinterpret_cast<__nv_bfloat162*>(d + 8 * j) = o;
    }
  } else {
    // conv2: y = ReLU(affine), then sum and max over the mel pair (lanes
    // l and l ^ 4), then over the time pair (the thread's rows h = 0, 1),
    // in the first design's order: sum / (pt pm) + max
    const float inv_win = 1.0f / (float)(a.pt * a.pm);
    const int Mo = a.M / a.pm;
    const bool lead_m = a.pm == 1 || (lane & 4) == 0;  // even mel
    auto mel_pair = [&](int h, int j, int e, float& s, float& mx) {
      const float y = fmaxf(value(h, 4 * j + 2 * h + e, n0 + 8 * j + col0 + e),
                            0.0f);
      if (a.pm == 2) {
        const float o = __shfl_xor_sync(0xffffffffu, y, 4);
        s = __fadd_rn(y, o);
        mx = fmaxf(y, o);
      } else {
        s = mx = y;
      }
    };
    bf16* out = static_cast<bf16*>(a.dst);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && a.pt == 2) break;  // row 1 is row 0's second time
      const int b = (int)(gr[h] / a.nch), jc = (int)(gr[h] % a.nch);
      const int tout = (jc * a.tc + rr[h]) / a.pt;
      // past the clip (ragged last chunk) or past P: no store
      const bool lead = ok[h] && lead_m && tout < a.T_out;
      bf16* d = out + (((long long)b * a.T_out + tout) * Mo + mr[h] / a.pm) *
                          a.Cout + n0 + col0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float S, MX;
          mel_pair(h, j, e, S, MX);
          if (a.pt == 2) {
            float s1, mx1;
            mel_pair(1, j, e, s1, mx1);
            S = __fadd_rn(S, s1);
            MX = fmaxf(MX, mx1);
          }
          o[e] = __fadd_rn(__fmul_rn(S, inv_win), MX);
        }
        if (lead)
          *reinterpret_cast<__nv_bfloat162*>(d + 8 * j) =
              __floats2bfloat162_rn(o[0], o[1]);
      }
    }
  }
}

// Dynamic shared memory of a GEMM block: the ring and 1024 bytes to align
// it.
template <int BN>
constexpr int igemm_smem() { return STAGES * (BM + BN) * KB + 1024; }

// static: internal linkage, so that each library built from a source that
// includes this header keeps its own flag.  The local static of an inline
// function is one object (a GNU unique symbol) across all the libraries a
// process loads, and a kernel of the second library to launch the same
// instantiation would be launched without its shared-memory attribute.
template <typename T, int BN, int MODE, bool SLAB = false, bool ZFILL = false>
static cudaError_t launch_igemm_bn(const IgemmArgs& a, cudaStream_t st) {
  constexpr int smem = SLAB ? slab_smem<BN>() : igemm_smem<BN>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        igemm_kernel<T, BN, MODE, SLAB, ZFILL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long P = (long long)a.G * (SLAB ? a.R_out + 2 : a.R_out) * a.M;
  dim3 grid((unsigned)((P + BM - 1) / BM), (unsigned)(a.Cout / BN));
  igemm_kernel<T, BN, MODE, SLAB, ZFILL><<<grid, NT, smem, st>>>(a);
  return cudaGetLastError();
}

// BN: the whole Cout up to 256 (Cout is a multiple of 64)
template <typename T, int MODE, bool SLAB = false, bool ZFILL = false>
inline cudaError_t launch_igemm(const IgemmArgs& a, cudaStream_t st) {
  if (a.Cout % 256 == 0)
    return launch_igemm_bn<T, 256, MODE, SLAB, ZFILL>(a, st);
  if (a.Cout % 128 == 0)
    return launch_igemm_bn<T, 128, MODE, SLAB, ZFILL>(a, st);
  return launch_igemm_bn<T, 64, MODE, SLAB, ZFILL>(a, st);
}

// the per-tap GEMM, or the slab form where it takes the conv: M a multiple
// of 8 up to SLAB_MMAX (whole swizzle atoms of offset), no time pairs;
// SLABS builds the slab form (only the sources that launch it)
template <typename T, int MODE, bool SLABS>
inline cudaError_t launch_conv(const IgemmArgs& a, bool slab,
                               cudaStream_t st) {
  if (!slab) return launch_igemm<T, MODE>(a, st);
  if (!SLABS || a.M % 8 || a.M > SLAB_MMAX || (MODE == 2 && a.pt != 1))
    return cudaErrorInvalidValue;
  if constexpr (SLABS) return launch_igemm<T, MODE, true>(a, st);
  return cudaErrorInvalidValue;
}

// max |x| over piece blockIdx.x of group blockIdx.y's window, the flat
// elements [j * win_step + win_lo, j * win_step + win_hi) of clip b (g =
// b * nch + j), clipped to the clip; into smax[g] by atomicMax.  Window
// edges and pieces are multiples of 8 elements (16-byte loads).
__global__ void window_max_kernel(const bf16* __restrict__ x,
                                  unsigned* __restrict__ smax, int nch,
                                  long long clip_len, long long win_step,
                                  long long win_lo, long long win_hi,
                                  long long piece) {
  const int g = blockIdx.y;
  const long long b = g / nch, j = g % nch;
  long long lo = j * win_step + win_lo, hi = j * win_step + win_hi;
  lo = lo < 0 ? 0 : lo;
  hi = hi > clip_len ? clip_len : hi;
  const long long a0 = lo + blockIdx.x * piece;
  const long long a1 = a0 + piece < hi ? a0 + piece : hi;
  const bf16* clip = x + b * clip_len;
  float m = 0.0f;
  for (long long e = a0 + 8 * (long long)threadIdx.x; e < a1;
       e += 8 * (long long)blockDim.x) {
    const uint4 v = *reinterpret_cast<const uint4*>(clip + e);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  m = block_max(m);
  if (threadIdx.x == 0 && a0 < a1) max_into(smax + g, m);
}

// xs [G, R, M + 2, Cin]: row r of group g = b * nch + j is time
// j * tc + r - 2 of clip b, mel column mp is mel mp - 1; zero outside the
// clip and in the two pad columns.  QUANT: int8 with the scale of
// smax[g / scale_div].  One thread per 16 output bytes.
template <typename Td, bool QUANT>
__global__ void pad_quant_kernel(const bf16* __restrict__ x,
                                 Td* __restrict__ xs,
                                 const unsigned* __restrict__ smax,
                                 int scale_div, int nch, int T, int M,
                                 int Cin, int tc, int R, long long nvec) {
  constexpr int EV = 16 / sizeof(Td);  // elements of a 16-byte output piece
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nvec) return;
  const int vpc = Cin / EV;            // pieces of a cell
  const long long cell = v / vpc;
  const int c = (int)(v - cell * vpc) * EV;
  const int Mp = M + 2;
  const long long gr = cell / Mp;
  const int mp = (int)(cell - gr * Mp);
  const long long g = gr / R;
  const int r = (int)(gr - g * R);
  const int t = (int)(g % nch) * tc + r - 2;
  const long long b = g / nch;
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (t >= 0 && t < T && mp >= 1 && mp <= M) {
    const bf16* s = x + (((b * T + t) * M) + mp - 1) * (long long)Cin + c;
    if constexpr (QUANT) {
      const float inv = 1.0f / scale_of(smax[g / scale_div]);
      const uint4 u0 = *reinterpret_cast<const uint4*>(s);
      const uint4 u1 = *reinterpret_cast<const uint4*>(s + 8);
      const __nv_bfloat162* h0 = reinterpret_cast<const __nv_bfloat162*>(&u0);
      const __nv_bfloat162* h1 = reinterpret_cast<const __nv_bfloat162*>(&u1);
      int8_t* q = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f0 = __bfloat1622float2(h0[k]);
        const float2 f1 = __bfloat1622float2(h1[k]);
        q[2 * k] = quant_i8(f0.x, inv);
        q[2 * k + 1] = quant_i8(f0.y, inv);
        q[8 + 2 * k] = quant_i8(f1.x, inv);
        q[8 + 2 * k + 1] = quant_i8(f1.y, inv);
      }
    } else {
      out = *reinterpret_cast<const uint4*>(s);
    }
  }
  reinterpret_cast<uint4*>(xs)[v] = out;
}

// 16 consecutive values as f32
__device__ __forceinline__ void load16(const float* s, float (&f)[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 v = reinterpret_cast<const float4*>(s)[k];
    f[4 * k] = v.x;
    f[4 * k + 1] = v.y;
    f[4 * k + 2] = v.z;
    f[4 * k + 3] = v.w;
  }
}
__device__ __forceinline__ void load16(const bf16* s, float (&f)[16]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint4 u = reinterpret_cast<const uint4*>(s)[k];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[8 * k + 2 * i] = v.x;
      f[8 * k + 2 * i + 1] = v.y;
    }
  }
}

// y1q [G, R, M + 2, C] int8 from conv1's y1 [G, R, M, C] (f32, or bf16
// from MODE 4) with the group's scale from ymax[g]; zero pad columns.  One
// thread per 16 bytes.
template <typename Ts>
__global__ void requant_kernel(const Ts* __restrict__ y1,
                               int8_t* __restrict__ y1q,
                               const unsigned* __restrict__ ymax, int R,
                               int M, int C, long long nvec) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nvec) return;
  const int vpc = C / 16;
  const long long cell = v / vpc;
  const int c = (int)(v - cell * vpc) * 16;
  const int Mp = M + 2;
  const long long gr = cell / Mp;
  const int mp = (int)(cell - gr * Mp);
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (mp >= 1 && mp <= M) {
    const long long g = gr / R;
    const float inv = 1.0f / scale_of(ymax[g]);
    float f[16];
    load16(y1 + (gr * M + mp - 1) * (long long)C + c, f);
    int8_t* q = reinterpret_cast<int8_t*>(&out);
#pragma unroll
    for (int k = 0; k < 16; ++k) q[k] = quant_i8(f[k], inv);
  }
  reinterpret_cast<uint4*>(y1q)[v] = out;
}

inline unsigned blocks_for(long long n, int per) {
  return (unsigned)((n + per - 1) / per);
}

// The chunked block of the first design's double_conv, in this design.
//   x    [B, T, M, Cin] bf16; the last chunk may be ragged
//   w1   [Cout, 9 Cin], w2 [Cout, 9 Cout]: int8 (quant) or bf16
//   a*, b*: [Cout] f32 (int8: BN scale x per-channel weight scale)
//   xs   [G, tc + 4, M + 2, Cin] scratch, int8 or bf16 (G = B ceil(T / tc))
//   y1   scratch: f32 [G, tc + 2, M, Cout] (quant), bf16 [G, tc + 2, M,
//        Cout] (quant with y1_half) or bf16 [G, tc + 2, M + 2, Cout]
//   y1q  [G, tc + 2, M + 2, Cout] int8 scratch (quant only)
//   smax [nsx + G] unsigned scratch (quant only): the x maxes (nsx = B per
//        clip, or G), then the y1 maxes
//   out  [B, T / pt, M / pm, Cout] bf16
// The x scale of group (b, j) is over the flat element window
// [j * win_step + win_lo, j * win_step + win_hi) of clip b; per_clip: one
// window a clip, [0, T M Cin), shared by its chunks.  slab1 / slab2 run
// conv1 / conv2 in the slab form (SLABS builds it); y1_half (int8) stores
// y1 rounded to bf16 and takes its scale over the rounded values (MODE 4,
// which HALFS builds).
template <bool SLABS = false, bool HALFS = false>
inline cudaError_t double_conv(bool quant, const bf16* x, int B, int T, int M,
                               int Cin, int Cout, int tc, int pt, int pm,
                               bool per_clip, long long win_step,
                               long long win_lo, long long win_hi,
                               const void* w1, const float* a1,
                               const float* b1, const void* w2,
                               const float* a2, const float* b2, void* xs,
                               void* y1, int8_t* y1q, unsigned* smax,
                               bf16* out, cudaStream_t st,
                               bool slab1 = false, bool slab2 = false,
                               bool y1_half = false) {
  if (y1_half && !(HALFS && quant)) return cudaErrorInvalidValue;
  const int nch = (T + tc - 1) / tc, G = B * nch;
  const long long clip_len = (long long)T * M * Cin;
  const int nsx = per_clip ? B : G;
  unsigned* ymax = smax + nsx;
  cudaError_t e;
#define TTG_CHECK(...) \
  if ((e = (__VA_ARGS__)) != cudaSuccess) return e;
  if (quant) {
    TTG_CHECK(cudaMemsetAsync(smax, 0, sizeof(unsigned) * (nsx + G), st));
    const long long piece = 8192;
    long long span = per_clip ? clip_len : win_hi - win_lo;
    span = span < clip_len ? span : clip_len;
    dim3 grid(blocks_for(span, (int)piece), nsx);
    if (per_clip)
      window_max_kernel<<<grid, 256, 0, st>>>(x, smax, 1, clip_len, 0, 0,
                                              clip_len, piece);
    else
      window_max_kernel<<<grid, 256, 0, st>>>(x, smax, nch, clip_len,
                                              win_step, win_lo, win_hi,
                                              piece);
    TTG_CHECK(cudaGetLastError());
  }
  const int R1 = tc + 4, R2 = tc + 2;
  {
    const long long cells = (long long)G * R1 * (M + 2);
    const long long nvec = cells * Cin * (quant ? 1 : 2) / 16;
    if (quant)
      pad_quant_kernel<int8_t, true><<<blocks_for(nvec, 256), 256, 0, st>>>(
          x, static_cast<int8_t*>(xs), smax, per_clip ? nch : 1, nch, T, M,
          Cin, tc, R1, nvec);
    else
      pad_quant_kernel<bf16, false><<<blocks_for(nvec, 256), 256, 0, st>>>(
          x, static_cast<bf16*>(xs), nullptr, 1, nch, T, M, Cin, tc, R1,
          nvec);
    TTG_CHECK(cudaGetLastError());
  }
  IgemmArgs c1{};
  c1.src = xs;
  c1.wt = w1;
  c1.alpha = a1;
  c1.beta = b1;
  c1.smax = quant ? smax : nullptr;
  c1.scale_div = per_clip ? nch : 1;
  c1.ymax = quant ? ymax : nullptr;
  c1.dst = y1;
  c1.G = G;
  c1.nch = nch;
  c1.tc = tc;
  c1.T = T;
  c1.R_in = R1;
  c1.R_out = R2;
  c1.M = M;
  c1.Cin = Cin;
  c1.Cout = Cout;
  c1.time_off = -1;
  c1.pt = c1.pm = 1;
  TTG_CHECK(!quant    ? launch_conv<bf16, 1, SLABS>(c1, slab1, st)
            : y1_half ? launch_conv<int8_t, HALFS ? 4 : 0, SLABS>(c1, slab1,
                                                                 st)
                      : launch_conv<int8_t, 0, SLABS>(c1, slab1, st));
  if (quant) {
    const long long nvec = (long long)G * R2 * (M + 2) * Cout / 16;
    const unsigned nb = blocks_for(nvec, 256);
    if (y1_half)
      requant_kernel<<<nb, 256, 0, st>>>(static_cast<const bf16*>(y1), y1q,
                                         ymax, R2, M, Cout, nvec);
    else
      requant_kernel<<<nb, 256, 0, st>>>(static_cast<const float*>(y1), y1q,
                                         ymax, R2, M, Cout, nvec);
    TTG_CHECK(cudaGetLastError());
  }
  IgemmArgs c2 = c1;
  c2.src = quant ? static_cast<const void*>(y1q) : y1;
  c2.wt = w2;
  c2.alpha = a2;
  c2.beta = b2;
  c2.smax = quant ? ymax : nullptr;
  c2.scale_div = 1;
  c2.ymax = nullptr;
  c2.dst = out;
  c2.R_in = R2;
  c2.R_out = tc;
  c2.Cin = Cout;
  c2.time_off = 0;
  c2.pt = pt;
  c2.pm = pm;
  c2.T_out = T / pt;
  TTG_CHECK(quant ? launch_conv<int8_t, 2, SLABS>(c2, slab2, st)
                  : launch_conv<bf16, 2, SLABS>(c2, slab2, st));
#undef TTG_CHECK
  return cudaSuccess;
}

}  // namespace v2
}  // namespace ttg
