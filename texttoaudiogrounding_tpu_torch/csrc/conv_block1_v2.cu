// Row 2 of the port, second design (sm_90a): PANNs block 1 (1 -> 64 -> 64,
// 2 x 2 avg+max pool) at M = 64 mels, with conv2 on the wgmma implicit
// GEMM of conv_igemm_sm90.cuh.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/conv_block1_pair.py:346
// fused_block1_pair in its three modes ("conv1", False, True) and both
// stagings (:239 _kernel_single is the y1 scale window of halo 2).  The
// function and its arithmetic are the first design's (conv_block1_pair.cu),
// bit for bit up to conv2's sums: conv1 and the int8 scales are the same
// operations in the same order, and under True conv2's int32 sums are
// exact, so the int8 mode equals the first design and the plain version.
// What changes is how the card gets there:
//
// 1. The per-clip x scale ("conv1", True) is window_max_kernel's wide max
//    (many blocks a clip, atomicMax on the float bits) instead of one block
//    a clip; conv1 turns the max into the first design's bf16 scale,
//    bf16(max(m, bf16(1e-6)) / 127), and its bf16 reciprocal.
// 2. conv1 stays on the CUDA cores (K = 9, Cin = 1): a block takes TT rows
//    of one group, x staged in shared memory once (int8 with the clip's
//    scale, or bf16); thread (mel, 8 channels) walks the rows.  In int8 the
//    nine taps of a cell are packed into three words and each channel's
//    sum is three dp4a (exact int32, as the first design's IMADs).  It
//    writes y1 straight into the mel-padded layout conv2's GEMM reads,
//    [G, R, M + 2, 64] with zero pad columns, 16 (bf16) or 8 (int8) bytes a
//    thread:
//    - False: bf16 y1 of the whole clip, rows at times [-1, 2 (T / 2)],
//      zero outside the clip (conv2's zero padding);
//    - True: conv1 runs twice per chunk instead of writing f32 y1.  The
//      first pass (OUT_MAX) only takes the chunk's y1 max over the rows of
//      its scale window, times [j tc - halo, j tc + tc + halo), out-of-clip
//      rows included (their values come from the zero-padded input and the
//      BN shift, as in the first design), into ymax[g] by atomicMax; the
//      second (OUT_Q8) recomputes the tc + 2 rows conv2 reads and writes
//      them as int8 with the chunk's scale, out-of-clip rows zero.  The
//      f32 y1 round trip of the first design (16 MB a clip each way) and
//      its requantize pass are gone; conv1 is ~0.04 GOP a clip.
// 3. conv2 is igemm_kernel MODE 3 (BN = Cout = 64, two blocks an SM): bf16
//    or s8 wgmma from the 64-byte-swizzled cp.async ring; a tile is one time
//    pair x 64 mels, so every pool window lies inside it, and the epilogue
//    pools in block 1's bf16 order from the accumulator registers.
// 4. "conv1" mode runs fused instead (b1_fused_kernel): a persistent block
//    computes each tile's y1 halo with the same dp4a conv1 into shared
//    memory and runs conv2 from there (notes at the kernel), so y1 makes no
//    round trip.  False and True run conv1 and conv2 in two launches: False
//    has no int8 conv1 to fuse, and under True a fused form was slower on
//    the H100 (its conv1 also quantizes; PERF.md §6).
//
// Bound on the H100: operations (conv2 4.8 GFLOP of bf16 a 10 s clip,
// 4.8 us at 989 TFLOP/s; int8 2.4 us) against 2.2 MB of input and output.
// What this design leaves on the table: in two launches y1 makes one
// round trip through device memory (8.5 MB a clip in bf16, 4.3 MB in
// int8); the fused form instead computes conv1 twice a row (a tile's four
// halo rows for its two output rows), and the eight warps that issue its
// products also run its producer and its epilogue, whose CUDA-core work
// outlasts the tile's tensor work (PERF.md §6).
#include "conv_igemm_sm90.cuh"

namespace {

using ttg::bf16;
namespace v2 = ttg::v2;

constexpr int M = 64, C = 64, MP = M + 2, TT = 16, NT1 = 512;
enum { OUT_BF16 = 0, OUT_MAX = 1, OUT_Q8 = 2 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Block 1's 2 x 2 pool of two columns of y2 (bf16, >= 0) over the lanes
// l ^ 4 (time pair) and l ^ 8 (mel pair), in bf16x2 arithmetic: a sum of
// two non-negative bf16 values rounded once to bf16 is the first design's
// f32 sum rounded to bf16 (it is exact in f32 when their exponents differ
// by at most 15, and else far from a bf16 tie), and S / 4 is exact.
__device__ __forceinline__ __nv_bfloat162 pool4(__nv_bfloat162 v) {
  const __nv_bfloat162 vt = __shfl_xor_sync(0xffffffffu, v, 4);
  const __nv_bfloat162 s = __hadd2(v, vt), mx = __hmax2(v, vt);
  const __nv_bfloat162 S = __hadd2(s, __shfl_xor_sync(0xffffffffu, s, 8));
  const __nv_bfloat162 MX = __hmax2(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
  return __hadd2(__hmul2(S, __floats2bfloat162_rn(0.25f, 0.25f)), MX);
}

// Row r of group g = b * nch + j is time j * tc + r + toff of clip b; the
// block takes rows [blockIdx.x TT, + TT) of group blockIdx.y, thread (mel
// tid / 8, channels 8 (tid % 8) + [0, 8)).
//   OUT_BF16 (False): bf16 x (w1 bf16 [9, C], a1 [C]), bf16 y1 into dst
//             [G, R, MP, C], zero outside [0, T);
//   True, x int8 with the clip's scale from xmax[b] (w1 int8 [64 mel, 9, C],
//   a1 [64 mel, C]):
//   OUT_MAX:  the group's max of y1 (every row) into ymax[g];
//   OUT_Q8:   int8 y1 with the scale of ymax[g] into dst, zero outside.
template <int OUT>
__global__ void __launch_bounds__(NT1)
    b1_conv1_kernel(const bf16* __restrict__ x, const void* __restrict__ w1,
                    const float* __restrict__ a1,
                    const float* __restrict__ b1,
                    const unsigned* __restrict__ xmax,
                    unsigned* __restrict__ ymax, void* __restrict__ dst,
                    int T, int nch, int tc, int R, int toff) {
  // x of rows r0 - 1 .. r0 + TT (times t0 - 1 ..), mels -1 .. 64
  __shared__ float xs[TT + 2][MP];
  __shared__ unsigned rw[TT + 2][M];  // int8: bytes x[m - 1], x[m], x[m + 1]
  constexpr bool QX = OUT != OUT_BF16;
  const int g = blockIdx.y, b = g / nch, r0 = blockIdx.x * TT;
  const int t0 = (g % nch) * tc + r0 + toff, tid = threadIdx.x;
  float sx = 1.0f, inv = 1.0f;
  if (QX) {
    // the first design's clip_scale_kernel arithmetic, in bf16
    const float mm = fmaxf(__uint_as_float(xmax[b]), round_bf16(1e-6f));
    sx = round_bf16(mm / 127.0f);
    inv = round_bf16(1.0f / sx);
  }
  for (int i = tid; i < (TT + 2) * MP; i += NT1) {
    const int tt = i / MP, mm = i - (i / MP) * MP;
    const int t = t0 - 1 + tt, m = mm - 1;
    float v = 0.0f;
    if (t >= 0 && t < T && m >= 0 && m < M) {
      v = __bfloat162float(x[((long long)b * T + t) * M + m]);
      if (QX) v = (float)v2::quant_i8(v, inv);
    }
    xs[tt][mm] = v;
  }
  __syncthreads();
  if (QX) {
    for (int i = tid; i < (TT + 2) * M; i += NT1) {
      const int tt = i / M, m = i - (i / M) * M;
      const unsigned q0 = (unsigned)(__float2int_rn(xs[tt][m]) & 0xff);
      const unsigned q1 = (unsigned)(__float2int_rn(xs[tt][m + 1]) & 0xff);
      const unsigned q2 = (unsigned)(__float2int_rn(xs[tt][m + 2]) & 0xff);
      rw[tt][m] = q0 | (q1 << 8) | (q2 << 16);
    }
    __syncthreads();
  }

  const int m = tid >> 3, c0 = (tid & 7) * 8;
  float mul[8], beta[8];
  int wp[3][8];       // int8: channel i's taps 0-3, 4-7, 8 packed
  float wf[9][8];     // bf16: tap k of channel i
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    beta[i] = b1[c0 + i];
    mul[i] = QX ? __fmul_rn(a1[m * C + c0 + i], sx) : a1[c0 + i];
  }
  if (QX) {
    const int8_t* w = static_cast<const int8_t*>(w1) + m * 9 * C + c0;
    unsigned long long tap[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      tap[k] = *reinterpret_cast<const unsigned long long*>(w + k * C);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      auto byte = [&](int k) { return (unsigned)(tap[k] >> (8 * i)) & 0xffu; };
      wp[0][i] = (int)(byte(0) | (byte(1) << 8) | (byte(2) << 16) |
                       (byte(3) << 24));
      wp[1][i] = (int)(byte(4) | (byte(5) << 8) | (byte(6) << 16) |
                       (byte(7) << 24));
      wp[2][i] = (int)byte(8);
    }
  } else {
    const bf16* w = static_cast<const bf16*>(w1) + c0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const uint4 u = *reinterpret_cast<const uint4*>(w + k * C);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        wf[k][2 * i] = f.x;
        wf[k][2 * i + 1] = f.y;
      }
    }
  }
  float qinv = 1.0f;
  if (OUT == OUT_Q8) qinv = 1.0f / v2::scale_of(ymax[g]);

  float vmax = 0.0f;
  const int nrows = min(TT, R - r0);
  for (int tt = 0; tt < nrows; ++tt) {
    const int r = r0 + tt, t = t0 + tt;
    const bool in_clip = t >= 0 && t < T;
    float y[8];
    if (QX) {
      const unsigned x0 = rw[tt][m], x1 = rw[tt + 1][m], x2 = rw[tt + 2][m];
      const int p0 = (int)__byte_perm(x0, x1, 0x4210);  // taps 0-3
      const int p1 = (int)__byte_perm(x1, x2, 0x5421);  // taps 4-7
      const int p2 = (int)__byte_perm(x2, 0u, 0x4442);  // tap 8
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int acc = __dp4a(p0, wp[0][i],
                               __dp4a(p1, wp[1][i], __dp4a(p2, wp[2][i], 0)));
        y[i] = fmaxf(__fadd_rn(__fmul_rn((float)acc, mul[i]), beta[i]), 0.0f);
      }
    } else {
      float xv[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) xv[k] = xs[tt + k / 3][m + k % 3];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 9; ++k) acc = fmaf(xv[k], wf[k][i], acc);
        y[i] = fmaxf(__fadd_rn(__fmul_rn(acc, mul[i]), beta[i]), 0.0f);
      }
    }
    if (OUT == OUT_MAX) {
#pragma unroll
      for (int i = 0; i < 8; ++i) vmax = fmaxf(vmax, y[i]);
      continue;
    }
    const long long cell = ((long long)g * R + r) * MP + m + 1;
    if (OUT == OUT_BF16) {
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
      if (in_clip) {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h[i] = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      }
      bf16* d = static_cast<bf16*>(dst) + cell * C + c0;
      *reinterpret_cast<uint4*>(d) = o;
      if (m == 0) *reinterpret_cast<uint4*>(d - C) = make_uint4(0u, 0u, 0u, 0u);
      if (m == M - 1)
        *reinterpret_cast<uint4*>(d + C) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint2 o = make_uint2(0u, 0u);
      if (in_clip) {
        int8_t* q = reinterpret_cast<int8_t*>(&o);
#pragma unroll
        for (int i = 0; i < 8; ++i) q[i] = v2::quant_i8(y[i], qinv);
      }
      int8_t* d = static_cast<int8_t*>(dst) + cell * C + c0;
      *reinterpret_cast<uint2*>(d) = o;
      if (m == 0) *reinterpret_cast<uint2*>(d - C) = make_uint2(0u, 0u);
      if (m == M - 1) *reinterpret_cast<uint2*>(d + C) = make_uint2(0u, 0u);
    }
  }
  if (OUT == OUT_MAX) {
    vmax = v2::block_max(vmax);
    if (tid == 0 && nrows > 0) v2::max_into(ymax + g, vmax);
  }
}

template <int OUT>
cudaError_t launch_conv1(const bf16* x, const void* w1, const float* a1,
                         const float* b1, const unsigned* xmax,
                         unsigned* ymax, void* dst, int G, int T, int nch,
                         int tc, int R, int toff, cudaStream_t st) {
  dim3 grid((unsigned)((R + TT - 1) / TT), (unsigned)G);
  b1_conv1_kernel<OUT><<<grid, NT1, 0, st>>>(x, w1, a1, b1, xmax, ymax, dst,
                                            T, nch, tc, R, toff);
  return cudaGetLastError();
}

// ---- the fused form of "conv1" mode: conv1 inside the GEMM block
//
// A persistent block stages w2 once and walks output tiles of one time
// pair (t0, t0 + 1) x 64 mels x 64 channels.  For each tile it computes
// y1's halo, times t0 - 1 .. t0 + 2 at all 64 mels, with conv1 on the CUDA
// cores (dp4a, as b1_conv1_kernel), rounded to bf16, into shared memory;
// conv2 reads it there through wgmma descriptors, so y1 never reaches
// device memory.  The halo is kept in three copies, one a time tap dt, each
// holding times (t0 - 1 + dt, t0 + dt) in the no-swizzle K-major
// core-matrix layout [chunk c][mel + 1][time of the pair][16 bytes]: a
// core matrix is 8 rows of 16 bytes, here 4 mels x 2 times, so tap (dt,
// dm) of a warpgroup's 64 rows is one descriptor at copy dt, offset dm
// mels (LBO = one chunk, SBO = 4 mels).  Accumulator rows k and k ^ 1 of
// a thread's 8-row group (lanes l, l ^ 4) are then one mel's two times and
// k, k ^ 2 (lanes l, l ^ 8) a mel pair, so the pool is two shuffles.  The
// next tile's halo goes into the other buffer while the tensor cores run
// this tile's products.
constexpr int FNT = 256;
constexpr int HCH = MP * 32;      // a 16-byte channel chunk of a halo copy

namespace fused {
constexpr int NCH = C * 2 / 16;         // 16-byte chunks of a bf16 cell
constexpr int CPY = NCH * HCH;          // one halo copy
constexpr int HALO = 3 * CPY;           // copies dt = 0, 1, 2
constexpr int KCH = 9 * NCH;            // 16-byte K chunks of w2's rows
constexpr int BS = KCH * C * 16;        // w2 in shared memory
constexpr int KK = NCH / 2;             // wgmma k steps of a tap
constexpr int SMEM = BS + 2 * HALO + 6 * M * 4 + 128;
}  // namespace fused

// no-swizzle (interleaved) K-major descriptor at shared address a
__device__ __forceinline__ uint64_t desc_ns(unsigned a, unsigned lbo,
                                            unsigned sbo) {
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__global__ void __launch_bounds__(FNT, 1)
    b1_fused_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w1,
                    const float* __restrict__ a1, const float* __restrict__ b1,
                    const void* __restrict__ w2, const float* __restrict__ a2,
                    const float* __restrict__ b2,
                    const unsigned* __restrict__ xmax, bf16* __restrict__ out,
                    int T, int ntiles) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = (unsigned)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + ((128 - (raw & 127)) & 127);
  unsigned char* Bs = smem;                         // [KCH][C][16]
  unsigned char* H = smem + fused::BS;              // two halo buffers
  unsigned* rw = reinterpret_cast<unsigned*>(H + 2 * fused::HALO);  // [6][M]
  const unsigned bs_a = (unsigned)__cvta_generic_to_shared(Bs);
  const unsigned h_a = (unsigned)__cvta_generic_to_shared(H);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, T_out = T / 2;

  {
    const uint4* src = static_cast<const uint4*>(w2);
    for (int i = tid; i < C * fused::KCH; i += FNT) {
      const int n = i / fused::KCH, c = i - n * fused::KCH;
      *reinterpret_cast<uint4*>(Bs + (c * C + n) * 16) = src[i];
    }
    for (int i = tid; i < 2 * fused::HALO / 16; i += FNT)  // pad mels stay 0
      reinterpret_cast<uint4*>(H)[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  // the producer's thread: mel m, 16 channels (chunks cg and cg + 4 of 8
  // bf16); its conv1 weights packed for dp4a
  const int m = tid & (M - 1), cg = tid >> 6;
  auto chan = [&](int i) { return i < 8 ? 8 * cg + i : 8 * (cg + 4) + i - 8; };
  int wp[3][16];
  float be[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    unsigned p[3] = {0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 9; ++k)
      p[k / 4] |= (unsigned)(unsigned char)w1[(m * 9 + k) * C + chan(i)]
                  << (8 * (k % 4));
    wp[0][i] = (int)p[0];
    wp[1][i] = (int)p[1];
    wp[2][i] = (int)p[2];
    be[i] = b1[chan(i)];
  }

  // y1's halo of tile `tile` (clip tile / (T / 2), times t0 - 1 .. t0 + 2)
  // into halo buffer `buf`
  auto produce = [&](int tile, int buf) {
    const int b = tile / T_out, t0 = 2 * (tile % T_out);
    const float mm = fmaxf(__uint_as_float(xmax[b]), round_bf16(1e-6f));
    const float sx = round_bf16(mm / 127.0f), inv = round_bf16(1.0f / sx);
    // x rows t0 - 2 .. t0 + 3 as words of the int8 bytes at mels m - 1,
    // m, m + 1
    for (int i = tid; i < 6 * M; i += FNT) {
      const int r = i / M, mc = i - r * M, t = t0 - 2 + r;
      unsigned wv = 0u;
      if (t >= 0 && t < T) {
        const bf16* row = x + ((long long)b * T + t) * M;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const int mx = mc - 1 + d;
          if (mx >= 0 && mx < M)
            wv |= (unsigned)(unsigned char)v2::quant_i8(
                      __bfloat162float(row[mx]), inv) << (8 * d);
        }
      }
      rw[i] = wv;
    }
    float mul[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) mul[i] = __fmul_rn(a1[m * C + chan(i)], sx);
    __syncthreads();
    unsigned char* hb = H + buf * fused::HALO;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int t = t0 - 1 + h;
      const bool in_clip = t >= 0 && t < T;
      const unsigned x0 = rw[h * M + m], x1 = rw[(h + 1) * M + m];
      const unsigned x2 = rw[(h + 2) * M + m];
      const int p0 = (int)__byte_perm(x0, x1, 0x4210);
      const int p1 = (int)__byte_perm(x1, x2, 0x5421);
      const int p2 = (int)__byte_perm(x2, 0u, 0x4442);
      float y[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int acc = __dp4a(p0, wp[0][i],
                               __dp4a(p1, wp[1][i], __dp4a(p2, wp[2][i], 0)));
        y[i] = in_clip ? fmaxf(__fadd_rn(__fmul_rn((float)acc, mul[i]),
                                         be[i]), 0.0f)
                       : 0.0f;
      }
      uint4 v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&v[u]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[i] = __floats2bfloat162_rn(y[8 * u + 2 * i], y[8 * u + 2 * i + 1]);
      }
      // row h is time 0 of copy h and time 1 of copy h - 1
#pragma unroll
      for (int dt = h - 1; dt <= h; ++dt) {
        if (dt < 0 || dt > 2) continue;
        unsigned char* cell =
            hb + dt * fused::CPY + (m + 1) * 32 + (h - dt) * 16;
        *reinterpret_cast<uint4*>(cell + cg * HCH) = v[0];
        *reinterpret_cast<uint4*>(cell + (cg + 4) * HCH) = v[1];
      }
    }
    v2::fence_async_shared();
  };

  int tile = blockIdx.x;
  if (tile >= ntiles) return;
  produce(tile, 0);
  __syncthreads();
  float acc[32];
  for (int it = 0; tile < ntiles; tile += gridDim.x, ++it) {
    const int buf = it & 1;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    v2::fence_acc(acc);
    v2::wgmma_fence();
    const unsigned ha = h_a + buf * fused::HALO + wg * 32 * 32;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dt = tap / 3, dm = tap % 3;
#pragma unroll
      for (int kk = 0; kk < fused::KK; ++kk) {
        const uint64_t da = desc_ns(
            ha + dt * fused::CPY + 2 * kk * HCH + dm * 32, HCH, 128);
        const uint64_t db = desc_ns(
            bs_a + (tap * fused::NCH + 2 * kk) * C * 16, C * 16, 128);
        v2::wgmma_bf16_n64(acc, da, db);
      }
    }
    v2::wgmma_commit();
    const int next = tile + gridDim.x;
    if (next < ntiles) produce(next, buf ^ 1);
    v2::wgmma_wait<0>();
    v2::fence_acc(acc);

    // epilogue: thread rows k = 16 warp + lane / 4 (+ 8): mel 32 wg +
    // 8 warp + lane / 8 (+ 4), time t0 + (lane / 4) % 2
    const int b = tile / T_out, tout = tile % T_out;
    const bool lead = ((lane >> 2) & 3) == 0;
    const int col0 = 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mel = 32 * wg + 8 * warp + (lane >> 3) + 4 * h;
      bf16* d = out + (((long long)b * T_out + tout) * (M / 2) + mel / 2) * C +
                col0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + col0 + e;
          y[e] = fmaxf(
              __fadd_rn(__fmul_rn(acc[4 * j + 2 * h + e], a2[n]), b2[n]),
              0.0f);
        }
        const __nv_bfloat162 o = pool4(__floats2bfloat162_rn(y[0], y[1]));
        if (lead) *reinterpret_cast<__nv_bfloat162*>(d + 8 * j) = o;
      }
    }
    __syncthreads();
  }
}

cudaError_t launch_fused(const bf16* x, const void* w1, const float* a1,
                         const float* b1, const void* w2, const float* a2,
                         const float* b2, const unsigned* xmax, bf16* out,
                         int T, int ntiles, cudaStream_t st) {
  static int blocks = 0;
  if (!blocks) {
    cudaError_t e = cudaFuncSetAttribute(
        b1_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fused::SMEM);
    if (e != cudaSuccess) return e;
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&blocks, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
  }
  const int grid = ntiles < blocks ? ntiles : blocks;
  b1_fused_kernel<<<grid, FNT, fused::SMEM, st>>>(
      x, static_cast<const int8_t*>(w1), a1, b1, w2, a2, b2, xmax, out, T,
      ntiles);
  return cudaGetLastError();
}

}  // namespace

// x [B, T, 64] bf16 (bn0 output).  quant (0 = False, 1 = "conv1",
// 2 = True) and halo (True: 1 triple, 2 single); "conv1" runs fused
// (conv1 inside the GEMM block), False and True in two launches; w1, a1,
// b1, w2, a2, b2 as the first design takes them (conv_block1_pair.cu);
// smax [B + G] unsigned scratch (G = B ceil(T / tc) for True, else unused
// past B); y1: False [B, 2 (T / 2) + 2, 66, 64] bf16 scratch, True y1q
// [G, tc + 2, 66, 64] int8, unused for "conv1"; out [B, T / 2, 32, 64]
// bf16.
extern "C" int ttg_conv_block1_v2(int quant, int halo, const void* x, int B,
                                  int T, int tc, const void* w1,
                                  const float* a1, const float* b1,
                                  const void* w2, const float* a2,
                                  const float* b2, void* smax, void* y1,
                                  void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  unsigned* xmax = static_cast<unsigned*>(smax);
  const int nch = quant == 2 ? (T + tc - 1) / tc : 1, G = B * nch;
  unsigned* ymax = xmax + B;
  cudaError_t e;
#define TTG_CHECK(...) \
  if ((e = (__VA_ARGS__)) != cudaSuccess) return (int)e;
  if (quant) {
    TTG_CHECK(cudaMemsetAsync(xmax, 0,
                              sizeof(unsigned) * (quant == 2 ? B + G : B), st));
    const long long clip_len = (long long)T * M, piece = 8192;
    dim3 grid(v2::blocks_for(clip_len, (int)piece), B);
    v2::window_max_kernel<<<grid, 256, 0, st>>>(xb, xmax, 1, clip_len, 0, 0,
                                                clip_len, piece);
    TTG_CHECK(cudaGetLastError());
  }
  if (quant == 1) {
    if (T / 2 > 0)
      TTG_CHECK(launch_fused(xb, w1, a1, b1, w2, a2, b2, xmax,
                             static_cast<bf16*>(out), T, B * (T / 2), st));
    return (int)cudaSuccess;
  }
  v2::IgemmArgs c2{};
  c2.wt = w2;
  c2.alpha = a2;
  c2.beta = b2;
  c2.dst = out;
  c2.T = T;
  c2.M = M;
  c2.Cin = C;
  c2.Cout = C;
  c2.pt = c2.pm = 2;
  c2.T_out = T / 2;
  c2.src = y1;
  if (quant == 2) {
    // the chunk's y1 max over its scale window, then the tc + 2 rows conv2
    // reads (times [j tc - 1, j tc + tc]) as int8
    TTG_CHECK((launch_conv1<OUT_MAX>(xb, w1, a1, b1, xmax, ymax,
                                           nullptr, G, T, nch, tc,
                                           tc + 2 * halo, -halo, st)));
    TTG_CHECK((launch_conv1<OUT_Q8>(xb, w1, a1, b1, xmax, ymax, y1, G,
                                          T, nch, tc, tc + 2, -1, st)));
    c2.smax = ymax;
    c2.scale_div = 1;
    c2.G = G;
    c2.nch = nch;
    c2.tc = tc;
    c2.R_in = tc + 2;
    c2.R_out = tc;
    if (c2.T_out > 0) TTG_CHECK((v2::launch_igemm<int8_t, 3>(c2, st)));
  } else {
    // the whole clip as one group: conv2's output rows 0 .. 2 (T / 2) - 1
    const int Tr = (T / 2) * 2;
    TTG_CHECK((launch_conv1<OUT_BF16>(xb, w1, a1, b1, nullptr, nullptr,
                                             y1, B, T, 1, 0, Tr + 2, -1, st)));
    c2.smax = nullptr;
    c2.G = B;
    c2.nch = 1;
    c2.tc = Tr;
    c2.R_in = Tr + 2;
    c2.R_out = Tr;
    if (Tr > 0) TTG_CHECK((v2::launch_igemm<bf16, 3>(c2, st)));
  }
#undef TTG_CHECK
  return (int)cudaSuccess;
}
