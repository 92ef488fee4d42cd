// Winograd F(2 x 2, 3 x 3) PANNs block, second design (sm_90a):
// (conv3x3 -> BN -> ReLU) x 2 -> 2 x 2 avg+max pool with each conv's 16
// products and its output transform in one wgmma kernel, no M_k in device
// memory.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/conv_block_wino.py:264
// fused_block_wino.  The function and its int8 contract are the first
// design's (conv_block_wino.cu): U_k = G w G^T in int8 per (k, Cout); V_k
// = B^T d B in f32 in the butterfly's order of additions, quantized per
// (k, chunk) with sv = max(max|V_k|, 1e-6) / 127 over all the chunk's
// tiles, halo tiles included; M_k = (float) sum q u * (sv su[k, n]); the
// output transform in the TPU kernel's two stages; BN, ReLU; conv1's rows
// outside the clip zeroed and stored in bf16; conv2 pooled as ((z00 +
// z01) + z10) + z11) * 0.25 + max.  Its int8 output is the first design's
// bit for bit.  Per conv:
//
// 1. wino_max_kernel (int8): many blocks a group, each thread the 16 V_k of
//    one tile at 8 channels (4 ran no faster); each block's 16 maxes go to
//    their (k, group) slots by atomicMax on the float bits (exact and
//    order-free; the slots are zeroed first, in stream order).  This
//    replaces the first design's one block a (group, k) walking the group
//    twice.
// 2. wino_v_kernel: V_k once more from the same patch, quantized with sv
//    (int8) or rounded to bf16, written once as K-major rows v [16, P, C]
//    that the ring copies as they are (P = G R tiles).  Building V_k in
//    shared memory inside the products would re-read each tile's 4 x 4
//    bf16 patch for every k and 64-byte K chunk (8x the A bytes from L2),
//    so V_k makes one round trip in 1 byte (int8) or 2 (bf16).
// 3. wino_fold_kernel: a 128-tile x 64-channel output block of two
//    consumer warpgroups; the K stages are (k, 64-byte K chunk), k walked
//    j outer, i inner (k = 4 i + j), on a cp.async ring of 7 slots (five
//    stages in flight) in conv_igemm_sm90.cuh's 64-byte swizzle, products
//    wgmma m64n64k32 s8 -> s32 or m64n64k16 bf16 -> f32.  When a k's last
//    chunk is done its accumulators are scaled (sv of each row's own
//    group: tiles cross group edges; su of each column) and folded in the
//    plain version's order of f32 additions: s0 = (m0j + m1j) + m2j, s1 =
//    (m1j - m2j) - m3j, then y_t0 = s_t0 (j = 0) + s_t1 + s_t2, y_t1 =
//    s_t1 (j = 1) - s_t2 - s_t3.  Two accumulator sets take the walk's
//    steps in turn, so that a step's first products are issued before the
//    step before is folded, and the block's scales are staged in shared
//    memory once.  s0, s1 and the accumulators live in registers; the four
//    y in f32 shared memory (4 x 32 floats a thread, 128 KB, beside the
//    84 KB ring): at j = 2 seven tile-sized arrays are live, 224 registers
//    a thread at N = 64 in registers alone.  The epilogue runs from there:
//    conv1's BN, ReLU and clip mask into bf16 y1 [G, tc + 4, M, Cout],
//    conv2's BN, ReLU and pool into out [B, T / 2, M / 2, Cout].
//
// Bound on the H100: the Winograd products' operations, 2 * 16 * Cin * Cout
// a 2 x 2 output tile and conv, in int8 at 1979 TOP/s.  The byte floor of
// this design adds V_k's write and read (1 byte a tile, k and channel in
// int8) to x, y1 and the output.  Each 64-channel output slice stages its
// rows' V_k again (Cout / 64 times), from L2.  What holds it back on the
// H100: the product kernel's small blocks (64 columns, one block an SM, a
// 12 KB stage for 128 x 64 x 64 products), then the fold and the V_k round
// trip; sharing A across a cluster's blocks by TMA multicast is the next
// step.
#include "conv_igemm_sm90.cuh"

namespace {

using ttg::bf16;
using namespace ttg::v2;

constexpr int WBN = 64;   // output channels of a product block
constexpr int VT = 256;   // threads of the max and V passes
constexpr int VC = 8;     // channels a thread of the max and V passes

// where conv's tiles read their 4 x 4 input patches
struct WSrc {
  const bf16* p;   // [groups, rows, M, C]
  int rows;        // rows per source group (zero outside [0, rows))
  int per_clip;    // 1: source group g / nch, first row (g % nch) tc + off
  int off;         //    0: source group g, first row off
};

__device__ __forceinline__ float comb(float a, float b, bool plus) {
  return plus ? __fadd_rn(a, b) : __fsub_rn(a, b);
}

// the 4 x 4 patch of tile r of group g at channels c0 .. c0 + VC - 1:
// input (row0 + x, 2 bb - 1 + y) of tile (u, bb) = (r / mp, r % mp)
__device__ __forceinline__ void load_patch(const WSrc& s, int g, int nch,
                                           int tc, int M, int C, int r,
                                           int c0, uint4 (&d)[4][4]) {
  const int mp = M >> 1, u = r / mp, bb = r - (r / mp) * mp;
  const int sg = s.per_clip ? g / nch : g;
  const int row0 = (s.per_clip ? (g % nch) * tc : 0) + s.off + 2 * u;
  const bf16* base = s.p + (long long)sg * s.rows * M * C + c0;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int t = row0 + x, m = 2 * bb - 1 + y;
      d[x][y] = (t >= 0 && t < s.rows && m >= 0 && m < M)
                    ? *reinterpret_cast<const uint4*>(
                          base + ((long long)t * M + m) * C)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
}

__device__ __forceinline__ float chan(const uint4& v, int e) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 f = __bfloat1622float2(h[e >> 1]);
  return (e & 1) ? f.y : f.x;
}

// V_k (k = 4 i + j) at channel e of the patch, in the butterfly's order
// (conv_block_wino.py:99): s[i][y] = d[xa_i][y] +- d[xb_i][y], then V =
// s[i][xa_j] +- s[i][xb_j]; + for i (j) = 1, - otherwise
__device__ __forceinline__ float wino_v(const uint4 (&d)[4][4], int k,
                                        int e) {
  constexpr int XA[4] = {0, 1, 2, 1}, XB[4] = {2, 2, 1, 3};
  const int i = k >> 2, j = k & 3;
  const float a = comb(chan(d[XA[i]][XA[j]], e), chan(d[XB[i]][XA[j]], e),
                       i == 1);
  const float b = comb(chan(d[XA[i]][XB[j]], e), chan(d[XB[i]][XB[j]], e),
                       i == 1);
  return comb(a, b, j == 1);
}

// max |V_k| over piece blockIdx.x of group blockIdx.y's R tiles x C
// channels (one tile and VC channels a thread) into svbits[k G + g]
__global__ void __launch_bounds__(VT)
    wino_max_kernel(WSrc s, unsigned* __restrict__ svbits, int G, int nch,
                    int tc, int M, int C, int R) {
  const int g = blockIdx.y, cv = C / VC;
  const int item = blockIdx.x * VT + threadIdx.x;
  float m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = 0.0f;
  if (item < R * cv) {
    uint4 d[4][4];
    load_patch(s, g, nch, tc, M, C, item / cv, (item % cv) * VC, d);
#pragma unroll
    for (int k = 0; k < 16; ++k)
#pragma unroll
      for (int e = 0; e < VC; ++e)
        m[k] = fmaxf(m[k], fabsf(wino_v(d, k, e)));
  }
  __shared__ float red[VT / 32][16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float v = m[k];
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < VT / 32; ++w) v = fmaxf(v, red[w][threadIdx.x]);
    max_into(svbits + threadIdx.x * G + g, v);
  }
}

// v [16, G R, C]: V_k of every tile, int8 with the (k, group) scale or
// bf16; one tile and VC channels a thread
template <bool QUANT>
__global__ void __launch_bounds__(VT)
    wino_v_kernel(WSrc s, void* __restrict__ v,
                  const unsigned* __restrict__ svbits, int G, int nch,
                  int tc, int M, int C, int R) {
  const int cv = C / VC;
  const long long P = (long long)G * R;
  const long long item = (long long)blockIdx.x * VT + threadIdx.x;
  if (item >= P * cv) return;
  const long long p = item / cv;
  const int c0 = (int)(item - p * cv) * VC, g = (int)(p / R);
  uint4 d[4][4];
  load_patch(s, g, nch, tc, M, C, (int)(p - (long long)g * R), c0, d);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const long long at = ((long long)k * P + p) * C + c0;
    if constexpr (QUANT) {
      const float inv = 1.0f / scale_of(svbits[k * G + g]);
      uint2 out;
      int8_t* q = reinterpret_cast<int8_t*>(&out);
#pragma unroll
      for (int e = 0; e < VC; ++e) q[e] = quant_i8(wino_v(d, k, e), inv);
      *reinterpret_cast<uint2*>(static_cast<int8_t*>(v) + at) = out;
    } else {
      uint4 out;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int e = 0; e < VC; e += 2)
        h[e >> 1] = __floats2bfloat162_rn(wino_v(d, k, e),
                                          wino_v(d, k, e + 1));
      *reinterpret_cast<uint4*>(static_cast<bf16*>(v) + at) = out;
    }
  }
}

struct FoldArgs {
  const void* v;           // [16, P, K] int8 or bf16
  const void* u;           // [16, Cout, K]
  const float* su;         // [16, Cout] (int8) or null
  const unsigned* svbits;  // [16, G] (int8) or null
  const float* alpha;      // [Cout] BN
  const float* beta;
  bf16* dst;  // conv1: y1 [G, tc + 4, M, Cout]; conv2: [B, T / 2, M / 2, Cout]
  int G, R, nch, tc, T, M, K, Cout;
};

constexpr int FOLD_A = BM * KB, FOLD_B = WBN * KB;
constexpr int FOLD_STAGES = 7;                // ring slots
constexpr int FOLD_AHEAD = FOLD_STAGES - 2;   // stages loaded ahead
// the ring, the four y (4 x WBN / 2 floats a thread), the block's scales
// (su [16][WBN], sv [16][BM]) and 1024 bytes to align the ring: 230,400
// bytes, one block an SM
constexpr int fold_smem() {
  return FOLD_STAGES * (FOLD_A + FOLD_B) + 4 * (WBN / 2) * NT * 4 +
         16 * (WBN + BM) * 4 + 1024;
}

template <typename T, bool CONV1>
__global__ void __launch_bounds__(NT, 1) wino_fold_kernel(FoldArgs a) {
  using AT = typename Acc<T, WBN>::type;
  constexpr int ES = sizeof(T), NA = WBN / 2;
  constexpr int A_PER_THREAD = BM * CPR / NT, B_PER_THREAD = WBN * CPR / NT;
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (base & 1023)) & 1023);
  unsigned char* As = smem;
  unsigned char* Bs = smem + FOLD_STAGES * FOLD_A;
  float* Ys = reinterpret_cast<float*>(Bs + FOLD_STAGES * FOLD_B);
  float* suS = Ys + 4 * (WBN / 2) * NT;  // [16][WBN] su of the columns
  float* svS = suS + 16 * WBN;           // [16][BM] sv of each row's group

  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * WBN;
  const long long p0 = (long long)blockIdx.y * BM;
  const long long P = (long long)a.G * a.R;
  const long long row_bytes = (long long)a.K * ES;
  const int kch = (int)(row_bytes / KB);
  const int S = 16 * kch;
  const unsigned char* vb = static_cast<const unsigned char*>(a.v);
  const unsigned char* ub = static_cast<const unsigned char*>(a.u);

  long long a_off[A_PER_THREAD];
  int a_dst[A_PER_THREAD];
#pragma unroll
  for (int i = 0; i < A_PER_THREAD; ++i) {
    const int q = tid + i * NT;
    const int row = (q / (8 * CPR)) * 8 + (q & 7), c = (q >> 3) % CPR;
    const long long p = p0 + row < P ? p0 + row : P - 1;
    a_off[i] = p * row_bytes + c * 16;
    a_dst[i] = piece_offset(row, c);
  }
  long long b_off[B_PER_THREAD];
  int b_dst[B_PER_THREAD];
#pragma unroll
  for (int i = 0; i < B_PER_THREAD; ++i) {
    const int q = tid + i * NT;
    const int row = (q / (8 * CPR)) * 8 + (q & 7), c = (q >> 3) % CPR;
    b_off[i] = (long long)(n0 + row) * row_bytes + c * 16;
    b_dst[i] = piece_offset(row, c);
  }
  // stage s: walk step kk = s / kch (j = kk / 4 outer, i = kk % 4 inner,
  // k = 4 i + j), K chunk s % kch
  auto load = [&](int s) {
    const int kk = s / kch, kc = s - (s / kch) * kch;
    const int k = 4 * (kk & 3) + (kk >> 2);
    const unsigned char* va = vb + (long long)k * P * row_bytes + kc * KB;
    const unsigned char* uk =
        ub + (long long)k * a.Cout * row_bytes + kc * KB;
    unsigned char* as = As + (s % FOLD_STAGES) * FOLD_A;
    unsigned char* bs = Bs + (s % FOLD_STAGES) * FOLD_B;
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i)
      cp_async16(as + a_dst[i], va + a_off[i]);
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i)
      cp_async16(bs + b_dst[i], uk + b_off[i]);
  };

  // the fragment layout: rows wg 64 + w 16 + l / 4 (+ 8 for h = 1),
  // columns 8 jj + 2 (l % 4) + e at acc[4 jj + 2 h + e]
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int row0 = wg * 64 + warp * 16 + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  long long pr[2];
  int gr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pr[h] = p0 + row0 + 8 * h;
    gr[h] = (int)((pr[h] < P ? pr[h] : P - 1) / a.R);
  }
  // the scales the fold reads, staged once (the ring's first barrier
  // orders them before the first fold)
  if constexpr (std::is_same<T, int8_t>::value) {
    for (int e = tid; e < 16 * WBN; e += NT)
      suS[e] = a.su[(e / WBN) * a.Cout + n0 + e % WBN];
    for (int e = tid; e < 16 * BM; e += NT) {
      const long long p = p0 + e % BM;
      const int g = (int)((p < P ? p : P - 1) / a.R);
      svS[e] = scale_of(a.svbits[(e / BM) * a.G + g]);
    }
  }

  // two accumulator sets, even walk steps in acc0 and odd in acc1: a step's
  // products are issued before the previous step's M_k is folded
  AT acc0[NA], acc1[NA];
  float s0[NA], s1[NA];
#pragma unroll
  for (int x = 0; x < NA; ++x) {
    acc0[x] = acc1[x] = (AT)0;
    s0[x] = s1[x] = 0.0f;
  }
  fence_acc(acc0);
  fence_acc(acc1);
  auto ys = [&](int q, int x) -> float& { return Ys[(q * NA + x) * NT + tid]; };

  // M_k of walk step kk is complete in acc: scale it, fold it in, zero acc
  auto fold = [&](AT (&acc)[NA], int kk) {
    fence_acc(acc);
    const int i = kk & 3, j = kk >> 2, k = 4 * i + j;
    float sv[2] = {1.0f, 1.0f};
    if constexpr (std::is_same<T, int8_t>::value) {
#pragma unroll
      for (int h = 0; h < 2; ++h) sv[h] = svS[k * BM + row0 + 8 * h];
    }
#pragma unroll
    for (int x = 0; x < NA; ++x) {
      const int h = (x >> 1) & 1, c = col0 - n0 + 8 * (x >> 2) + (x & 1);
      float mk;
      if constexpr (std::is_same<T, int8_t>::value)
        mk = __fmul_rn((float)acc[x], __fmul_rn(sv[h], suS[k * WBN + c]));
      else
        mk = acc[x];
      acc[x] = (AT)0;
      if (i == 0) {
        s0[x] = mk;
      } else if (i == 1) {
        s0[x] = __fadd_rn(s0[x], mk);
        s1[x] = mk;
      } else if (i == 2) {
        s0[x] = __fadd_rn(s0[x], mk);
        s1[x] = __fsub_rn(s1[x], mk);
      } else {
        s1[x] = __fsub_rn(s1[x], mk);
      }
      if (i != 3 || j == 3) continue;
      // column j into the four y: ys(2 tau + mu)
      if (j == 0) {
        ys(0, x) = s0[x];
        ys(2, x) = s1[x];
      } else if (j == 1) {
        ys(0, x) = __fadd_rn(ys(0, x), s0[x]);
        ys(2, x) = __fadd_rn(ys(2, x), s1[x]);
        ys(1, x) = s0[x];
        ys(3, x) = s1[x];
      } else {
        ys(0, x) = __fadd_rn(ys(0, x), s0[x]);
        ys(2, x) = __fadd_rn(ys(2, x), s1[x]);
        ys(1, x) = __fsub_rn(ys(1, x), s0[x]);
        ys(3, x) = __fsub_rn(ys(3, x), s1[x]);
      }
    }
    fence_acc(acc);
  };

  // one K stage: wait for its copies, refill the ring, issue its products
  auto step = [&](int s, AT (&acc)[NA]) {
    cp_async_wait<FOLD_AHEAD - 1>();
    fence_async_shared();
    __syncthreads();
    if (s + FOLD_AHEAD < S) load(s + FOLD_AHEAD);
    cp_async_commit();
    const unsigned char* as = As + (s % FOLD_STAGES) * FOLD_A + wg * 64 * KB;
    const unsigned char* bs = Bs + (s % FOLD_STAGES) * FOLD_B;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KB / 32; ++ks)
      wgmma_k32b<T, WBN>(acc, smem_desc(as + ks * 32),
                         smem_desc(bs + ks * 32));
    wgmma_commit();
    wgmma_wait<1>();  // the stage before is done: its slot, its step
  };

#pragma unroll
  for (int s = 0; s < FOLD_AHEAD; ++s) {
    if (s < S) load(s);
    cp_async_commit();
  }
  for (int kk = 0; kk < 16; kk += 2) {
    for (int kc = 0; kc < kch; ++kc) {
      step(kk * kch + kc, acc0);
      if (kc == 0 && kk > 0) fold(acc1, kk - 1);
    }
    for (int kc = 0; kc < kch; ++kc) {
      step((kk + 1) * kch + kc, acc1);
      if (kc == 0) fold(acc0, kk);
    }
  }
  wgmma_wait<0>();
  fold(acc1, 15);

  // epilogue (column 3 folded on the way): y00, y01, y10, y11
  const int mp = a.M >> 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (pr[h] >= P) continue;
    const int g = gr[h], r = (int)(pr[h] - (long long)g * a.R);
    const int u = r / mp, bb = r - (r / mp) * mp, jc = g % a.nch;
#pragma unroll
    for (int jj = 0; jj < WBN / 8; ++jj) {
      const int n = col0 + 8 * jj;
      float z[2][2][2];  // [tau][mu][e]
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * jj + 2 * h + e;
        const float y[2][2] = {
            {ys(0, x), __fsub_rn(ys(1, x), s0[x])},
            {ys(2, x), __fsub_rn(ys(3, x), s1[x])}};
        const float al = a.alpha[n + e], be = a.beta[n + e];
#pragma unroll
        for (int tau = 0; tau < 2; ++tau)
#pragma unroll
          for (int mu = 0; mu < 2; ++mu)
            z[tau][mu][e] =
                fmaxf(__fadd_rn(__fmul_rn(y[tau][mu], al), be), 0.0f);
      }
      if constexpr (CONV1) {
#pragma unroll
        for (int tau = 0; tau < 2; ++tau) {
          const int t = jc * a.tc - 2 + 2 * u + tau;
          const bool in_clip = t >= 0 && t < a.T;
#pragma unroll
          for (int mu = 0; mu < 2; ++mu) {
            bf16* d = a.dst + (((long long)g * (a.tc + 4) + 2 * u + tau) *
                                   a.M + 2 * bb + mu) * a.Cout + n;
            *reinterpret_cast<__nv_bfloat162*>(d) =
                in_clip ? __floats2bfloat162_rn(z[tau][mu][0], z[tau][mu][1])
                        : __floats2bfloat162_rn(0.0f, 0.0f);
          }
        }
      } else {
        const int tout = jc * (a.tc / 2) + u;
        if (tout >= a.T / 2) continue;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sum = __fadd_rn(
              __fadd_rn(__fadd_rn(z[0][0][e], z[0][1][e]), z[1][0][e]),
              z[1][1][e]);
          const float mx = fmaxf(fmaxf(z[0][0][e], z[0][1][e]),
                                 fmaxf(z[1][0][e], z[1][1][e]));
          o[e] = __fadd_rn(__fmul_rn(sum, 0.25f), mx);
        }
        bf16* d = a.dst + (((long long)(g / a.nch) * (a.T / 2) + tout) * mp +
                           bb) * a.Cout + n;
        *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(o[0], o[1]);
      }
    }
  }
}

template <typename T, bool CONV1>
cudaError_t launch_fold(const FoldArgs& a, cudaStream_t st) {
  constexpr int smem = fold_smem();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        wino_fold_kernel<T, CONV1>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long P = (long long)a.G * a.R;
  dim3 grid((unsigned)(a.Cout / WBN), (unsigned)((P + BM - 1) / BM));
  wino_fold_kernel<T, CONV1><<<grid, NT, smem, st>>>(a);
  return cudaGetLastError();
}

// one conv: the scales (int8), V_k, the products with the fold
template <bool CONV1>
cudaError_t conv(bool quant, const WSrc& s, int G, int nch, int tc, int T,
                 int M, int C, int Cout, int R, const void* u,
                 const float* su, const float* alpha, const float* beta,
                 void* v, unsigned* svbits, bf16* dst, cudaStream_t st) {
  const int cv = C / VC;
  const long long items = (long long)G * R * cv;
  if (quant) {
    dim3 grid((unsigned)((R * cv + VT - 1) / VT), (unsigned)G);
    wino_max_kernel<<<grid, VT, 0, st>>>(s, svbits, G, nch, tc, M, C, R);
    wino_v_kernel<true><<<(unsigned)((items + VT - 1) / VT), VT, 0, st>>>(
        s, v, svbits, G, nch, tc, M, C, R);
  } else {
    wino_v_kernel<false><<<(unsigned)((items + VT - 1) / VT), VT, 0, st>>>(
        s, v, nullptr, G, nch, tc, M, C, R);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  FoldArgs f{v, u, quant ? su : nullptr, quant ? svbits : nullptr, alpha,
             beta, dst, G, R, nch, tc, T, M, C, Cout};
  return quant ? launch_fold<int8_t, CONV1>(f, st)
               : launch_fold<bf16, CONV1>(f, st);
}

}  // namespace

// x [B, T, M, Cin] bf16 (M even); the clip is zero-padded to tpad, a
// multiple of the even chunk tc.  u1 [16, Cout, Cin], u2 [16, Cout, Cout]:
// int8 with su1 / su2 [16, Cout] (quant) or bf16; a / b [Cout] f32 BN
// affines.  Scratch: v [16, G max(R1 Cin, R2 Cout)] int8 or bf16, svbits
// [2, 16, G] (quant), y1 [G, tc + 4, M, Cout] bf16, with G = B tpad / tc,
// R1 = (tc / 2 + 2) M / 2, R2 = tc / 2 * M / 2.  out [B, T / 2, M / 2,
// Cout] bf16.  Cin and Cout multiples of 64.
extern "C" int ttg_conv_block_wino_v2(int quant, const void* x, int B, int T,
                                      int M, int Cin, int Cout, int tc,
                                      int tpad, const void* u1,
                                      const float* su1, const float* a1,
                                      const float* b1, const void* u2,
                                      const float* su2, const float* a2,
                                      const float* b2, void* v,
                                      void* svbits, void* y1, void* out,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = tpad / tc, G = B * nch, mp = M / 2;
  const int R1 = (tc / 2 + 2) * mp, R2 = tc / 2 * mp;
  unsigned* sv = static_cast<unsigned*>(svbits);
  bf16* y1b = static_cast<bf16*>(y1);
  cudaError_t e;
  if (quant && (e = cudaMemsetAsync(sv, 0, sizeof(unsigned) * 32 * G, st)) !=
                   cudaSuccess)
    return (int)e;
  // conv1: tiles at times t0 - 2 + 2u, inputs from t0 - 3 (zero past T)
  const WSrc s1{static_cast<const bf16*>(x), T, 1, -3};
  e = conv<true>(quant != 0, s1, G, nch, tc, T, M, Cin, Cout, R1, u1, su1,
                 a1, b1, v, sv, y1b, st);
  if (e != cudaSuccess) return (int)e;
  // conv2: y1's chunk rows, tile u's inputs from row 2u + 1
  const WSrc s2{y1b, tc + 4, 0, 1};
  e = conv<false>(quant != 0, s2, G, nch, tc, T, M, Cout, Cout, R2, u2, su2,
                  a2, b2, v, sv + 16 * G, static_cast<bf16*>(out), st);
  return (int)e;
}
