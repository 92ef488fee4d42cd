// Bidirectional GRU forward, second design (sm_90a): one persistent
// cluster launch a walk.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/gru.py:62 bigru_pallas
// (_kernel at :33, the pallas_call at :86) with an f32 or a bf16 carry: the
// forward of :608 bigru_pallas_trainable and of :283
// bigru_pallas_trainable_bf16, and the serving GRU kernel.  Layout and
// results are gru.cu's first design (gru_fwd_step): time-major proj
// [T, 2B, 3H] f32 (direction-0 rows, then direction-1 rows already
// time-flipped), wh [2, H, 3H], bn [2, H] -> ys [T, 2B, H] f32, gates as
// torch's nn.GRU (gru.cu:1-10), h_0 = 0.
//
// The first design launches once a step (250 launches a walk at T = 250),
// and every launch stages all of h_{t-1} [B, H] and its Wh columns again:
// a call costs 2.2 ms, more than half of it the launch-per-step floor.
// Here the whole walk is one launch:
//
// 1. Thread-block clusters.  A cluster owns one direction g and one group
//    of at most RMAX = 12 batch rows; its CTAs split the H hidden units, U
//    each (16 CTAs of 16 units at H = 256, the non-portable cluster size).
//    Rows never meet in the forward, so no cluster ever waits on another:
//    when B asks for more clusters than the card holds at once they run in
//    waves, and that is correct only because of it.
// 2. Wh resident.  A CTA keeps Wh[g][:, {r, z, n} x own units] (H x 3U,
//    48 KB f32 at U = 16; bf16-rounded values for the bf16 carry) in shared
//    memory for all T steps, with the cluster rows' h_{t-1} [H][RMAX].
// 3. Each step:
//    a. wait until the other CTAs' slices of h_{t-1} have landed (below);
//    b. the gate product h_{t-1} . Wh[:, own] for the group's rows: K is
//       split in WARPS fixed slices of KW = ceil(H / WARPS) (one a warp;
//       with the f32 carry a lane takes 3 columns x RL rows, RL =
//       ceil(rows / 2), on FFMA; with the bf16 carry mma.sync, below),
//       and each (row, column) sums the slices in warp order;
//    c. the gates and h_t of the own (row, unit) items, written to ys[t]
//       (f32), and the carry h_t into the CTA's own slice of the next
//       carry buffer;
//    d. that slice (U units x RMAX rows, 768 bytes at U = 16) to every
//       other CTA of the cluster, one cp.async.bulk shared::cluster copy
//       each, counted on the receiver's mbarrier (complete_tx).
//    Tried first on the H100, and slower: each (row, unit) value pushed
//    to every CTA with a 4-byte st.shared::cluster (2,816 stores a CTA a
//    step at B = 32) and the step closed by a cluster barrier, where the
//    stores cost more than the product; then 16-byte stores of 4-row
//    quads, which serialised the gates on a quarter of the threads.
// 4. Two carry buffers, by step parity, each with an mbarrier: step t
//    reads buffer t & 1, whose barrier completes a phase when the other
//    CTAs' copies of h_{t-1} have all landed (the receiver sets the phase
//    up with mbarrier.arrive.expect_tx of their bytes, one step ahead:
//    for buffer 1's first phase before the walk, then in step t for step
//    t + 2, once all its threads are past step t's wait).  Why no barrier
//    over the cluster is needed: a copy of step t + 1 writes buffer t & 1
//    of CTA Y, which Y read in step t.  It leaves CTA X only after X has
//    waited for h_t, and so for Y's slice of it, which Y sends only after
//    its step-t product, its last read of that buffer.  And a phase can
//    not take bytes of a later one: CTA X's copy for step t + 2 needs
//    Y's h_{t+1}, so Y is past its wait of step t.  The copies' sources
//    are safe by the same chain: X's own slice of buffer (t + 1) & 1 is
//    written again in step t + 2, after X waited for h_{t+1}, which no
//    CTA sends before X's copies of h_t have landed in it.  One cluster
//    barrier before the walk orders each CTA's zeroed buffers and set-up
//    barriers before any copy, and one after it keeps every CTA's shared
//    memory alive until the last copy has read it.
// 5. Loops run to the real H (the K slices; the bf16 product's k-steps
//    stop where its slice ends) and, with the f32 carry, to the real rows
//    (RL, a template argument picked from the plan; the bf16 product pads
//    them to mma's 16), so that the same walk at B = 1, H = 4 measures
//    the step's latency in one CTA, and at B = 1, H = 256 that of the
//    16 CTAs' exchange (chip_smoke.py's latency_floor_ms and
//    exchange_floor_ms).
//
// The plan (ops/kernels/gru.py:forward_plan): groups of at most RMAX rows,
// as evenly filled as the count allows.  At B = 32, H = 256 that is 2 x 3
// clusters of 16 CTAs with 11, 11 and 10 rows: a CTA takes 92,176 bytes of
// shared memory and at most 121 registers a thread, so an SM holds two
// and an H100 80GB HBM3 14 such clusters at once
// (cudaOccupancyMaxActiveClusters, reported by chip_smoke.py): the six
// run in one wave, each CTA on an SM of its own.  Groups of at most 6
// rows (2 x 6 clusters, two CTAs sharing an SM) were slower on the card
// with either carry.  At B = 128 the 2 x 11 clusters of 12 rows run in
// two waves (14, then 8).
//
// Numerics.  The f32 carry's product is FFMA, no TF32: the forward is held
// to 1e-4 of the plain version and the backward's recompute assumes these
// ys.  The bf16 carry rounds where the first design rounds (gru.cu:509-520
// wrapper, ttg_gru_fwd_bf16): Wh and the carry that feeds the product and
// the z h term are bf16 values, the products are summed in f32 and ys keeps
// the f32 h_t.  Its product runs on the tensor cores, mma.sync m16n8k16
// (bf16 x bf16 -> f32) with the rows padded to 16 and Wh's fragments in
// registers: each warp's slice is 2 k-steps x 6 column tiles, 12 mma a
// step in place of 576 FFMA a lane.  Orders of summation: within a K
// slice sequential FMAs (f32 carry) or the tensor core's own order (bf16),
// the slices in warp order; ops/kernels/gru.py:
// gru_forward_cluster_emulated fixes the slice order on the CPU.
//
// Bound on the H100 at T = 250, B = 32, H = 256: 67 MB moved (proj 49 MB,
// ys 16 MB) for 6.3 GFLOP f32 (0.094 ms at 67 TFLOP/s), and 250 dependent
// steps.  A step costs a CTA 12 x 48 x 256 = 147K FFMA (11 rows real, 12
// computed where rows are odd), about 0.6 us of issue at one CTA an SM,
// one 768-byte copy to each other CTA and one barrier wait.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UMAX = 16;               // hidden units a CTA owns, at most
constexpr int RMAX = 12;               // batch rows of a cluster, at most
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER_MAX = 16;

struct Args {
  const float* proj;
  const float* wh;
  const float* bn;
  float* ys;
  int T, B, H, U, rows;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool RB>
__device__ __forceinline__ float op(float v) {
  return RB ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the shared::cluster address of `local`'s offset in CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* local,
                                                 unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(smem_addr(local)), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

// the one arrival of the barrier's next phase, which then waits for
// `bytes` more to land
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the barrier's phase of the given parity to complete.  A walk
// whose copies never land would spin for ever: after about 2^34 cycles
// (some 9 s) the kernel traps instead, and the launch fails.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

// `bytes` from this CTA's `src` to the same offset in CTA `rank`, counted
// on that CTA's barrier at the offset of `bar`
__device__ __forceinline__ void copy_to(const float* src, uint32_t bytes,
                                        unsigned rank, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(cluster_addr(src, rank)), "r"(smem_addr(src)), "r"(bytes),
         "r"(cluster_addr(bar, rank))
      : "memory");
}

// floats of the Wh columns [H][3U], padded to 16 bytes
__host__ __device__ __forceinline__ int ws_floats(int H, int U) {
  return (H * 3 * U + 3) & ~3;
}

// shared memory, in floats: the Wh columns, the carry [2][H][RMAX] (rows
// past the group's zero), the gate product's warp sums [WARPS][RMAX][3U],
// then two 8-byte barriers, one a carry buffer
__host__ __device__ __forceinline__ int smem_floats(int H, int U) {
  return ws_floats(H, U) + 2 * H * RMAX + ((WARPS * RMAX * 3 * U + 1) & ~1)
         + 4;
}

// Each warp's K slice of h_{t-1} . Wh[:, own] into red: lane (ct, rh)
// takes columns 3 ct .. 3 ct + 2 of the 3U and rows rh RL .. rh RL + RL - 1
template <int RL>
__device__ __forceinline__ void gate_product(const float* hb, const float* ws,
                                             float* red, int H, int U,
                                             int kw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = lane & 15, r0 = (lane >> 4) * RL, c3 = 3 * U;
  if (ct >= U) return;
  float acc[RL][3];
#pragma unroll
  for (int r = 0; r < RL; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.0f;
  const int k1 = min(H, (warp + 1) * kw);
#pragma unroll 4
  for (int k = warp * kw; k < k1; ++k) {
    const float* hr = hb + k * RMAX + r0;
    float hv[RL];
    if constexpr (RL % 2 == 0) {
#pragma unroll
      for (int q = 0; q < RL / 2; ++q) {
        const float2 v = *reinterpret_cast<const float2*>(hr + 2 * q);
        hv[2 * q] = v.x;
        hv[2 * q + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int r = 0; r < RL; ++r) hv[r] = hr[r];
    }
    const float* wr = ws + k * c3 + 3 * ct;
    const float w0 = wr[0], w1 = wr[1], w2 = wr[2];
#pragma unroll
    for (int r = 0; r < RL; ++r) {
      acc[r][0] = fmaf(hv[r], w0, acc[r][0]);
      acc[r][1] = fmaf(hv[r], w1, acc[r][1]);
      acc[r][2] = fmaf(hv[r], w2, acc[r][2]);
    }
  }
#pragma unroll
  for (int r = 0; r < RL; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      red[(warp * RMAX + r0 + r) * c3 + 3 * ct + c] = acc[r][c];
}

// The bf16 carry's product on the tensor cores: each warp's K slice as
// KSTEPS mma.sync m16n8k16 (bf16 operands, f32 sums) over the rows padded
// to 16 and NT tiles of 8 columns.  Wh's fragments stay in registers for
// the walk (wfrag, from ws), h's are packed from the carry buffer each
// step; a lane's sums go to red as gate_product's do.
constexpr int KSTEPS = 2;              // 16-k steps a warp: KW <= 32
constexpr int NT = 3 * UMAX / 8;       // column tiles of 8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// B fragments (k = 2 t, 2 t + 1 and 2 t + 8, 2 t + 9 of a 16-k step,
// column g of a tile) of the warp's slice; zero past the slice or the 3U
// columns
__device__ __forceinline__ void load_wfrag(uint32_t (&wf)[KSTEPS][NT][2],
                                           const float* ws, int H, int U,
                                           int kw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, c3 = 3 * U;
  const int k0 = warp * kw, k1 = min(H, k0 + kw);
  auto w = [&](int k, int c) {
    return k < k1 && c < c3 ? ws[k * c3 + c] : 0.0f;
  };
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int k = k0 + 16 * s + 2 * t, c = 8 * n + g;
      wf[s][n][0] = pack_bf16(w(k, c), w(k + 1, c));
      wf[s][n][1] = pack_bf16(w(k + 8, c), w(k + 9, c));
    }
}

__device__ __forceinline__ void gate_product_mma(
    const float* hb, const uint32_t (&wf)[KSTEPS][NT][2], float* red,
    int H, int U, int kw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, c3 = 3 * U;
  const int k0 = warp * kw, k1 = min(H, k0 + kw);
  auto h = [&](int k, int r) {
    return k < k1 && r < RMAX ? hb[k * RMAX + r] : 0.0f;
  };
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] =
      acc[n][3] = 0.0f;
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const int k = k0 + 16 * s + 2 * t;
    if (k0 + 16 * s >= k1) break;
    const uint32_t a0 = pack_bf16(h(k, g), h(k + 1, g));
    const uint32_t a1 = pack_bf16(h(k, g + 8), h(k + 1, g + 8));
    const uint32_t a2 = pack_bf16(h(k + 8, g), h(k + 9, g));
    const uint32_t a3 = pack_bf16(h(k + 8, g + 8), h(k + 9, g + 8));
#pragma unroll
    for (int n = 0; n < NT; ++n)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};"
          : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]),
            "+f"(acc[n][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(wf[s][n][0]),
            "r"(wf[s][n][1]));
  }
  // a lane holds columns c and c + 1 of rows g and g + 8: with an odd 3U
  // the last pair's second column is past the row (column 0 of the next
  // row of red, or for the last row the barriers), and is not stored
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * t;
    if (c >= c3) continue;
    const bool pair = c + 1 < c3;
    float* lo = red + (warp * RMAX + g) * c3 + c;
    lo[0] = acc[n][0];
    if (pair) lo[1] = acc[n][1];
    if (g + 8 < RMAX) {
      lo[8 * c3] = acc[n][2];
      if (pair) lo[8 * c3 + 1] = acc[n][3];
    }
  }
}

template <bool B16, int RL>
__global__ void __launch_bounds__(THREADS, 2) gru_fwd_cluster(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, U = a.U, T = a.T, H3 = 3 * H, c3 = 3 * U;
  float* ws = smem;                              // [H][3U]
  float* hbuf = ws + ws_floats(H, U);            // [2][H][RMAX]
  float* red = hbuf + 2 * H * RMAX;              // [WARPS][RMAX][3U]
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      red + ((WARPS * RMAX * c3 + 1) & ~1));     // [2]

  const unsigned ctas = gridDim.x;               // the cluster spans x
  const unsigned rank = blockIdx.x;              // == %cluster_ctarank
  const int g = blockIdx.z, b0 = blockIdx.y * a.rows;
  const int nb = min(a.rows, a.B - b0);
  const int j0 = rank * U;
  const int kw = (H + WARPS - 1) / WARPS;
  // the bytes of a CTA's slice of a carry buffer (its U units, all RMAX
  // rows), and those a step brings from the other CTAs
  const uint32_t slice = U * RMAX * sizeof(float);
  const uint32_t incoming = (ctas - 1) * slice;

  // Wh[g][:, own columns] -> ws[k][gate * U + jl]; both carries zero
  const float* whg = a.wh + (size_t)g * H * H3;
  for (int i = threadIdx.x; i < H * c3; i += THREADS) {
    const int k = i / c3, c = i % c3, gate = c / U, jl = c % U;
    ws[i] = op<B16>(__ldg(whg + (size_t)k * H3 + gate * H + j0 + jl));
  }
  for (int i = threadIdx.x; i < 2 * H * RMAX; i += THREADS) hbuf[i] = 0.0f;
  uint32_t wf[B16 ? KSTEPS : 1][NT][2];
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (T > 1) mbar_expect(&bar[1], incoming);   // step 1's carry
  }

  // item (b, jl): row b of the group, own unit jl
  const int ib = threadIdx.x / U, jl = threadIdx.x % U, j = j0 + jl;
  const bool on = threadIdx.x < nb * U;
  const size_t row = (size_t)g * a.B + b0 + ib;
  float pr = 0.0f, pz = 0.0f, pn = 0.0f, bnv = 0.0f, carry = 0.0f;
  if (on) {
    const float* pp = a.proj + row * H3;
    pr = __ldg(pp + j);
    pz = __ldg(pp + H + j);
    pn = __ldg(pp + 2 * H + j);
    bnv = __ldg(a.bn + g * H + j);
  }
  // every CTA's buffers zeroed and barriers set before any copy lands
  __syncthreads();
  if constexpr (B16) load_wfrag(wf, ws, H, U, kw);
  cluster_arrive();
  cluster_wait();

  for (int t = 0; t < T; ++t) {
    const bool more = t + 1 < T;
    // the next step's projections, in flight during the product
    float nr = 0.0f, nz = 0.0f, nn = 0.0f;
    if (on && more) {
      const float* pp = a.proj + ((size_t)(t + 1) * 2 * a.B + row) * H3;
      nr = __ldg(pp + j);
      nz = __ldg(pp + H + j);
      nn = __ldg(pp + 2 * H + j);
    }
    // h_{t-1}: buffer t & 1, the other CTAs' slices landed on its barrier
    // (the (t - 1) / 2-th phase of that barrier)
    if (t > 0) mbar_wait(&bar[t & 1], ((t - 1) >> 1) & 1);
    float* hb = hbuf + (t & 1) * H * RMAX;
    if constexpr (B16)
      gate_product_mma(hb, wf, red, H, U, kw);
    else
      gate_product<RL>(hb, ws, red, H, U, kw);
    __syncthreads();
    // every thread has waited on bar[t & 1]: its next phase (step t + 2's
    // carry) may be set up
    if (threadIdx.x == 0 && t + 2 < T) mbar_expect(&bar[t & 1], incoming);
    float* hn = hbuf + ((t + 1) & 1) * H * RMAX;
    if (on) {
      float sr = 0.0f, sz = 0.0f, sn = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float* q = red + (w * RMAX + ib) * c3 + jl;
        sr += q[0];
        sz += q[U];
        sn += q[2 * U];
      }
      const float r = sigmoid_f(pr + sr);
      const float z = sigmoid_f(pz + sz);
      const float n = tanhf(pn + r * (sn + bnv));
      const float hid = (1.0f - z) * n + z * carry;
      a.ys[((size_t)t * 2 * a.B + row) * H + j] = hid;
      carry = op<B16>(hid);
      if (more) hn[j * RMAX + ib] = carry;
      pr = nr;
      pz = nz;
      pn = nn;
    }
    if (more) {
      // the own slice of h_t to every other CTA, one bulk copy each,
      // after the generic stores are made visible to the copies
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (threadIdx.x < ctas && threadIdx.x != rank)
        copy_to(hn + j0 * RMAX, slice, threadIdx.x, &bar[(t + 1) & 1]);
    }
  }
  // no CTA leaves while a copy may still read its shared memory
  cluster_arrive();
  cluster_wait();
}

cudaLaunchConfig_t cluster_config(int ctas, int groups, size_t smem,
                                  cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, groups, 2);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool plan_ok(int B, int H, int ctas, int groups, int rows) {
  return B > 0 && H > 0 && ctas >= 1 && ctas <= CLUSTER_MAX &&
         H % ctas == 0 && H / ctas <= UMAX && rows >= 1 && rows <= RMAX &&
         groups >= 1 && (long)groups * rows >= B &&
         (long)(groups - 1) * rows < B;
}

// the kernel for the carry type and a group's rows
typedef void (*Kernel)(Args);

Kernel kernel_for(int b16, int rows) {
  if (b16) return gru_fwd_cluster<true, 0>;      // mma.sync: rows pad to 16
  if (rows <= 2) return gru_fwd_cluster<false, 1>;
  if (rows <= 4) return gru_fwd_cluster<false, 2>;
  if (rows <= 6) return gru_fwd_cluster<false, 3>;
  return gru_fwd_cluster<false, 6>;
}

cudaError_t prepare(Kernel k, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

}  // namespace

// The forward with an f32 (b16 = 0) or a bf16 (b16 = 1) carry, inputs as
// ttg_gru_fwd_f32 (wh unrounded: the kernel rounds it for the bf16
// carry); writes ys [T, 2B, H].  The plan (ctas a cluster, groups of rows
// batch rows) comes from ops/kernels/gru.py:forward_plan.
extern "C" int ttg_gru_fwd_cluster(const float* proj, const float* wh,
                                   const float* bn, float* ys, int T, int B,
                                   int H, int ctas, int groups, int rows,
                                   int b16, void* stream) {
  if (T < 1 || !plan_ok(B, H, ctas, groups, rows))
    return (int)cudaErrorInvalidValue;
  const int U = H / ctas;
  const size_t smem = sizeof(float) * (size_t)smem_floats(H, U);
  const Kernel k = kernel_for(b16, rows);
  cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      ctas, groups, smem, static_cast<cudaStream_t>(stream), attr);
  const Args a = {proj, wh, bn, ys, T, B, H, U, rows};
  err = cudaLaunchKernelEx(&cfg, k, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of the plan the card holds at once (*count), from
// cudaOccupancyMaxActiveClusters.
extern "C" int ttg_gru_fwd_cluster_occupancy(int H, int ctas, int groups,
                                             int rows, int b16,
                                             int* count) {
  if (ctas < 1 || H % ctas) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)smem_floats(H, H / ctas);
  const Kernel k = kernel_for(b16, rows);
  cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(ctas, groups, smem, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(count, k, &cfg);
}
