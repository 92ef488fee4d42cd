// Bidirectional GRU backward, second design (sm_90a): one persistent
// cluster launch a walk.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/gru.py:199 _bigru_bwd (the
// pallas_call at :220, _bwd_kernel at :113), the reversed walk of
// :608 bigru_pallas_trainable's custom VJP, and the same walk with
// dot_dtype=bfloat16, the backward of :283 bigru_pallas_trainable_bf16.
// Layout and results are gru.cu's first design (gru_bwd_step): time-major
// proj [T, 2B, 3H] f32, the forward outputs ys [T, 2B, H], their gradient
// gy, wh [2, H, 3H], bn [2, H] -> dproj [T, 2B, 3H], dwh [2, H, 3H],
// dbn [2, H], walking t = T-1 .. 0 with dh = 0 at t = T-1.
//
// The first design launches once a step (250 launches a walk at T = 250)
// and every launch stages h_{t-1}, its Wh columns and rows again, reads
// every unit's dcol row from L2 for the dh chain, and adds its slice of
// dWh into device memory.  Here the whole walk is one launch:
//
// 1. Thread-block clusters.  A cluster owns one direction g and one group
//    of at most RMAX = 12 batch rows; its CTAs split the H hidden units, U
//    each (16 CTAs of 16 units at H = 256; the non-portable cluster size).
//    The walks of different rows meet only in the dWh / dbn sums, so no
//    two clusters synchronise inside the walk.  At B = 32 that is 2 x 3
//    clusters of 16 CTAs (rows 11, 11, 10), 96 CTAs of 256 threads: an
//    H100 80GB HBM3 holds 7 such clusters at once
//    (cudaOccupancyMaxActiveClusters), so 2 x 4 groups of 8 rows would
//    run in two waves (chip_smoke.py times that plan beside this one).
// 2. Wh resident.  A CTA keeps Wh[g][:, {r, z, n} x own units] (H x 3U,
//    48 KB f32 at U = 16; bf16-rounded values for the bf16 operands) for
//    the whole walk, twice: thread k holds row k in registers, and a copy
//    in shared memory feeds the gate product.  With it the CTA computes
//    - the gate recompute h_{t-1} . Wh[:, own] (each warp a K slice of
//      KW = 32, a lane 3 columns x 6 rows of it; the slices' sums added
//      in warp order);
//    - a partial dh over all H, dcol[:, own] . Wh[:, own]^T, thread k
//      column k;
//    - dWh[:, own] += h_{t-1}^T . dcol[:, own], thread k row k, kept in
//      registers over the 250 steps, in the same loop as the partial dh
//      (one load of each dcol value feeds both; on the H100 that beat a
//      loop of its own after the arrive).
//    dWh and dbn are written once, per batch group; a second short launch
//    sums the groups in group order, so the result is deterministic (no
//    float atomics).
// 3. The dh chain through distributed shared memory.  Each CTA writes its
//    partial dh [rows][H] into its own shared memory, double-buffered by
//    step parity, and arrives on the cluster barrier
//    (barrier.cluster.arrive.release).  Between arrive and wait it does
//    the work that does not feed the chain: the gate recompute of the next
//    step and the next h tile's loads.  After the wait (wait.acquire) each
//    thread of an own (row, unit) item reads the 16 partials of its unit
//    with ld.shared::cluster, adds them in CTA order and adds dhp z: that
//    is dh for the next step.
// 4. Inputs off the chain.  The h tiles ys[t-1], ys[t-2] sit in a 3-slot
//    ring (k-major, rounded to bf16 for the bf16 operands; HP = 256 rows,
//    zero past H); tile t-3 is loaded into registers at the start of step
//    t's off-chain work and stored at its end.  gy, proj and the f32
//    h_{t-1} of the next step are loaded into the item threads' registers
//    one step ahead.
//
// Numerics.  f32 products are FFMA (no TF32).  With bf16 operands
// (gru.cu:33-40) h_{t-1}, Wh (rounded by the wrapper) and the dcol rows
// are rounded to bf16 for every product; the sums, dz's h_{t-1}, dproj,
// dh, dbn and the accumulators stay f32.  Orders of summation: the gate
// products by warp K slice, the dh chain by CTA, dWh row by row, step by
// step, then over groups, dbn over steps, then rows, then groups;
// ops/kernels/gru.py:gru_backward_cluster_emulated sums in the same
// orders on the CPU.
//
// Bound on the H100 at T = 250, B = 32, H = 256: 131 MB moved, 18.9 GFLOP
// f32 (0.28 ms at 67 TFLOP/s), and 250 dependent steps.  With 11-row
// groups a step costs a CTA 3 x 147K FFMA (12 rows computed), about
// 2 us of issue at one CTA an SM, one cluster barrier and 16
// distributed-shared-memory loads a unit.  Tried on the H100 and slower:
// the remote loads issued before the gate product (it spills), the gate
// product on 24 lanes of 2 columns x 12 rows, 512 threads (two a k, 24
// columns each, at 128 registers: more warps to hide latency, but more
// instructions).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UMAX = 16;               // hidden units a CTA owns, at most
constexpr int CMAX = 3 * UMAX;         // its columns: r, z, n thirds
constexpr int RMAX = 12;               // batch rows of a cluster, at most
constexpr int THREADS = 256;           // one per k, H <= 256
constexpr int HP = THREADS;            // rows of the Wh and h tiles
constexpr int WARPS = THREADS / 32;
constexpr int KW = 32;                 // k a warp takes in the gate product
constexpr int SLOTS = 3;               // h tiles in the ring
constexpr int CLUSTER_MAX = 16;

struct Args {
  const float* proj;
  const float* ys;
  const float* gy;
  const float* wh;
  const float* bn;
  float* dproj;
  float* part;    // [groups][2 H 3H + 2 H]: dwh, then dbn, per group
  int T, B, H, U, rows;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <bool RB>
__device__ __forceinline__ float op(float v) {
  return RB ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the float at the same shared-memory offset as `local`, in CTA `rank` of
// the cluster
__device__ __forceinline__ float ld_cluster(const float* local,
                                            unsigned rank) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(local);
  uint32_t r;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(r) : "memory");
  return v;
}

__host__ __device__ __forceinline__ int slot_of(int s) {
  return (s + SLOTS) % SLOTS;          // s >= -SLOTS
}

// shared memory, in floats: Wh columns [HP][CMAX], the h ring
// [SLOTS][HP][RMAX] (rows past H zero), dcol [RMAX][CMAX], partial dh
// [2][RMAX][H], the gate product's warp sums [WARPS][RMAX][CMAX]
__host__ __device__ __forceinline__ int smem_floats(int H) {
  return HP * CMAX + SLOTS * HP * RMAX + RMAX * CMAX + 2 * RMAX * H +
         WARPS * RMAX * CMAX;
}

// h_{s}[b][k] of the cluster's rows (0 for s < 0 or rows past nb), thread k
__device__ __forceinline__ void tile_fetch(float (&v)[RMAX], const Args& a,
                                           int s, int g, int b0, int nb,
                                           int k) {
#pragma unroll
  for (int b = 0; b < RMAX; ++b)
    v[b] = (s >= 0 && b < nb && k < a.H)
               ? __ldg(a.ys + ((size_t)s * 2 * a.B + g * a.B + b0 + b) *
                                  a.H + k)
               : 0.0f;
}

template <bool B16>
__device__ __forceinline__ void tile_store(float* ring, int s,
                                           const float (&v)[RMAX], int k) {
  float4* d = reinterpret_cast<float4*>(ring +
                                        ((size_t)slot_of(s) * HP + k) * RMAX);
#pragma unroll
  for (int q = 0; q < RMAX / 4; ++q)
    d[q] = make_float4(op<B16>(v[4 * q]), op<B16>(v[4 * q + 1]),
                       op<B16>(v[4 * q + 2]), op<B16>(v[4 * q + 3]));
}

// the RMAX values of row k of ring tile s
__device__ __forceinline__ void tile_row(float (&v)[RMAX], const float* ring,
                                         int s, int k) {
  const float* p = ring + ((size_t)slot_of(s) * HP + k) * RMAX;
#pragma unroll
  for (int q = 0; q < RMAX / 4; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(p + 4 * q);
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// One item thread's state: its (row, unit), the gates of the current step
// and the inputs of the next one.
struct Item {
  bool on;
  int b, jl, j, row;
  float r, z, an, n, hp, gy, bnv;
  float pr, pz, pn, hp_next, gy_next;
  float dh, zpart, dbn;
};

// The gates of step s from h_{s-1} (ring tile s - 1) and proj[s] (already
// in it.pr / pz / pn): each warp sums its K slice of h . Wh[:, own] into
// red, a lane 3 columns x 6 rows of it, then the item threads add the
// slices in warp order.
__device__ __forceinline__ void recompute_gates(Item& it, const float* ring,
                                                const float* ws, float* red,
                                                int s) {
  static_assert(RMAX == 12 && CMAX == 48, "a lane: 3 columns x 6 rows");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ct = lane & 15, rh = lane >> 4;      // column triple, row half
  float acc[6][3];
#pragma unroll
  for (int r = 0; r < 6; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.0f;
#pragma unroll 8
  for (int kk = 0; kk < KW; ++kk) {
    const int k = warp * KW + kk;
    const float* hr =
        ring + ((size_t)slot_of(s - 1) * HP + k) * RMAX + 6 * rh;
    const float2 a0 = *reinterpret_cast<const float2*>(hr);
    const float2 a1 = *reinterpret_cast<const float2*>(hr + 2);
    const float2 a2 = *reinterpret_cast<const float2*>(hr + 4);
    const float hv[6] = {a0.x, a0.y, a1.x, a1.y, a2.x, a2.y};
    const float* wr = ws + k * CMAX + 3 * ct;
    const float w0 = wr[0], w1 = wr[1], w2 = wr[2];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      acc[r][0] = fmaf(hv[r], w0, acc[r][0]);
      acc[r][1] = fmaf(hv[r], w1, acc[r][1]);
      acc[r][2] = fmaf(hv[r], w2, acc[r][2]);
    }
  }
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      red[(warp * RMAX + 6 * rh + r) * CMAX + 3 * ct + c] = acc[r][c];
  __syncthreads();
  if (it.on) {
    float sr = 0.0f, sz = 0.0f, sn = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* q = red + (w * RMAX + it.b) * CMAX + it.jl;
      sr += q[0];
      sz += q[UMAX];
      sn += q[2 * UMAX];
    }
    it.r = sigmoid_f(it.pr + sr);
    it.z = sigmoid_f(it.pz + sz);
    it.an = sn + it.bnv;
    it.n = tanhf(it.pn + it.r * it.an);
  }
}

// the item's inputs of step s: proj[s], gy[s] and the f32 h_{s-1}
__device__ __forceinline__ void item_fetch(Item& it, const Args& a, int s) {
  if (!it.on) return;
  const size_t row = (size_t)s * 2 * a.B + it.row;
  const float* pp = a.proj + row * 3 * a.H;
  it.pr = __ldg(pp + it.j);
  it.pz = __ldg(pp + a.H + it.j);
  it.pn = __ldg(pp + 2 * a.H + it.j);
  it.gy_next = __ldg(a.gy + row * a.H + it.j);
  it.hp_next = s > 0 ? __ldg(a.ys + (row - 2 * a.B) * a.H + it.j) : 0.0f;
}

template <bool B16>
__global__ void __launch_bounds__(THREADS, 1) gru_bwd_cluster(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, U = a.U, T = a.T, H3 = 3 * H;
  float* ws = smem;                              // [HP][CMAX]
  float* ring = ws + HP * CMAX;                  // [SLOTS][HP][RMAX]
  float* dcol = ring + SLOTS * HP * RMAX;        // [RMAX][CMAX]
  float* pbuf = dcol + RMAX * CMAX;              // [2][RMAX][H]
  float* red = pbuf + 2 * RMAX * H;              // [WARPS][RMAX][CMAX]

  const unsigned rank = cluster_rank();
  const unsigned ctas = gridDim.x;               // the cluster spans x
  const int g = blockIdx.z, b0 = blockIdx.y * a.rows;
  const int nb = min(a.rows, a.B - b0);
  const int j0 = rank * U;
  const int k = threadIdx.x;
  const bool kv = k < H;

  // Wh[g][:, own columns] -> ws[k][gate * UMAX + jl], zero past U
  const float* whg = a.wh + (size_t)g * H * H3;
  for (int i = threadIdx.x; i < HP * CMAX; i += THREADS) {
    const int kk = i / CMAX, c = i % CMAX, gate = c / UMAX, jl = c % UMAX;
    ws[i] = kk < H && jl < U
                ? __ldg(whg + (size_t)kk * H3 + gate * H + j0 + jl)
                : 0.0f;
  }
  for (int i = threadIdx.x; i < RMAX * CMAX; i += THREADS) dcol[i] = 0.0f;
  {
    float v[RMAX];
    tile_fetch(v, a, T - 2, g, b0, nb, k);
    tile_store<B16>(ring, T - 2, v, k);
    tile_fetch(v, a, T - 3, g, b0, nb, k);
    tile_store<B16>(ring, T - 3, v, k);
  }

  Item it;
  it.b = threadIdx.x / UMAX;
  it.jl = threadIdx.x % UMAX;
  it.on = threadIdx.x < RMAX * UMAX && it.b < nb && it.jl < U;
  it.j = j0 + it.jl;
  it.row = g * a.B + b0 + it.b;
  it.bnv = it.on ? __ldg(a.bn + g * H + it.j) : 0.0f;
  it.dh = it.zpart = it.dbn = 0.0f;
  item_fetch(it, a, T - 1);
  it.gy = it.gy_next;
  it.hp = it.hp_next;
  __syncthreads();

  float w[CMAX], acc[CMAX];
#pragma unroll
  for (int c4 = 0; c4 < CMAX / 4; ++c4) {
    const float4 v = *reinterpret_cast<const float4*>(ws + k * CMAX + 4 * c4);
    w[4 * c4] = v.x;
    w[4 * c4 + 1] = v.y;
    w[4 * c4 + 2] = v.z;
    w[4 * c4 + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.0f;
  recompute_gates(it, ring, ws, red, T - 1);

  for (int t = T - 1; t >= 0; --t) {
    // the chain: dhp -> da -> dproj[t], dcol
    if (it.on) {
      const float dhp = it.gy + it.dh;
      const float dn = dhp * (1.0f - it.z);
      const float dz = dhp * (it.hp - it.n);
      const float da_n = dn * (1.0f - it.n * it.n);
      const float dr = da_n * it.an;
      const float da_r = dr * it.r * (1.0f - it.r);
      const float da_z = dz * it.z * (1.0f - it.z);
      const float drzn_n = da_n * it.r;
      float* dq = a.dproj + ((size_t)t * 2 * a.B + it.row) * H3;
      dq[it.j] = da_r;
      dq[H + it.j] = da_z;
      dq[2 * H + it.j] = da_n;
      float* dc = dcol + it.b * CMAX + it.jl;
      dc[0] = op<B16>(da_r);
      dc[UMAX] = op<B16>(da_z);
      dc[2 * UMAX] = op<B16>(drzn_n);
      it.dbn += drzn_n;
      it.zpart = dhp * it.z;
    }
    __syncthreads();
    // this CTA's share of dh_{t-1} for every unit, dcol[:, own] Wh[k, own],
    // and with the same dcol loads dWh[k, own] += h_{t-1}[:, k] dcol[:, own]
    // row by row (48 independent chains); at t = 0 h_{t-1} is 0
    float* pb = pbuf + (t & 1) * RMAX * H;
    if (t > 0) {
      float p[RMAX], hv[RMAX];
      tile_row(hv, ring, t - 1, k);
#pragma unroll
      for (int b = 0; b < RMAX; ++b) {
        p[b] = 0.0f;
#pragma unroll
        for (int c4 = 0; c4 < CMAX / 4; ++c4) {
          const float4 d =
              *reinterpret_cast<const float4*>(dcol + b * CMAX + 4 * c4);
          p[b] = fmaf(d.x, w[4 * c4], p[b]);
          p[b] = fmaf(d.y, w[4 * c4 + 1], p[b]);
          p[b] = fmaf(d.z, w[4 * c4 + 2], p[b]);
          p[b] = fmaf(d.w, w[4 * c4 + 3], p[b]);
          acc[4 * c4] = fmaf(hv[b], d.x, acc[4 * c4]);
          acc[4 * c4 + 1] = fmaf(hv[b], d.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(hv[b], d.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(hv[b], d.w, acc[4 * c4 + 3]);
        }
      }
      if (kv) {
#pragma unroll
        for (int b = 0; b < RMAX; ++b) pb[b * H + k] = p[b];
      }
    }
    cluster_arrive();

    // off the chain: the next tile's loads, the gates of step t - 1.  (Every
    // read of dcol came before the arrive, so the next step may write it
    // once the wait says that every thread has arrived.)
    float nxt[RMAX];
    tile_fetch(nxt, a, t - 3, g, b0, nb, k);
    if (t > 0) {
      item_fetch(it, a, t - 1);
      recompute_gates(it, ring, ws, red, t - 1);
    }
    tile_store<B16>(ring, t - 3, nxt, k);
    cluster_wait();

    // dh_{t-1} of own units: the cluster's partials in CTA order, + dhp z
    if (t > 0 && it.on) {
      const float* mine = pb + it.b * H + it.j;
      float v[CLUSTER_MAX];
#pragma unroll
      for (int q = 0; q < CLUSTER_MAX; ++q)
        v[q] = q < (int)ctas ? ld_cluster(mine, q) : 0.0f;
      float s = v[0];
#pragma unroll
      for (int q = 1; q < CLUSTER_MAX; ++q)
        if (q < (int)ctas) s += v[q];
      it.dh = it.zpart + s;
      it.gy = it.gy_next;
      it.hp = it.hp_next;
    }
  }

  // dWh[g][:, own] and dbn[g][own] of this group: staged through the
  // shared memory the walk no longer reads, then written in 16-unit runs
  if (kv) {
#pragma unroll
    for (int c4 = 0; c4 < CMAX / 4; ++c4)
      *reinterpret_cast<float4*>(ws + k * CMAX + 4 * c4) =
          make_float4(acc[4 * c4], acc[4 * c4 + 1], acc[4 * c4 + 2],
                      acc[4 * c4 + 3]);
  }
  if (threadIdx.x < RMAX * UMAX) red[threadIdx.x] = it.dbn;
  __syncthreads();
  const size_t np = (size_t)2 * H * H3 + 2 * H;
  float* out = a.part + blockIdx.y * np;
  for (int i = threadIdx.x; i < H * 3 * U; i += THREADS) {
    const int kk = i / (3 * U), rem = i % (3 * U);
    const int gate = rem / U, jl = rem % U;
    out[((size_t)g * H + kk) * H3 + gate * H + j0 + jl] =
        ws[kk * CMAX + gate * UMAX + jl];
  }
  if (threadIdx.x < U) {
    float s = 0.0f;
    for (int b = 0; b < nb; ++b) s += red[b * UMAX + threadIdx.x];
    out[(size_t)2 * H * H3 + g * H + j0 + threadIdx.x] = s;
  }
}

// out[i] = sum over groups, in group order, of part[group][i]
__global__ void __launch_bounds__(256) gru_sum_groups(
    const float* __restrict__ part, float* __restrict__ out, int n,
    int groups) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int q = 1; q < groups; ++q) s += part[(size_t)q * n + i];
  out[i] = s;
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

template <bool B16>
cudaError_t prepare(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_cluster<B16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(gru_bwd_cluster<B16>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

bool plan_ok(int B, int H, int ctas, int groups, int rows) {
  return B > 0 && H > 0 && H <= THREADS && ctas >= 1 &&
         ctas <= CLUSTER_MAX && H % ctas == 0 && H / ctas <= UMAX &&
         rows >= 1 && rows <= RMAX && groups >= 1 &&
         (long)groups * rows >= B && (long)(groups - 1) * rows < B;
}

template <bool B16>
int bwd(const float* proj, const float* ys, const float* gy,
        const float* wh, const float* bn, float* dproj, float* out,
        float* part, int T, int B, int H, int ctas, int groups, int rows,
        cudaStream_t s) {
  if (T < 1 || !plan_ok(B, H, ctas, groups, rows))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)smem_floats(H);
  cudaError_t err = prepare<B16>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(ctas, groups, smem, s, attr);
  const Args a = {proj, ys, gy, wh, bn, dproj, part, T, B, H, H / ctas,
                  rows};
  err = cudaLaunchKernelEx(&cfg, gru_bwd_cluster<B16>, a);
  if (err != cudaSuccess) return (int)err;
  const int n = 2 * H * 3 * H + 2 * H;
  gru_sum_groups<<<(n + 255) / 256, 256, 0, s>>>(part, out, n, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// The backward with f32 (b16 = 0) or bf16 (b16 = 1; wh then holds
// bf16-rounded values, as for ttg_gru_bwd_bf16) product operands, inputs
// as ttg_gru_bwd.  Writes dproj [T, 2B, 3H] and out [2 H 3H + 2 H] (dwh
// [2, H, 3H], then dbn [2, H]); scratch part [groups][2 H 3H + 2 H].  The
// plan (ctas a cluster, groups of rows batch rows) comes from
// ops/kernels/gru.py:cluster_plan.
extern "C" int ttg_gru_bwd_cluster(const float* proj, const float* ys,
                                   const float* gy, const float* wh,
                                   const float* bn, float* dproj, float* out,
                                   float* part, int T, int B, int H,
                                   int ctas, int groups, int rows, int b16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return b16 ? bwd<true>(proj, ys, gy, wh, bn, dproj, out, part, T, B, H,
                         ctas, groups, rows, s)
             : bwd<false>(proj, ys, gy, wh, bn, dproj, out, part, T, B, H,
                          ctas, groups, rows, s);
}

// How many clusters of the plan the card holds at once (*count), from
// cudaOccupancyMaxActiveClusters.
extern "C" int ttg_gru_bwd_cluster_occupancy(int H, int ctas, int groups,
                                             int b16, int* count) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(H);
  cudaError_t err = b16 ? prepare<true>(smem) : prepare<false>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(ctas, groups, smem, 0, attr);
  return (int)(b16 ? cudaOccupancyMaxActiveClusters(
                         count, gru_bwd_cluster<true>, &cfg)
                   : cudaOccupancyMaxActiveClusters(
                         count, gru_bwd_cluster<false>, &cfg));
}
