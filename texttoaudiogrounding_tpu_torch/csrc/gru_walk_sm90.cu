// The walks of the hoisted f32 GRU backwards v2 and v3, second design
// (sm_90a): one persistent cluster launch a walk.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/gru.py:540
// bigru_pallas_trainable_v2 and :566 bigru_pallas_trainable_v3, whose
// walks are :302 _bwd_kernel_v2 and :359 _bwd_kernel_v3 (their
// pallas_calls at :492 and :428).  Layout and results are gru.cu's first
// design (gru_bwd_walk): time-major proj [T, 2B, 3H] f32, the forward
// outputs ys [T, 2B, H], their gradient gy, wh [2, H, 3H], bn [2, H] ->
// dproj [T, 2B, 3H] = [da_r | da_z | da_n] and drznn [T, 2B, H] = da_n r,
// walking t = T-1 .. 0 with dh = 0 at t = T-1.  No dWh or dbn inside the
// walk: the caller takes them after it as one f32 matrix product and a
// sum (ops/kernels/gru.py:hoisted_weight_grads), as the JAX package
// leaves them to XLA.
//
// The first design launches once a step (250 launches a walk at T = 250),
// and every launch stages h_{t-1} and its Wh columns and rows again, reads
// every unit's dcol row of step t+1 back from L2 and goes through a
// scratch array in device memory for dhp z.  Here the whole walk is one
// launch:
//
// 1. Thread-block clusters, as gru_fwd_sm90.cu / gru_bwd_sm90.cu: a
//    cluster owns one direction g and one group of at most RMAX = 12
//    batch rows; its CTAs split the H units, U each (16 CTAs of 16 units
//    at H = 256, the non-portable cluster size).  Rows never meet in the
//    walk, so clusters never wait on one another.  At B = 32: 2 x 3
//    clusters of 16 CTAs (rows 11, 11, 10).
// 2. Wh on chip twice.  Wh[g][:, {r, z, n} x own units] (H x 3U, 48 KB at
//    U = 16) in shared memory feeds the gate recompute, and the rows
//    Wh[g][own unit, :] feed the dh chain from registers: a lane holds two
//    units' rows over the 24 columns it sums (48 floats).
// 3. Each step t, on the chain:
//    a. the own (row, unit) items' dhp = gy + dh, the pre-activation
//       gradients, dproj[t] and drznn[t] to device memory, and the own
//       dcol slice [da_r | da_z | da_n r] (3 x 16 units x RMAX rows,
//       2,304 bytes, units past U zero) into this CTA's chunk of the
//       exchange buffer;
//    b. that chunk to the other CTAs of the cluster, one cp.async.bulk
//       shared::cluster copy each, counted on the receiver's mbarrier
//       (gru_fwd_sm90.cu note 4: double-buffered by step parity, no
//       cluster barrier inside the walk; the same argument orders it
//       here, with dcol in place of h);
//    c. off the chain while the copies fly: the gate recompute of step
//       t-1, h_{t-2} . Wh[:, own], as gru_fwd_sm90.cu's product (each
//       warp a K slice of ceil(H / 8), a lane 3 columns x R/2 rows, the
//       slices added in warp order);
//    d. wait for the other CTAs' chunks, then dh_{t-1}[:, own] =
//       dhp z + dcol_t . Wh[own, :]^T over all 3H columns: warp w takes
//       the chunks of CTAs 2w and 2w + 1, each quarter of the warp half a
//       chunk (8 units of each third), a lane two units x R rows of it;
//       a reduce-scatter over the quarters (18 shuffles a lane at R = 12)
//       leaves each lane one unit x R/2 rows of the warp's sum, and the
//       item threads add the warps' sums in warp order.  On the H100 this
//       ran the walk a little faster than 16 lanes of one unit x R rows
//       each, each lane half reading a whole chunk.
// 4. Inputs two steps ahead.  Step t issues, as one group of 4-byte
//    cp.async copies into shared memory, the h tile ys[t-4] (k-major
//    [H][RMAX], rows past the group zero) and its items' gy[t-2],
//    h_{t-3} and proj[t-3]; three slots of each, and cp.async.wait_group 1
//    at the top of a step.  On the H100 that took about half the walk's
//    floor at B = 1, H = 4 away, against loads into registers a step
//    ahead, which the gates and the ring stores waited for.
//
// The two variants differ only in the order of the dh sum, as the TPU
// walks do.  With S_q,h: CTA q's units 8h .. 8h + 7, summed in unit order,
// and P_w = (S_2w,0 + S_2w,1) + (S_2w+1,0 + S_2w+1,1):
//   v2, one K = 3H accumulation:  dh = dhp z + sum_w P_w, each S_q,h the
//       r, then z, then n third in one accumulator;
//   v3, three K = H sums added in gate order:
//       dh = ((dhp z + sum_w P_w,r) + sum_w P_w,z) + sum_w P_w,n.
// ops/kernels/gru.py:gru_walk_cluster_emulated sums in these orders on the
// CPU.  A reduce-scatter of per-CTA partial dh (gru_bwd_sm90.cu) would sum
// by CTA and erase the difference; exchanging dcol keeps it.
//
// Loops run to the real H and rows (R, a template argument picked from the
// plan, 2, 4, 6 or 12 rows computed), so that the walk at B = 1, H = 4
// measures a step's latency in one CTA and at B = 1, H = 256 that of the
// 16 CTAs' exchange (chip_smoke.py's latency and exchange floors).
//
// Numerics: f32 FFMA throughout, no TF32 (row 16 is f32 only).
//
// Bound on the H100 at T = 250, B = 32, H = 256: the walk moves 150 MB for
// 12.6 GFLOP f32 (0.19 ms at 67 TFLOP/s), and 250 dependent steps.  A step
// costs a CTA two products of 12 x 48 x 256 = 147K FFMA each (the gate
// recompute off the chain, the dh sum on it), one 2,304-byte copy to each
// other CTA and one barrier wait.  The plan at B = 32: 2 x 3 clusters of
// 16 CTAs, 208,656 bytes of shared memory a CTA, one CTA an SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UMAX = 16;               // hidden units a CTA owns, at most
constexpr int RMAX = 12;               // batch rows of a cluster, at most
constexpr int THREADS = 256;           // one per k in the tile loads
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = RMAX * UMAX;     // (row, unit) items a CTA, at most
constexpr int CLUSTER_MAX = 16;        // two CTAs' dcol chunks a warp
constexpr int SLOTS = 3;               // steps of h tiles and item inputs
constexpr int INPUTS = 5;              // an item's: gy, h_{t-1}, proj x 3
// floats of one CTA's chunk of the dcol exchange buffer, [3][UMAX][RMAX]
// (units past U zero), and 4 more so that the two chunks one warp reads
// lie on other banks
constexpr int CHUNK = 3 * UMAX * RMAX + 4;

struct Args {
  const float* proj;
  const float* ys;
  const float* gy;
  const float* wh;
  const float* bn;
  float* dproj;
  float* drznn;
  int T, B, H, U, rows;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
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

// Wait for the barrier's phase of the given parity to complete; after
// about 2^34 cycles (some 9 s) the kernel traps instead of hanging.
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

// one float from device to shared memory, in the step's group of copies
__device__ __forceinline__ void load_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// every group of copies but the newest has landed (for this thread)
__device__ __forceinline__ void wait_async_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__host__ __device__ __forceinline__ int slot_of(int s) {
  return (s + 2 * SLOTS) % SLOTS;      // s >= -2 SLOTS
}

// floats of the Wh columns [H][3U], padded to 16 bytes
__host__ __device__ __forceinline__ int ws_floats(int H, int U) {
  return (H * 3 * U + 3) & ~3;
}

// floats of the gate product's warp sums [WARPS][RMAX][3U], padded
__host__ __device__ __forceinline__ int redg_floats(int U) {
  return (WARPS * RMAX * 3 * U + 3) & ~3;
}

// shared memory, in floats: the Wh columns, the h ring [SLOTS][H][RMAX],
// the items' inputs [SLOTS][INPUTS][ITEMS], the dcol exchange buffers
// [2][ctas][CHUNK], the gate product's warp sums, the dh sum's
// [WARPS][3][RMAX][UMAX], then two 8-byte barriers
__host__ __device__ __forceinline__ int smem_floats(int H, int U, int ctas) {
  return ws_floats(H, U) + SLOTS * H * RMAX + SLOTS * INPUTS * ITEMS +
         2 * ctas * CHUNK + redg_floats(U) + WARPS * 3 * RMAX * UMAX + 4;
}

// Each warp's K slice of h_{s-1} . Wh[:, own] into red: lane (ct, rh)
// takes columns 3 ct .. 3 ct + 2 of the 3U and rows rh RL .. rh RL + RL - 1
// (gru_fwd_sm90.cu's gate_product)
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

// rows 0 .. R-1 of one column of a dcol chunk (16-byte aligned)
template <int R>
__device__ __forceinline__ void load_rows(float (&v)[R], const float* p) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(p + 4 * q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      const float2 x = *reinterpret_cast<const float2*>(p + 2 * q);
      v[2 * q] = x.x;
      v[2 * q + 1] = x.y;
    }
  }
}

// The dh sum's products.  Lane (up, kq) of warp w, quarter kq = lane / 8,
// takes CTA q = 2 w + kq / 2's chunk of dcol (zero sums for q past the
// cluster), its units' half hh = kq % 2 (units 8 hh .. 8 hh + 7 of each
// third), against wd, the Wh rows of units 2 up and 2 up + 1 over those
// columns (zero past U), for R rows: 2 x R sums, a quarter's lanes reading
// the same dcol rows.  The four quarters' sums are added by a
// reduce-scatter, (hh 0 + hh 1 of chunk 2 w) + (the same of chunk
// 2 w + 1), and red[w][third][row][unit] gets the warp's sum (v3 a third
// at a time, v2 all three in one accumulator, third 0).
template <bool PER_THIRD, int R>
__device__ __forceinline__ void dh_product(const float* db,
                                           const float (&wd)[3][8][2],
                                           float* red, int U, int ctas) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int up = lane & 7, kq = lane >> 3, q = 2 * warp + (kq >> 1);
  const float* src = db + q * CHUNK + 8 * (kq & 1) * RMAX;
  const bool odd = kq & 1, hi = kq >> 1;
  // after the reduce-scatter: unit 2 up + odd, rows hi R/2 .. + R/2 - 1
  const int jo = 2 * up + odd, r0 = hi * (R / 2);
  float acc[2][R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[0][r] = acc[1][r] = 0.0f;
#pragma unroll
  for (int th = 0; th < 3; ++th) {
    if (q < ctas) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float d[R];
        load_rows<R>(d, src + (th * UMAX + c) * RMAX);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[0][r] = fmaf(d[r], wd[th][c][0], acc[0][r]);
          acc[1][r] = fmaf(d[r], wd[th][c][1], acc[1][r]);
        }
      }
    }
    if (PER_THIRD || th == 2) {
      float v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {      // the unit pair's halves
        const float send = odd ? acc[0][r] : acc[1][r];
        v[r] = (odd ? acc[1][r] : acc[0][r]) +
               __shfl_xor_sync(0xffffffffu, send, 8);
      }
      float* out = red + ((warp * 3 + (PER_THIRD ? th : 0)) * RMAX + r0) *
                   UMAX + jo;
#pragma unroll
      for (int r = 0; r < R / 2; ++r) {  // the two chunks
        const float send = hi ? v[r] : v[r + R / 2];
        const float sum = (hi ? v[r + R / 2] : v[r]) +
                          __shfl_xor_sync(0xffffffffu, send, 16);
        if (jo < U) out[r * UMAX] = sum;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc[0][r] = acc[1][r] = 0.0f;
    }
  }
}

// One item thread's state: its (row, unit) and the gates of the current
// step; its inputs come through the staging slots.
struct Item {
  bool on;
  int b, jl, j;
  size_t row;
  float r, z, an, n, bnv, dh, zpart;
};

// The copies a step s issues for step s - 2 (SLOTS - 1 steps ahead): the
// h tile s - 4 (thread k its column, rows below nb; zeros for s - 4 < 0)
// and the items' inputs of step s - 2 (gy, h_{s-3} for its chain, proj of
// s - 3 for the gates it recomputes), as one group of cp.async copies.
__device__ __forceinline__ void prefetch(const Args& a, const Item& it,
                                         float* ring, float* stage, int s,
                                         int g, int b0, int nb) {
  const int k = threadIdx.x, tile = s - 4, step = s - 2;
  if (k < a.H) {
    float* d = ring + ((size_t)slot_of(tile) * a.H + k) * RMAX;
    for (int b = 0; b < nb; ++b) {
      if (tile >= 0)
        load_async(d + b, a.ys + ((size_t)tile * 2 * a.B + g * a.B + b0 + b) *
                                     a.H + k);
      else
        d[b] = 0.0f;
    }
  }
  if (it.on && step >= 0) {
    float* st = stage + slot_of(step) * INPUTS * ITEMS + threadIdx.x;
    const size_t row = (size_t)step * 2 * a.B + it.row;
    load_async(st, a.gy + row * a.H + it.j);
    if (step > 0) {
      const float* pp = a.proj + (row - 2 * a.B) * 3 * a.H;
      load_async(st + ITEMS, a.ys + (row - 2 * a.B) * a.H + it.j);
      load_async(st + 2 * ITEMS, pp + it.j);
      load_async(st + 3 * ITEMS, pp + a.H + it.j);
      load_async(st + 4 * ITEMS, pp + 2 * a.H + it.j);
    } else {
      st[ITEMS] = 0.0f;                  // h_{-1}
    }
  }
  commit_async();
}

// the item's gates from its proj values and the gate product's warp sums,
// added in warp order
__device__ __forceinline__ void item_gates(Item& it, float pr, float pz,
                                           float pn, const float* red,
                                           int U) {
  if (!it.on) return;
  const int c3 = 3 * U;
  float sr = 0.0f, sz = 0.0f, sn = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float* q = red + (w * RMAX + it.b) * c3 + it.jl;
    sr += q[0];
    sz += q[U];
    sn += q[2 * U];
  }
  it.r = sigmoid_f(pr + sr);
  it.z = sigmoid_f(pz + sz);
  it.an = sn + it.bnv;
  it.n = tanhf(pn + it.r * it.an);
}

template <bool PER_THIRD, int R>
__global__ void __launch_bounds__(THREADS, 1) gru_walk_cluster(Args a) {
  static_assert(R % 2 == 0 && R <= RMAX, "rows computed: 2, 4, 6 or 12");
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, U = a.U, T = a.T, H3 = 3 * H, c3 = 3 * U;
  const unsigned ctas = gridDim.x;               // the cluster spans x
  const unsigned rank = blockIdx.x;              // == %cluster_ctarank
  const int g = blockIdx.z, b0 = blockIdx.y * a.rows;
  const int nb = min(a.rows, a.B - b0);
  const int j0 = rank * U;
  const int kw = (H + WARPS - 1) / WARPS;
  float* ws = smem;                              // [H][3U]
  float* ring = ws + ws_floats(H, U);            // [SLOTS][H][RMAX]
  float* stage = ring + SLOTS * H * RMAX;        // [SLOTS][INPUTS][ITEMS]
  float* dbuf = stage + SLOTS * INPUTS * ITEMS;  // [2][ctas][CHUNK]
  float* redg = dbuf + 2 * ctas * CHUNK;         // [WARPS][RMAX][3U]
  float* redd = redg + redg_floats(U);           // [WARPS][3][RMAX][UMAX]
  uint64_t* bar = reinterpret_cast<uint64_t*>(redd + WARPS * 3 * RMAX * UMAX);
  // the bytes a step brings from the other CTAs' chunks
  const uint32_t slice = (CHUNK - 4) * sizeof(float);
  const uint32_t incoming = (ctas - 1) * slice;

  // Wh[g][:, own columns] -> ws[k][gate * U + jl]; the h ring and the
  // exchange buffers zero (rows past the group's, units past U stay so)
  const float* whg = a.wh + (size_t)g * H * H3;
  for (int i = threadIdx.x; i < H * c3; i += THREADS) {
    const int kk = i / c3, c = i % c3, gate = c / U, jl = c % U;
    ws[i] = __ldg(whg + (size_t)kk * H3 + gate * H + j0 + jl);
  }
  for (int i = threadIdx.x; i < SLOTS * H * RMAX; i += THREADS)
    ring[i] = 0.0f;
  for (int i = threadIdx.x; i < 2 * (int)ctas * CHUNK; i += THREADS)
    dbuf[i] = 0.0f;
  // lane (up, kq) of warp w: wd[third][c][u] = Wh[g][j0 + 2 up + u]
  // [third * H + q U + 8 (kq % 2) + c], q = 2 w + kq / 2 (dh_product)
  float wd[3][8][2];
  {
    const int lane = threadIdx.x & 31, up = lane & 7, kq = lane >> 3;
    const int q = 2 * (threadIdx.x >> 5) + (kq >> 1), c0 = 8 * (kq & 1);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jo = 2 * up + u;
      const bool ok = q < (int)ctas && jo < U;
      const float* wrow =
          whg + (size_t)(j0 + (ok ? jo : 0)) * H3 + q * U + c0;
#pragma unroll
      for (int th = 0; th < 3; ++th)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          wd[th][c][u] = ok && c0 + c < U ? __ldg(wrow + th * H + c) : 0.0f;
    }
  }
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // the exchanges of the first two steps (t = T-1 and T-2, each > 0)
    if (T > 1) mbar_expect(&bar[0], incoming);
    if (T > 2) mbar_expect(&bar[1], incoming);
  }

  // item (b, jl): row b of the group, own unit jl
  Item it;
  it.b = threadIdx.x / U;
  it.jl = threadIdx.x % U;
  it.on = threadIdx.x < nb * U;
  it.j = j0 + it.jl;
  it.row = (size_t)g * a.B + b0 + it.b;
  it.bnv = it.on ? __ldg(a.bn + g * H + it.j) : 0.0f;
  it.dh = it.zpart = 0.0f;
  // the gates of step T-1 from tile T-2 and proj[T-1], loaded here; the
  // copies that steps T+1 and T would have issued (tiles T-3, T-4, the
  // inputs of steps T-1, T-2), issued here
  __syncthreads();
  if (threadIdx.x < H && T >= 2)
    for (int b = 0; b < nb; ++b)
      ring[((size_t)slot_of(T - 2) * H + threadIdx.x) * RMAX + b] =
          __ldg(a.ys + ((size_t)(T - 2) * 2 * a.B + g * a.B + b0 + b) * H +
                threadIdx.x);
  float pp[3] = {0.0f, 0.0f, 0.0f};
  if (it.on) {
    const float* p = a.proj + ((size_t)(T - 1) * 2 * a.B + it.row) * H3;
    pp[0] = __ldg(p + it.j);
    pp[1] = __ldg(p + H + it.j);
    pp[2] = __ldg(p + 2 * H + it.j);
  }
  prefetch(a, it, ring, stage, T + 1, g, b0, nb);
  prefetch(a, it, ring, stage, T, g, b0, nb);
  __syncthreads();
  gate_product<R / 2>(ring + (size_t)slot_of(T - 2) * H * RMAX, ws, redg, H,
                      U, kw);
  __syncthreads();
  item_gates(it, pp[0], pp[1], pp[2], redg, U);
  // every CTA's buffers zeroed and barriers set before any copy lands
  cluster_arrive();
  cluster_wait();

  for (int t = T - 1, i = 0; t >= 0; --t, ++i) {
    const int p = i & 1;                         // exchange buffer, barrier
    float* db = dbuf + p * ctas * CHUNK;
    // this step's inputs (issued two steps ago) have landed
    wait_async_but_one();
    const float* in = stage + slot_of(t) * INPUTS * ITEMS + threadIdx.x;
    // the chain: dhp -> da -> dproj[t], drznn[t] and the own dcol slice
    if (it.on) {
      const float dhp = in[0] + it.dh;
      const float dn = dhp * (1.0f - it.z);
      const float dz = dhp * (in[ITEMS] - it.n);
      const float da_n = dn * (1.0f - it.n * it.n);
      const float dr = da_n * it.an;
      const float da_r = dr * it.r * (1.0f - it.r);
      const float da_z = dz * it.z * (1.0f - it.z);
      const float drzn_n = da_n * it.r;
      const size_t row = (size_t)t * 2 * a.B + it.row;
      float* dq = a.dproj + row * H3;
      dq[it.j] = da_r;
      dq[H + it.j] = da_z;
      dq[2 * H + it.j] = da_n;
      a.drznn[row * H + it.j] = drzn_n;
      float* own = db + rank * CHUNK + it.jl * RMAX + it.b;
      own[0] = da_r;
      own[UMAX * RMAX] = da_z;
      own[2 * UMAX * RMAX] = drzn_n;
      it.zpart = dhp * it.z;
    }
    if (t == 0) break;
    // the own slice to every other CTA, after the generic stores are made
    // visible to the copies
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x < ctas && threadIdx.x != rank)
      copy_to(db + rank * CHUNK, slice, threadIdx.x, &bar[p]);

    // off the chain: the copies for step t-2, then the gates of step t-1
    // from tile t-2 and proj[t-1]
    prefetch(a, it, ring, stage, t, g, b0, nb);
    gate_product<R / 2>(ring + (size_t)slot_of(t - 2) * H * RMAX, ws, redg,
                        H, U, kw);
    __syncthreads();
    item_gates(it, in[2 * ITEMS], in[3 * ITEMS], in[4 * ITEMS], redg, U);

    // dh_{t-1} of own units, once the other CTAs' slices have landed (the
    // (i / 2)-th phase of this buffer's barrier)
    mbar_wait(&bar[p], (i >> 1) & 1);
    dh_product<PER_THIRD, R>(db, wd, redd, U, ctas);
    __syncthreads();
    // every thread has waited on bar[p]: its next phase (step t-2's
    // exchange) may be set up
    if (threadIdx.x == 0 && t > 2) mbar_expect(&bar[p], incoming);
    if (it.on) {
      const float* s = redd + it.b * UMAX + it.jl;
      if (PER_THIRD) {
        float sum[3];
#pragma unroll
        for (int th = 0; th < 3; ++th) {
          sum[th] = s[th * RMAX * UMAX];
#pragma unroll
          for (int w = 1; w < WARPS; ++w)
            sum[th] += s[(w * 3 + th) * RMAX * UMAX];
        }
        it.dh = ((it.zpart + sum[0]) + sum[1]) + sum[2];
      } else {
        float sum = s[0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) sum += s[w * 3 * RMAX * UMAX];
        it.dh = it.zpart + sum;
      }
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
  return B > 0 && H > 0 && H <= THREADS && ctas >= 1 &&
         ctas <= CLUSTER_MAX && H % ctas == 0 && H / ctas <= UMAX &&
         rows >= 1 && rows <= RMAX && groups >= 1 &&
         (long)groups * rows >= B && (long)(groups - 1) * rows < B;
}

// the kernel for the variant and a group's rows
typedef void (*Kernel)(Args);

template <bool PER_THIRD>
Kernel kernel_rows(int rows) {
  if (rows <= 2) return gru_walk_cluster<PER_THIRD, 2>;
  if (rows <= 4) return gru_walk_cluster<PER_THIRD, 4>;
  if (rows <= 6) return gru_walk_cluster<PER_THIRD, 6>;
  return gru_walk_cluster<PER_THIRD, 12>;
}

Kernel kernel_for(int per_third, int rows) {
  return per_third ? kernel_rows<true>(rows) : kernel_rows<false>(rows);
}

cudaError_t prepare(Kernel k, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

}  // namespace

// The walk of the hoisted f32 backward, v2 (per_third = 0) or v3
// (per_third = 1), inputs as ttg_gru_bwd_v2 (gru.cu); writes dproj
// [T, 2B, 3H] and drznn [T, 2B, H].  The plan (ctas a cluster, groups of
// rows batch rows) comes from ops/kernels/gru.py:walk_plan.
extern "C" int ttg_gru_walk_cluster(const float* proj, const float* ys,
                                    const float* gy, const float* wh,
                                    const float* bn, float* dproj,
                                    float* drznn, int T, int B, int H,
                                    int ctas, int groups, int rows,
                                    int per_third, void* stream) {
  if (T < 1 || !plan_ok(B, H, ctas, groups, rows))
    return (int)cudaErrorInvalidValue;
  const int U = H / ctas;
  const size_t smem = sizeof(float) * (size_t)smem_floats(H, U, ctas);
  const Kernel k = kernel_for(per_third, rows);
  cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      ctas, groups, smem, static_cast<cudaStream_t>(stream), attr);
  const Args a = {proj, ys, gy, wh, bn, dproj, drznn, T, B, H, U, rows};
  err = cudaLaunchKernelEx(&cfg, k, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of the plan the card holds at once (*count), from
// cudaOccupancyMaxActiveClusters.
extern "C" int ttg_gru_walk_cluster_occupancy(int H, int ctas, int groups,
                                              int rows, int per_third,
                                              int* count) {
  if (ctas < 1 || H % ctas) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t)smem_floats(H, H / ctas, ctas);
  const Kernel k = kernel_for(per_third, rows);
  cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(ctas, groups, smem, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(count, k, &cfg);
}
