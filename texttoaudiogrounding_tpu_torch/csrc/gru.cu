// Bidirectional GRU recurrence, forward and backward (sm_90a).
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/gru.py:62 bigru_pallas
// (forward, f32 or bf16 carry) and :199 _bigru_bwd (the reversed walk of
// bigru_pallas_trainable's custom VJP).  Layout as there: time-major
// proj [T, 2B, 3H] f32 (input projections + biases; direction-0 rows, then
// direction-1 rows already time-flipped), wh [2, H, 3H], bn [2, H] (the
// recurrent n-gate bias) -> ys [T, 2B, H] f32.  Gates follow torch's
// nn.GRU: r = sig(p_r + h Wr), z = sig(p_z + h Wz),
// n = tanh(p_n + r (h Wn + b_n)), h' = (1 - z) n + z h.
//
// Design: one launch per time step, issued by a loop inside the C entry
// point (no Python between steps).  Wh is 1.5 MB in f32 at H = 256, more
// than one SM's shared memory, so the hidden units are split across blocks:
// block (c, g) owns JT = 4 units of direction g, keeps their 3 x JT columns
// of Wh[g] in shared memory for the step and stages the whole previous
// carry h_{t-1} [B, H] of its direction (the grid-wide exchange of h goes
// through L2 between launches).  At H = 256 that is 64 x 2 = 128 blocks of
// 512 threads: each (row, unit) item's dot products are split over KS = 4
// neighbouring lanes, which shortens the dependent FMA chains 4 times and
// are summed with shuffles.
//
// The backward launch for step t (walking t = T-1 .. 0) fuses three
// products per block: the dh chain of step t+1 for its own units,
// dh[b, j] = dhp z + sum_c dcol_{t+1}[b, c] Wh[g][j, c] (the dcol rows of
// every unit, written by all blocks in the previous launch, come from L2);
// the gate recompute from h_{t-1} (the forward outputs shifted by one);
// and the accumulation of its own column slice of dWh[g] and dbn[g] over
// all B rows, which therefore needs no reduction across blocks or atomics.
// dcol ping-pongs between two buffers so a launch never reads what it
// writes.
//
// The bf16-operand backward (gru.py:199 with dot_dtype=bfloat16, the
// backward of :283 bigru_pallas_trainable_bf16) is the same walk with every
// product's operands rounded to bf16 and f32 sums: the staged h_{t-1}, Wh
// (rounded by the wrapper) and the dcol rows that feed the dh chain and
// dWh.  Rounding the saved f32 outputs reproduces the bf16 forward's carry
// exactly, so the recomputed gates match that forward bit for bit.  The
// gate arithmetic, dz's h_{t-1}, dproj, dh, dbn and the accumulators stay
// f32.
//
// The hoisted backward replaces gru.py:540 bigru_pallas_trainable_v2 and
// :566 bigru_pallas_trainable_v3 (walks :302 _bwd_kernel_v2 and :359
// _bwd_kernel_v3): the same reversed walk with no dWh or dbn inside it.
// Each step writes dproj[t] = [da_r | da_z | da_n] and drznn[t] = da_n r,
// and the caller takes dWh[g] = sum_{t,b} h_{t-1}^T [da_r | da_z | drznn]
// and dbn = sum drznn as one f32 matrix product and a sum after the walk
// (outside any kernel, as the JAX package leaves them to XLA).  Without
// its B x H x 3JT FMA loop a step launch does only the dh chain and the
// gate recompute, and step t+1's dcol rows need no scratch: they are read
// back from dproj[t+1] (r and z thirds) and drznn[t+1] (the n third).  v2
// sums the dh chain as one K = 3H dot, v3 as three K = H dots added in
// gate order, as the two TPU kernels do.  Bound on the H100 at the shapes
// below: the walk moves 150 MB for 12.6 GFLOP f32 (0.19 ms), the dWh
// product 6.3 GFLOP more (0.094 ms); the 250 dependent steps are the real
// limit here too.
//
// Bound on the H100 at T = 250, B = 32, H = 256: the forward moves 67 MB
// (proj 49 MB, ys 16 MB) for 6.3 GFLOP f32 (0.094 ms at 67 TFLOP/s); the
// backward 131 MB for 18.9 GFLOP (0.28 ms).  Both are really limited by
// latency: 250 dependent steps, each at least one launch.  This version
// runs the products on the CUDA cores from shared memory, with no tensor
// cores; its staging loads are plain vector loads, unrolled but not
// overlapped with the products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int JT = 4;         // hidden units per block
constexpr int KS = 4;         // lanes that split one dot product's K
constexpr int THREADS = 512;

// sum over the KS neighbouring lanes that share one (row, unit) item
__device__ __forceinline__ float group_sum(float v) {
  const unsigned mask = 0xFu << (threadIdx.x & 28);
  v += __shfl_xor_sync(mask, v, 1);
  v += __shfl_xor_sync(mask, v, 2);
  return v;
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// floats of the staged carry hs [B][H + 1], rounded up to a multiple of 4
// so that the next array is 16-byte aligned for vector stores
__host__ __device__ __forceinline__ int hs_floats(int B, int H) {
  return (B * (H + 1) + 3) & ~3;
}

// v rounded to bf16 (kept as f32) when RB, else v
template <bool RB>
__device__ __forceinline__ float op(float v) {
  return RB ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ void store_c(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_c(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four consecutive carry values as f32 (16 or 8 bytes, aligned: H % 4 == 0)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// hs[b][k] (row stride H + 1) <- carry rows of direction g, zero at t = 0,
// rounded to bf16 when RB; wc[k][gate][jl] <- Wh[g][k][gate * H + j0 + jl].
// Vector loads, unrolled so that several are in flight per thread (each
// waits on L2).
template <typename C, bool RB = false>
__device__ __forceinline__ void stage(const C* __restrict__ hprev,
                                      const float* __restrict__ wh,
                                      float* hs, float* wc, int g, int j0,
                                      int B, int H) {
  const int ldh = H + 1, h4 = H / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < B * h4; i += blockDim.x) {
    const int b = i / h4, k = (i % h4) * 4;
    const float4 v = hprev ? load4(hprev + (size_t)(g * B + b) * H + k)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float* d = hs + b * ldh + k;
    d[0] = op<RB>(v.x);
    d[1] = op<RB>(v.y);
    d[2] = op<RB>(v.z);
    d[3] = op<RB>(v.w);
  }
  const float* w = wh + (size_t)g * H * 3 * H;
#pragma unroll 4
  for (int i = threadIdx.x; i < H * 3; i += blockDim.x) {
    const int k = i / 3, gate = i % 3;   // JT == 4: one float4 per (k, gate)
    *reinterpret_cast<float4*>(wc + i * JT) =
        load4(w + (size_t)k * 3 * H + gate * H + j0);
  }
}

// (h_{t-1} Wh)[b, gate * H + j0 + jl] for the three gates; lane ks of the
// item's group takes k = ks, ks + KS, ... and the group sums its partials
__device__ __forceinline__ void recurrent_dot(const float* hs,
                                              const float* wc, int b, int jl,
                                              int ks, int H, float& ar,
                                              float& az, float& an) {
  const float* hrow = hs + b * (H + 1);
  ar = az = an = 0.0f;
#pragma unroll 8
  for (int k = ks; k < H; k += KS) {
    const float hv = hrow[k];
    const float* w = wc + k * 3 * JT + jl;
    ar = fmaf(hv, w[0], ar);
    az = fmaf(hv, w[JT], az);
    an = fmaf(hv, w[2 * JT], an);
  }
  ar = group_sum(ar);
  az = group_sum(az);
  an = group_sum(an);
}

template <typename C>
__global__ void __launch_bounds__(THREADS)
    gru_fwd_step(const float* __restrict__ proj, const float* __restrict__ wh,
                 const float* __restrict__ bn, const C* __restrict__ hprev,
                 C* __restrict__ hnext, float* __restrict__ ys, int t, int B,
                 int H) {
  extern __shared__ float smem[];
  float* hs = smem;                          // [B][H + 1]
  float* wc = smem + hs_floats(B, H);        // [H][3][JT]
  const int g = blockIdx.y, j0 = blockIdx.x * JT;
  stage(hprev, wh, hs, wc, g, j0, B, H);
  __syncthreads();
  const int ks = threadIdx.x % KS;
  for (int i = threadIdx.x / KS; i < B * JT; i += blockDim.x / KS) {
    const int b = i / JT, jl = i % JT, j = j0 + jl;
    float ar, az, an;
    recurrent_dot(hs, wc, b, jl, ks, H, ar, az, an);
    if (ks) continue;
    const size_t row = (size_t)t * 2 * B + g * B + b;
    const float* pp = proj + row * 3 * H;
    const float r = sigmoid_f(pp[j] + ar);
    const float z = sigmoid_f(pp[H + j] + az);
    const float n = tanhf(pp[2 * H + j] + r * (an + bn[g * H + j]));
    const float hid = (1.0f - z) * n + z * hs[b * (H + 1) + j];
    ys[row * H + j] = hid;
    if (hnext) store_c(hnext + (size_t)(g * B + b) * H + j, hid);
  }
}

template <bool B16>
__global__ void __launch_bounds__(THREADS)
    gru_bwd_step(const float* __restrict__ proj, const float* __restrict__ ys,
                 const float* __restrict__ gy, const float* __restrict__ wh,
                 const float* __restrict__ bn, float* __restrict__ dproj,
                 float* __restrict__ dwh, float* __restrict__ dbn,
                 const float* __restrict__ dcol_prev,
                 float* __restrict__ dcol_cur, float* __restrict__ part,
                 int t, int T, int B, int H) {
  extern __shared__ float smem[];
  const int ldr = 3 * H + 1;
  float* hs = smem;                          // [B][H + 1]   h_{t-1}
  float* wc = hs + hs_floats(B, H);          // [H][3][JT]   Wh columns
  float* wr = wc + H * 3 * JT;               // [JT][3H + 1] Wh rows
  float* dc = wr + JT * ldr;                 // [B][3][JT]   this step's dcol
  float* dnr = dc + B * 3 * JT;              // [B][JT]      f32 drzn_n (B16)
  const int g = blockIdx.y, j0 = blockIdx.x * JT;
  const int H3 = 3 * H;
  const float* yprev =
      t > 0 ? ys + (size_t)(t - 1) * 2 * B * H : (const float*)nullptr;
  stage<float, B16>(yprev, wh, hs, wc, g, j0, B, H);
  const bool chain = t < T - 1;
  if (chain) {
    const float* w = wh + (size_t)g * H * H3;
    const int c4 = H3 / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < JT * c4; i += blockDim.x) {
      const int jl = i / c4, c = (i % c4) * 4;
      const float4 v = load4(w + (size_t)(j0 + jl) * H3 + c);
      float* d = wr + jl * ldr + c;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  }
  __syncthreads();

  const int ks = threadIdx.x % KS;
  for (int i = threadIdx.x / KS; i < B * JT; i += blockDim.x / KS) {
    const int b = i / JT, jl = i % JT, j = j0 + jl;
    const int brow = g * B + b;
    float dh = 0.0f;
    if (chain) {
      const float4* dp =
          reinterpret_cast<const float4*>(dcol_prev + (size_t)brow * H3);
      const float* w = wr + jl * ldr;
      float s = 0.0f;
#pragma unroll 4
      for (int c = ks; c < H3 / 4; c += KS) {
        const float4 d = __ldg(dp + c);
        s = fmaf(d.x, w[4 * c], s);
        s = fmaf(d.y, w[4 * c + 1], s);
        s = fmaf(d.z, w[4 * c + 2], s);
        s = fmaf(d.w, w[4 * c + 3], s);
      }
      dh = part[(size_t)brow * H + j] + group_sum(s);
    }
    float ar, az, arn;
    recurrent_dot(hs, wc, b, jl, ks, H, ar, az, arn);
    if (ks) continue;
    const size_t row = (size_t)t * 2 * B + brow;
    const float* pp = proj + row * H3;
    const float r = sigmoid_f(pp[j] + ar);
    const float z = sigmoid_f(pp[H + j] + az);
    const float an = arn + bn[g * H + j];
    const float n = tanhf(pp[2 * H + j] + r * an);
    // h_{t-1} in dz is the f32 output, whatever the products' operands
    const float hp = !B16 ? hs[b * (H + 1) + j]
                     : yprev ? yprev[(size_t)brow * H + j]
                             : 0.0f;

    const float dhp = gy[row * H + j] + dh;
    const float dn = dhp * (1.0f - z);
    const float dz = dhp * (hp - n);
    const float da_n = dn * (1.0f - n * n);
    const float dr = da_n * an;
    const float da_r = dr * r * (1.0f - r);
    const float da_z = dz * z * (1.0f - z);
    const float drzn_n = da_n * r;
    float* dq = dproj + row * H3;
    dq[j] = da_r;
    dq[H + j] = da_z;
    dq[2 * H + j] = da_n;
    float* dcw = dcol_cur + (size_t)brow * H3;
    dcw[j] = op<B16>(da_r);
    dcw[H + j] = op<B16>(da_z);
    dcw[2 * H + j] = op<B16>(drzn_n);
    part[(size_t)brow * H + j] = dhp * z;
    dc[(b * 3 + 0) * JT + jl] = op<B16>(da_r);
    dc[(b * 3 + 1) * JT + jl] = op<B16>(da_z);
    dc[(b * 3 + 2) * JT + jl] = op<B16>(drzn_n);
    if (B16) dnr[b * JT + jl] = drzn_n;
  }
  __syncthreads();

  // dWh[g][k][gate * H + j0 + jl] += sum_b h_{t-1}[b, k] dcol[b, gate, jl]
  float* dw = dwh + (size_t)g * H * H3;
#pragma unroll 4
  for (int o = threadIdx.x; o < H * 3 * JT; o += blockDim.x) {
    const int k = o / (3 * JT), rem = o % (3 * JT);
    const int gate = rem / JT, jl = rem % JT;
    float s = 0.0f;
#pragma unroll 8
    for (int b = 0; b < B; ++b)
      s = fmaf(hs[b * (H + 1) + k], dc[(b * 3 + gate) * JT + jl], s);
    dw[(size_t)k * H3 + gate * H + j0 + jl] += s;
  }
  if (threadIdx.x < JT) {
    const int jl = threadIdx.x;
    float s = 0.0f;
    for (int b = 0; b < B; ++b)
      s += B16 ? dnr[b * JT + jl] : dc[(b * 3 + 2) * JT + jl];
    dbn[g * H + j0 + jl] += s;
  }
}

// sum over c = ks, ks + KS, ... < n4 of d[c] . w[4c .. 4c + 3], on a
// running sum s (one lane's share of a dot product split over KS lanes)
__device__ __forceinline__ float dot4(const float4* d, const float* w,
                                      int ks, int n4, float s) {
#pragma unroll 4
  for (int c = ks; c < n4; c += KS) {
    const float4 v = d[c];
    s = fmaf(v.x, w[4 * c], s);
    s = fmaf(v.y, w[4 * c + 1], s);
    s = fmaf(v.z, w[4 * c + 2], s);
    s = fmaf(v.w, w[4 * c + 3], s);
  }
  return s;
}

// The walk of the hoisted backward (v2 / v3): gru_bwd_step's gate
// recompute and dh chain without its dWh / dbn accumulation.  The dcol
// rows of step t + 1 are read straight from that step's outputs:
// [da_r | da_z] from dproj[t + 1] and da_n r from drznn[t + 1], which this
// launch writes for step t.  PER_THIRD sums the dh chain as v3 does,
// ((dhp z + da_r Wr^T) + da_z Wz^T) + drznn Wn^T, three K = H dots;
// otherwise as v2, dhp z + dcols Wh^T, one K = 3H dot.
template <bool PER_THIRD>
__global__ void __launch_bounds__(THREADS)
    gru_bwd_walk(const float* __restrict__ proj, const float* __restrict__ ys,
                 const float* __restrict__ gy, const float* __restrict__ wh,
                 const float* __restrict__ bn, float* __restrict__ dproj,
                 float* __restrict__ drznn, float* __restrict__ part, int t,
                 int T, int B, int H) {
  extern __shared__ float smem[];
  const int ldr = 3 * H + 1;
  float* hs = smem;                          // [B][H + 1]   h_{t-1}
  float* wc = hs + hs_floats(B, H);          // [H][3][JT]   Wh columns
  float* wr = wc + H * 3 * JT;               // [JT][3H + 1] Wh rows
  const int g = blockIdx.y, j0 = blockIdx.x * JT;
  const int H3 = 3 * H;
  const float* yprev =
      t > 0 ? ys + (size_t)(t - 1) * 2 * B * H : (const float*)nullptr;
  stage<float>(yprev, wh, hs, wc, g, j0, B, H);
  const bool chain = t < T - 1;
  if (chain) {
    const float* w = wh + (size_t)g * H * H3;
    const int c4 = H3 / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < JT * c4; i += blockDim.x) {
      const int jl = i / c4, c = (i % c4) * 4;
      const float4 v = load4(w + (size_t)(j0 + jl) * H3 + c);
      float* d = wr + jl * ldr + c;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  }
  __syncthreads();

  const int ks = threadIdx.x % KS, h4 = H / 4;
  for (int i = threadIdx.x / KS; i < B * JT; i += blockDim.x / KS) {
    const int b = i / JT, jl = i % JT, j = j0 + jl;
    const int brow = g * B + b;
    float dh = 0.0f;
    if (chain) {
      const size_t next = (size_t)(t + 1) * 2 * B + brow;
      const float4* dp = reinterpret_cast<const float4*>(dproj + next * H3);
      const float4* dnr = reinterpret_cast<const float4*>(drznn + next * H);
      const float* w = wr + jl * ldr;
      const float p = part[(size_t)brow * H + j];
      if (PER_THIRD) {
        const float sr = group_sum(dot4(dp, w, ks, h4, 0.0f));
        const float sz = group_sum(dot4(dp + h4, w + H, ks, h4, 0.0f));
        const float sn = group_sum(dot4(dnr, w + 2 * H, ks, h4, 0.0f));
        dh = ((p + sr) + sz) + sn;
      } else {
        float s = dot4(dp, w, ks, 2 * h4, 0.0f);     // the r and z thirds
        s = dot4(dnr, w + 2 * H, ks, h4, s);         // the n third
        dh = p + group_sum(s);
      }
    }
    float ar, az, arn;
    recurrent_dot(hs, wc, b, jl, ks, H, ar, az, arn);
    if (ks) continue;
    const size_t row = (size_t)t * 2 * B + brow;
    const float* pp = proj + row * H3;
    const float r = sigmoid_f(pp[j] + ar);
    const float z = sigmoid_f(pp[H + j] + az);
    const float an = arn + bn[g * H + j];
    const float n = tanhf(pp[2 * H + j] + r * an);
    const float hp = hs[b * (H + 1) + j];

    const float dhp = gy[row * H + j] + dh;
    const float dn = dhp * (1.0f - z);
    const float dz = dhp * (hp - n);
    const float da_n = dn * (1.0f - n * n);
    const float dr = da_n * an;
    float* dq = dproj + row * H3;
    dq[j] = dr * r * (1.0f - r);
    dq[H + j] = dz * z * (1.0f - z);
    dq[2 * H + j] = da_n;
    drznn[row * H + j] = da_n * r;
    part[(size_t)brow * H + j] = dhp * z;
  }
}

size_t fwd_smem(int B, int H) {
  return sizeof(float) * ((size_t)hs_floats(B, H) + (size_t)H * 3 * JT);
}

size_t bwd_smem(int B, int H, bool b16) {
  return sizeof(float) * ((size_t)hs_floats(B, H) + (size_t)H * 3 * JT +
                          (size_t)JT * (3 * H + 1) +
                          (size_t)B * (b16 ? 4 : 3) * JT);
}

template <bool B16>
int bwd(const float* proj, const float* ys, const float* gy, const float* wh,
        const float* bn, float* dproj, float* dwh, float* dbn, float* dcol,
        float* part, int T, int B, int H, cudaStream_t s) {
  if (H % JT) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(B, H, B16);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_step<B16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H / JT, 2);
  const size_t half = (size_t)2 * B * 3 * H;
  for (int t = T - 1; t >= 0; --t) {
    gru_bwd_step<B16><<<grid, THREADS, smem, s>>>(
        proj, ys, gy, wh, bn, dproj, dwh, dbn, dcol + ((t + 1) % 2) * half,
        dcol + (t % 2) * half, part, t, T, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

size_t walk_smem(int B, int H) {
  return sizeof(float) * ((size_t)hs_floats(B, H) + (size_t)H * 3 * JT +
                          (size_t)JT * (3 * H + 1));
}

template <bool PER_THIRD>
int walk(const float* proj, const float* ys, const float* gy, const float* wh,
         const float* bn, float* dproj, float* drznn, float* part, int T,
         int B, int H, cudaStream_t s) {
  if (H % JT) return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem(B, H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_walk<PER_THIRD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H / JT, 2);
  for (int t = T - 1; t >= 0; --t) {
    gru_bwd_walk<PER_THIRD><<<grid, THREADS, smem, s>>>(
        proj, ys, gy, wh, bn, dproj, drznn, part, t, T, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename C>
int fwd(const float* proj, const float* wh, const float* bn, float* ys,
        C* hbuf, int T, int B, int H, cudaStream_t stream) {
  if (H % JT) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(B, H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_step<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H / JT, 2);
  const size_t carry = (size_t)2 * B * H;
  for (int t = 0; t < T; ++t) {
    const C* hprev = nullptr;
    C* hnext = nullptr;
    if (hbuf) {                  // carry in its own type, ping-ponged
      if (t > 0) hprev = hbuf + (t % 2) * carry;
      hnext = hbuf + ((t + 1) % 2) * carry;
    } else if (t > 0) {          // f32 carry: the previous output
      hprev = reinterpret_cast<const C*>(ys + (size_t)(t - 1) * carry);
    }
    gru_fwd_step<C><<<grid, THREADS, smem, stream>>>(proj, wh, bn, hprev,
                                                     hnext, ys, t, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// proj [T, 2B, 3H] f32, wh [2, H, 3H] f32, bn [2, H] f32 -> ys [T, 2B, H].
extern "C" int ttg_gru_fwd_f32(const float* proj, const float* wh,
                               const float* bn, float* ys, int T, int B,
                               int H, void* stream) {
  return fwd<float>(proj, wh, bn, ys, nullptr, T, B, H,
                    static_cast<cudaStream_t>(stream));
}

// The bf16 carry: wh holds bf16-rounded values (as f32), the carry that
// feeds the recurrent product and the z h term is rounded to bf16 after
// every step in hbuf [2, 2B, H] bf16; ys stays the f32 value.
extern "C" int ttg_gru_fwd_bf16(const float* proj, const float* wh,
                                const float* bn, float* ys, void* hbuf,
                                int T, int B, int H, void* stream) {
  return fwd<__nv_bfloat16>(proj, wh, bn, ys,
                            static_cast<__nv_bfloat16*>(hbuf), T, B, H,
                            static_cast<cudaStream_t>(stream));
}

// Backward of the f32 recurrence.  ys [T, 2B, H] forward outputs, gy the
// gradient of ys; dproj [T, 2B, 3H] written; dwh [2, H, 3H] and dbn [2, H]
// accumulated (zeroed by the caller); scratch dcol [2, 2B, 3H] and
// part [2B, H].
extern "C" int ttg_gru_bwd(const float* proj, const float* ys,
                           const float* gy, const float* wh, const float* bn,
                           float* dproj, float* dwh, float* dbn, float* dcol,
                           float* part, int T, int B, int H, void* stream) {
  return bwd<false>(proj, ys, gy, wh, bn, dproj, dwh, dbn, dcol, part, T, B,
                    H, static_cast<cudaStream_t>(stream));
}

// The bf16-operand backward, with the arguments of ttg_gru_bwd; wh holds
// bf16-rounded values (as f32), as for ttg_gru_fwd_bf16.
extern "C" int ttg_gru_bwd_bf16(const float* proj, const float* ys,
                                const float* gy, const float* wh,
                                const float* bn, float* dproj, float* dwh,
                                float* dbn, float* dcol, float* part, int T,
                                int B, int H, void* stream) {
  return bwd<true>(proj, ys, gy, wh, bn, dproj, dwh, dbn, dcol, part, T, B,
                   H, static_cast<cudaStream_t>(stream));
}

// The walk of the hoisted f32 backward, v2 (the dh chain as one K = 3H
// dot) and v3 (three K = H dots).  Inputs as ttg_gru_bwd; writes dproj
// [T, 2B, 3H] and drznn [T, 2B, H] (da_n r, the n third of dcol); scratch
// part [2B, H].  dWh and dbn are the caller's products over drznn, dproj
// and the shifted outputs after the walk.
extern "C" int ttg_gru_bwd_v2(const float* proj, const float* ys,
                              const float* gy, const float* wh,
                              const float* bn, float* dproj, float* drznn,
                              float* part, int T, int B, int H,
                              void* stream) {
  return walk<false>(proj, ys, gy, wh, bn, dproj, drznn, part, T, B, H,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int ttg_gru_bwd_v3(const float* proj, const float* ys,
                              const float* gy, const float* wh,
                              const float* bn, float* dproj, float* drznn,
                              float* part, int T, int B, int H,
                              void* stream) {
  return walk<true>(proj, ys, gy, wh, bn, dproj, drznn, part, T, B, H,
                    static_cast<cudaStream_t>(stream));
}
