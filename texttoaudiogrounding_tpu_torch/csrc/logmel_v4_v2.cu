// Row 10 of the port, second design (sm_90a): the log-mel frontend of row
// 1 (logmel_v2.cu) on v4's schedule, each tile's power -> mel -> dB
// epilogue run under the next pass's products.
//
// Replaces texttoaudiogrounding_tpu/ops/pallas/logmel.py:175
// fused_log_mel_spectrogram_v4 (kernel _v4_kernel :133): row 1's function
// and framing with the epilogue deferred so that it overlaps the next
// tile's DFT, which the TPU kernel's docstring (:179-188) says Mosaic never
// managed.  As JAX holds v4 to its shipped kernel, this design is held bit
// for bit to row 1's second design: the same wave_pad_kernel input
// (logmel_v2.cuh, npad_v2), the same interleaved basis (here as stage
// images) and band tables (ops/kernels/logmel.py interleaved_basis,
// mel_bands, _tables_v2), and every output the same sequence of the same
// operations:
//   * each 128-frame tile's four passes of 256 columns (128 bins) are the
//     same wgmma m64n256k16 bf16 -> f32 products in the same K order, two
//     a 64-byte K stage, each warpgroup 64 frames, the accumulators zeroed
//     for each pass;
//   * power __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
//   * each mel's sum over its filter's nonzero bins in ascending f,
//     __fadd_rn(m, __fmul_rn(p, w)) from 0, across the four passes;
//   * out = 10 / ln 10 logf(fmaxf(mel, 1e-10)).
//
// What changes is the schedule.  In logmel_v2_kernel each pass ends with
// all 256 threads forming the power and walking the mel sums behind a
// wgmma_wait<0> and two __syncthreads while the tensor cores idle, every
// stage waits at a __syncthreads, and each of the 256 blocks (2 waves at
// 32 clips x 10 s) fills and drains its own ring.  Here:
//   1. wave_pad_kernel, as row 1.
//   2. logmel_v4_v2_kernel, one persistent block an SM (grid = min(SMs,
//      tiles)), walks the call's 128-frame tiles clip-major: block k takes
//      tiles k, k + grid, k + 2 grid, ... (tile i is clip i / tpc, frames
//      from (i % tpc) 128).  Three roles, split once by warp:
//      * a producer warp (warp 8) fills a 4-slot ring in the 64-byte
//        swizzle of conv_igemm_sm90.cuh.  A, 128 frame rows x 64 bytes
//        read in place at 640-byte steps, is 16 cp.async copies of 16
//        bytes a lane; B, 256 basis rows x 64 bytes, is one bulk copy
//        (cp.async.bulk, the copy engine, no tensor map) by lane 0 of the
//        stage's 16 KB image, which the wrapper lays out once in the
//        ring's swizzle, counted on the slot's full mbarrier as it lands.
//        Its stages run on across passes and tiles, so the next tile's
//        first stages load under the current tile's last epilogue.  Each
//        lane arrives on the slot's full mbarrier (32 arrivals and the B
//        bytes) by cp.async.mbarrier.arrive.noinc, which fires when its
//        copies have landed, so the warp only ever waits for a free slot
//        (its empty mbarrier, 256 arrivals); the consumers fence the
//        landed A to the async proxy before their wgmma read it.  (A
//        first form made each lane wait for its copies, cp.async.wait_group,
//        before arriving: that held each stage's arrival back behind the
//        issue of the stages after it.)
//      * two consumer warpgroups (warps 0-7) wait on a slot's full
//        barrier, issue the two wgmma, keep one group in flight and
//        release the slot before it on its empty barrier.  At the end of
//        a pass they wait for the products, release the last slot, wait
//        for pw to be free (pw_empty), write the pass's power into pw
//        [bin][frame], arrive on pw_full, zero the accumulators and go on
//        to the next pass's stages, which the producer has already
//        loaded;
//      * three epilogue warps (warps 9-11): warp e takes mels e, e + 3,
//        ... (21 or 22, so that wide and narrow filters mix) and lane l
//        frames l + 32 k (k < 4).  They wait on pw_full, add the pass's
//        in-band bins of their mels into 4 x 22 running sums held in
//        registers (band and weights read from shared memory), release
//        pw (pw_empty, 96 arrivals), and after a tile's fourth pass apply
//        the dB and store the tile while the consumers run the next
//        tile's first pass.
//      pw is single-buffered: the consumers write it again only at the
//      end of the next pass, 32 stages later, and only after the epilogue
//      warps have released it.  Row 1's 33 KB array of mel sums in
//      shared memory is gone.  A wait that never completes traps instead
//      of hanging the card.
//
// Budgets.  Shared memory 173,904 B of the 232,448 a block may have: the
// ring 4 x (8,192 A + 16,384 B) = 98,304, pw 128 bins x 136 x 4 = 69,632,
// band 768 and up to 1,024 weights 4,096, 10 mbarriers 80, 1,024 to align
// the ring.  Timed on the H100 beside row 1, a ring of 4 slots ran faster
// than one of 3, 5 or 6, and copying A through L1 (cp.async.ca) was slower
// than past it.  Registers: 384 threads at __launch_bounds__(384, 1), at
// most 168 a thread (64,512 of the SM's 65,536; ptxas uses 154); the
// consumers hold 128 f32 accumulators, the epilogue 88 sums.  No
// setmaxnreg: ptxas (CUDA 12.9) budgets a block of 416 or 512 threads at
// 128 registers a thread whatever setmaxnreg asks, and then refuses the
// wgmma ("Insufficient registers (128)"); at 384 threads it serialized
// the consumers' wgmma (C7512) with setmaxnreg and not without it.  So a
// fourth warpgroup for a separate producer does not fit, and the producer
// is one warp beside three epilogue warps.
//
// Bound on the H100: operations, as row 1: 2.1 GFLOP of bf16 a 10 s clip
// (the 446 weighted bins: 1.5 GFLOP), against 1.28 MB of f32 waveform in
// and 0.26 MB out.  What this design leaves on the table: as row 1, each
// tile reads the 2 MB basis and, four times, its frames from L2, 3 MB a
// tile against 268 MFLOP (768 MiB a call at 32 clips x 10 s), which holds
// the tensor cores well below their rate.  A 2-block cluster in which
// each block multicasts half of each stage's B image to both
// (cp.async.bulk .multicast::cluster, a slot freed by both blocks'
// consumers) halves the basis reads: timed on the H100 it gave the same
// bits but ran slower than this design, and was not kept.
#include "conv_igemm_sm90.cuh"
#include "logmel_v2.cuh"

namespace {

using ttg::bf16;
namespace v2 = ttg::v2;
using ttg_mel_v2::wave_pad_kernel;

constexpr int HOP = 320, NFFT = 1024, NBIN = 512, NM = 64;
constexpr int BMF = 128;                    // frames of a tile
constexpr int BNC = 256;                    // columns of a pass: 128 bins
constexpr int PBIN = BNC / 2;
constexpr int NPASS = NBIN / PBIN;          // 4
constexpr int KST = NFFT * 2 / v2::KB;      // 32 K stages of a pass
constexpr int TST = NPASS * KST;            // 128 stages of a tile
constexpr int STAGES = 4;                   // ring slots
constexpr int NCONS = 256;                  // two consumer warpgroups
constexpr int NPROD = 32;                   // the producer warp
constexpr int NEW = 3;                      // epilogue warps
constexpr int NEPI = 32 * NEW;
constexpr int NTH = NCONS + NPROD + NEPI;   // 384
constexpr int MPW = (64 + NEW - 1) / NEW;   // mels of an epilogue warp
constexpr int FPL = 128 / 32;               // frames of an epilogue lane
constexpr int A_STAGE = BMF * v2::KB, B_STAGE = BNC * v2::KB;
constexpr int LDP = BMF + 8;                // power [bin][frame]
constexpr int MAXW = 1024;                  // nonzero mel weights held
constexpr int RING = STAGES * (A_STAGE + B_STAGE);
constexpr int PW_BYTES = PBIN * LDP * 4;
constexpr int TAB_BYTES = NM * 3 * 4 + MAXW * 4;
constexpr int NBAR = 2 * STAGES + 2;
constexpr int SMEM = RING + PW_BYTES + TAB_BYTES + NBAR * 8 + 1024;
constexpr float DB = 4.342944819032518f;    // 10 / ln 10
static_assert(SMEM <= 232448, "shared memory of a block");

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar))
               : "memory");
}
// one arrival on the barrier once this thread's cp.async copies so far have
// landed (counted against the barrier's arrivals: .noinc)
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   saddr(bar))
               : "memory");
}
// the barrier's current phase also waits for `bytes` of copies to land
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(
                   saddr(bar)),
               "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16) from device memory by the bulk-copy engine,
// counted on `bar` as they land
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}
// Wait for the barrier's phase of the given parity to complete.  The spin
// is a loop inside the asm: a C++ loop around try_wait is a branch that
// ptxas must treat as divergent, and a wgmma after one is serialized
// (C7518).  After 2^26 failed tries (seconds) the kernel traps instead of
// hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .u32 n;\n mov.u32 n, 0;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra DONE;\n"
      " add.u32 n, n, 1;\n"
      " setp.gt.u32 p, n, 67108864;\n"
      " @p trap;\n"
      " bra WAIT;\n"
      "DONE:\n}" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}

// The block's tiles: blockIdx.x + k gridDim.x < ntiles, k = 0, 1, ...
//   xpad [B, npad] bf16; basis the 128 stage images [NPASS][KST] of 256
//   rows x 64 bytes in the ring's swizzled layout (row 2f + e of the
//   interleaved basis the real (e = 0) or imaginary part of bin f,
//   K-major; ops/kernels/logmel_v4.py stage_images); band [NM, 3]
//   int (first bin, end bin, offset into wts); wts [nw] f32 (nw <= MAXW);
//   out [B, T, NM] f32; tpc = ceil(T / 128) tiles a clip.
__global__ void __launch_bounds__(NTH, 1)
    logmel_v4_v2_kernel(const bf16* __restrict__ xpad, long long npad,
                        const bf16* __restrict__ basis,
                        const int* __restrict__ band,
                        const float* __restrict__ wts, int nw,
                        float* __restrict__ out, int T, int tpc,
                        int ntiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  unsigned char* As = smem;
  unsigned char* Bs = smem + STAGES * A_STAGE;
  float* pw = reinterpret_cast<float*>(smem + RING);        // [PBIN][LDP]
  int* bt = reinterpret_cast<int*>(smem + RING + PW_BYTES);  // band
  float* wt = reinterpret_cast<float*>(bt + NM * 3);         // weights
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + RING + PW_BYTES + TAB_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* pw_full = empty + STAGES;
  uint64_t* pw_empty = pw_full + 1;

  const int tid = threadIdx.x;
  for (int i = tid; i < NM * 3; i += NTH) bt[i] = band[i];
  for (int i = tid; i < nw; i += NTH) wt[i] = wts[i];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + s, NPROD);
      bar_init(empty + s, NCONS);
    }
    bar_init(pw_full, NCONS);
    bar_init(pw_empty, NEPI);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int mine = (int)blockIdx.x < ntiles
                       ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int total = mine * TST;             // the block's K stages
  const int warp_id = tid >> 5, lane = tid & 31;
  // the warpgroup, from lane 0, and the consumers' branch first, on it
  // alone: ptxas then sees that branch as uniform over each warpgroup and
  // does not serialize its wgmma (C7518), as it does when the branch also
  // tests the warp
  const int wgroup = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (wgroup < NCONS / 128) {
    // the consumer warpgroups: frames 64 wg + [0, 64) of each tile
    const int wg = tid >> 7, warp = warp_id & 3;
    const int row0 = wg * 64 + warp * 16 + (lane >> 2);
    float acc[BNC / 2];
#pragma unroll
    for (int i = 0; i < BNC / 2; ++i) acc[i] = 0.0f;
    v2::fence_acc(acc);
    for (int g = 0; g < total; ++g) {
      const int slot = g % STAGES, kc = g % KST;
      bar_wait(full + slot, (g / STAGES) & 1);
      v2::fence_async_shared();             // A landed through cp.async
      const unsigned char* as = As + slot * A_STAGE + wg * 64 * v2::KB;
      const unsigned char* bs = Bs + slot * B_STAGE;
      v2::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < v2::KB / 32; ++ks)
        v2::wgmma_bf16_n256(acc, v2::smem_desc(as + ks * 32),
                            v2::smem_desc(bs + ks * 32));
      v2::wgmma_commit();
      v2::wgmma_wait<1>();
      if (kc > 0) bar_arrive(empty + (g - 1) % STAGES);
      if (kc != KST - 1) continue;

      // end of pass q: its power into pw once the epilogue has read the
      // last pass's
      const int q = g / KST;
      v2::wgmma_wait<0>();
      v2::fence_acc(acc);
      bar_arrive(empty + slot);
      bar_wait(pw_empty, (q & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < BNC / 8; ++j) {
        const int bin = 4 * j + (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float re = acc[4 * j + 2 * h], im = acc[4 * j + 2 * h + 1];
          pw[bin * LDP + row0 + 8 * h] =
              __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
        }
      }
      bar_arrive(pw_full);
#pragma unroll
      for (int i = 0; i < BNC / 2; ++i) acc[i] = 0.0f;
      v2::fence_acc(acc);
    }
  } else if (warp_id == NCONS / 32) {
    // the producer warp: of A, lane l takes igemm_kernel's pieces q = 32 i
    // + l, row 8 i + l % 8 at 16-byte chunk (l / 8) % 4; B is one bulk copy
    // of the stage's image, issued by lane 0
    const int r8 = lane & 7, c = lane >> 3;
    const int dst = r8 * v2::KB + ((c ^ (r8 >> 1)) << 4);
    const unsigned char* img = reinterpret_cast<const unsigned char*>(basis);
    constexpr int STEP = 8;                 // rows between a lane's pieces
    for (int g = 0; g < total; ++g) {
      const int slot = g % STAGES;
      bar_wait(empty + slot, ((g / STAGES) & 1) ^ 1);
      const int tile = blockIdx.x + (g / TST) * gridDim.x;
      const int b = tile / tpc, f0 = (tile - b * tpc) * BMF;
      const int pass = (g % TST) / KST, kc = g % KST;
      const unsigned char* xa =
          reinterpret_cast<const unsigned char*>(xpad + (long long)b * npad) +
          (long long)(f0 + r8) * HOP * 2 + c * 16 + kc * v2::KB;
      unsigned char* as = As + slot * A_STAGE + dst;
#pragma unroll
      for (int i = 0; i < BMF / STEP; ++i)
        v2::cp_async16(as + i * STEP * v2::KB, xa + i * STEP * HOP * 2);
      if (lane == 0) {
        bar_expect(full + slot, B_STAGE);
        bulk_load(Bs + slot * B_STAGE,
                  img + (long long)(pass * KST + kc) * B_STAGE, B_STAGE,
                  full + slot);
      }
      bar_arrive_copies(full + slot);
    }
  } else {
    // an epilogue warp: mels e + 3 j, frames lane + 32 k of each tile
    const int e = warp_id - NCONS / 32 - 1;
    float m[FPL][MPW];
#pragma unroll
    for (int k = 0; k < FPL; ++k)
#pragma unroll
      for (int j = 0; j < MPW; ++j) m[k][j] = 0.0f;
    for (int t = 0; t < mine; ++t) {
      const int tile = blockIdx.x + t * gridDim.x;
      const int b = tile / tpc, f0 = (tile - b * tpc) * BMF;
      for (int p = 0; p < NPASS; ++p) {
        bar_wait(pw_full, (t * NPASS + p) & 1);
        const int lo_p = p * PBIN, hi_p = lo_p + PBIN;
        const float* pl = pw + lane - lo_p * LDP;
#pragma unroll
        for (int j = 0; j < MPW; ++j) {
          const int mel = e + NEW * j;
          if (mel >= NM) continue;
          const int lo = max(bt[3 * mel], lo_p);
          const int hi = min(bt[3 * mel + 1], hi_p);
          const float* w = wt + bt[3 * mel + 2] - bt[3 * mel];
          for (int f = lo; f < hi; ++f) {
            const float wf = w[f];
#pragma unroll
            for (int k = 0; k < FPL; ++k)
              m[k][j] = __fadd_rn(m[k][j],
                                  __fmul_rn(pl[f * LDP + 32 * k], wf));
          }
        }
        bar_arrive(pw_empty);
      }
#pragma unroll
      for (int k = 0; k < FPL; ++k) {
        const int f = f0 + lane + 32 * k;
        float* o = out + ((long long)b * T + f) * NM + e;
#pragma unroll
        for (int j = 0; j < MPW; ++j) {
          if (f < T && e + NEW * j < NM)
            o[NEW * j] = DB * logf(fmaxf(m[k][j], 1e-10f));
          m[k][j] = 0.0f;
        }
      }
    }
  }
}

}  // namespace

// x [B, N] f32 (N > n_fft / 2); xpad [B, npad] bf16 scratch as row 1's
// (npad % 8 == 0, npad >= (ceil(T / 128) 128 - 1) 320 + 1024); basis
// [128, 256, 32] bf16 (the interleaved basis as stage images); band [64, 3]
// int32; wts
// [nw] f32 (nw <= 1024); out [B, T, 64] f32; grid the persistent blocks,
// 1 <= grid <= B ceil(T / 128).
extern "C" int ttg_logmel_v4_v2(const float* x, int B, int N, void* xpad,
                                long long npad, int T, const void* basis,
                                const int* band, const float* wts, int nw,
                                float* out, int grid, void* stream) {
  const int tpc = (T + BMF - 1) / BMF, ntiles = B * tpc;
  if (nw > MAXW || grid < 1 || grid > ntiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* xp = static_cast<bf16*>(xpad);
  const long long nvec = (long long)B * npad / 8;
  wave_pad_kernel<<<v2::blocks_for(nvec, 256), 256, 0, st>>>(
      x, xp, N, NFFT / 2, npad, nvec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  static bool configured = false;
  if (!configured) {
    e = cudaFuncSetAttribute(logmel_v4_v2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  logmel_v4_v2_kernel<<<grid, NTH, SMEM, st>>>(
      xp, npad, static_cast<const bf16*>(basis), band, wts, nw, out, T, tpc,
      ntiles);
  return (int)cudaGetLastError();
}
