// Chebyshev-tabulated edge filters for Hopper (sm_90a), float32-accurate:
// kernels 5 and 7 and row 6 form their products on the tensor cores in
// 3xTF32 (csrc/tc_tile.cuh; never single-pass TF32).
//
// Replaces three Pallas TPU kernels of torchmdnet_tpu/ops/pallas_cheb.py:
//   kernel 5  _filter_kernel     (:86, pallas_call :146, cheb_filter :197)
//     out[e, c] = fm[e] · Σ_j coeffs[j, c]·cos(j·θ_e)                → [E, C]
//   kernel 7  _filter_dot_kernel (:95, pallas_call :239, cheb_filter_dot :265)
//     out[e]    = fm[e] · Σ_c (Σ_j dser[j, c]·cos(j·θ_e))·ct[e, c]     → [E]
//   row 6     _project_kernel    (:105, pallas_call :175, cheb_project :298)
//     out[j, c] = Σ_e fm[e]·cos(j·θ_e)·ct[e, c]                        → [T, C]
//     (the adjoint of kernel 5 in its coefficients; the TPU kernel takes
//     the product ctw = fm·ct, the weight is folded in here)
// with θ_e = acos(clip(2(d[e] − lo)/(hi − lo) − 1, −1, 1)) over E = N·K edge
// slots, T series terms and C channels.  The TPU computes θ outside its
// kernels (Mosaic has no acos); here each slot's θ is computed in-kernel.
//
// Bounds (dhfr: N = 2,560 rows, K = 64, T = 128, C = 384, 97,319 slots
// with fm ≠ 0; H100 SXM data sheet at 700 W: 495 TFLOP/s TF32 on the
// tensor cores, 3.35 TB/s): the product is 2·97.3k·T·C ≈ 9.6 GFLOP, three
// TF32 products in 3xTF32, ~0.058 ms.  Kernel 5 writes its whole [E, C]
// output, zeros included (252 MB, ~0.076 ms): bytes bound it.  Kernel 7
// reads ct on the live slots only (150 MB, ~0.045 ms): operations bound it.
//
// Design against them (cheb_tc_kernel<DOT>): a block owns a span of 256
// slots (~152 live at dhfr), compacts those with fm ≠ 0 in slot order
// and writes exact zeros for the others: kernel 5 whole [C] rows with
// float4 stores, kernel 7 one float.  Per tile of 64 live slots and
// 128-column pass, tc_product forms basis · series on wgmma: each thread
// computes its fragment of the basis from the slots' θ (cos by a two-part
// 2π reduction, then __cosf, of the fp32 argument j·θ the plain version
// takes), and the series, split once per launch into hi/lo TF32 planes,
// streams through a three-stage cp.async ring.  After each pass the ring
// is free and holds the epilogue's [64][kTcLdW] tile.  Kernel 5 puts
// fm·acc there and stores each live slot's 128 columns with coalesced
// float4 stores.  Kernel 7 copies the tile's ct rows there (cp.async, live
// slots only), folds ct ⊙ acc into two sums a thread, and after the last
// pass adds them over the quad that shares a slot (shuffles), then over
// the two warpgroups in order, times fm: the [E, C] filter derivative is
// never stored, and there are no atomics.  The output is the filter
// itself, whose terms cancel to a small result, so the product sums each
// stage apart and adds it in fp32 (tc_product<true>): ~1e-6 of max, not
// the ~2e-6 that 48 tensor-core accumulations a pass leave.  That costs
// 32 registers (~115), so two blocks share an SM (~55 KB of shared memory
// each), whose products, stores and serial phases overlap.  Longer spans
// leave fewer 64-slot tiles part full, but ran no faster on an H100, down
// to one wave of blocks.
//
// Row 6 (the coefficient gradient; training only).  Bound at the training
// batch of bench.py::bench_train (1,664 rows × K = 40, T = 128, C = 384,
// 16,750 of the 66,560 slots with fm ≠ 0): 2·live·T·C = 1.65 GFLOP, three
// TF32 products in 3xTF32, ~0.010 ms, against reading d, fm and the live
// rows of ct (26 MB, ~0.008 ms).  The TPU kernel runs its grid in order,
// adding every tile into one resident [T, C] output; here blocks run in
// parallel, so each block (project_tc_kernel) owns a 64 × 128 output tile
// and a chunk of slot spans, about two blocks an SM in all (the most that
// fit; the second hides the first's barrier and shared-memory latencies).  The slots are
// the product's reduction dimension: a block compacts its chunk's fm ≠ 0
// slots in slot order, and for every 16 of them stages their ct columns as
// the B operand, split into hi/lo planes in the layout of a split series
// (cp.async brings the rows three stages ahead; the threads transpose and
// split them with conflict-free 16-byte stores), and builds the basis as
// the A fragment in registers (fm·cos(j·θ), cos by tc_cos), as rows 5 and
// 7 do; each stage's wgmma run while the next is staged.  The per-chunk
// partials (chunks × T × C floats: 8.6 MB at the training shape, which
// sits in L2; the kernel it replaces wrote 17 MB) are summed by a second
// launch in chunk order, a thread four outputs: deterministic, no atomics.
// One chunk writes the output directly.  Folding in the last block of
// each tile would read the tile's 44 partials with one SM; the second
// launch reads them with all of them.
// Error: θ is the plain version's fp32 θ on the card, bit for bit
// (tc_tile.cuh::cheb_x; a θ an ulp off moved cos(j·θ) ~j-fold, ~1.7e-5
// of max |out| at T = 128); the product's own error in 3xTF32 is ~1e-6.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cheb_tile.cuh"
#include "tc_tile.cuh"

namespace {

constexpr int kSpan = kThreads;  // slots of a kernel 5 / 7 block, a row 6 span
static_assert(kThreads == kTcThreads, "one launch width for every kernel");

// Splits the slots [s0, s0 + kSpan) ∩ [0, E) into those with flag ≠ 0
// (sLive) and the rest (sDead), each in slot order, as offsets from s0.
// Returns the live count; *ndead gets the other.  Every thread calls it.
__device__ __forceinline__ int compact_span(const float* __restrict__ flag,
                                            long long s0, long long E,
                                            int* sLive, int* sDead,
                                            int* sCount, int* ndead) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool in = s0 + tid < E;
  const bool live = in && flag[s0 + tid] != 0.0f;
  const unsigned lb = __ballot_sync(0xffffffffu, live);
  const unsigned ib = __ballot_sync(0xffffffffu, in);
  if (lane == 0) {
    sCount[warp] = __popc(lb);
    sCount[kWarps + warp] = __popc(ib);
  }
  __syncthreads();
  int live_before = 0, in_before = 0, nlive = 0, nin = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      live_before += sCount[w];
      in_before += sCount[kWarps + w];
    }
    nlive += sCount[w];
    nin += sCount[kWarps + w];
  }
  const unsigned below = (1u << lane) - 1u;
  const int lrank = live_before + __popc(lb & below);
  const int irank = in_before + __popc(ib & below);
  if (live)
    sLive[lrank] = tid;
  else if (in)
    sDead[irank - lrank] = tid;
  __syncthreads();
  *ndead = nin - nlive;
  return nlive;
}

// DOT = false: kernel 5 (image of coeffs, out [E, C]);
// DOT = true:  kernel 7 (image of dser, ct [E, C], out [E]).
// Block b owns the slots [b·kSpan, b·kSpan + kSpan) below E.
template <bool DOT>
__global__ void __launch_bounds__(kTcThreads, 2)
cheb_tc_kernel(const float* __restrict__ d, const float* __restrict__ fm,
               const float* __restrict__ image, const float* __restrict__ ct,
               float* __restrict__ out, long long E, int T, int C, float lo,
               float hi) {
  extern __shared__ __align__(16) float smem[];
  float* sW = smem + tc_region_offset(smem);  // the ring, then the tile
  float* sTheta = sW + kTcRegion;             // [64]
  float* sFm = sTheta + kTcM;                 // [64]
  float* sRed = sFm + kTcM;                   // [2][64] (DOT)
  int* sLive = reinterpret_cast<int*>(sRed + (DOT ? 2 * kTcM : 0));  // [kSpan]
  int* sDead = sLive + kSpan;                 // [kSpan]
  int* sCount = sDead + kSpan;                // [2 * kWarps]

  const int tid = threadIdx.x, lane = tid & 31;
  const long long s0 = (long long)blockIdx.x * kSpan;
  int ndead;
  const int nlive = compact_span(fm, s0, E, sLive, sDead, sCount, &ndead);

  // slots with fm = 0: exact zeros, no arithmetic
  if (DOT) {
    if (tid < ndead) out[s0 + sDead[tid]] = 0.0f;
  } else {
    const int c4 = C / 4;
    for (int v = tid; v < ndead * c4; v += kTcThreads)
      reinterpret_cast<float4*>(out + (s0 + sDead[v / c4]) * C)[v % c4] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // thread t < 64 reads slot t of a tile one tile ahead of its use
  float pd = 0.0f, pf = 0.0f;
  if (tid < min(kTcM, nlive)) {
    pd = d[s0 + sLive[tid]];
    pf = fm[s0 + sLive[tid]];
  }
  for (int t0 = 0; t0 < nlive; t0 += kTcM) {
    const int nt = min(kTcM, nlive - t0);
    __syncthreads();  // the previous tile's fm, tile and sums are consumed
    if (tid < kTcM) {
      sTheta[tid] = tid < nt ? cheb_theta(pd, lo, hi) : 0.0f;
      sFm[tid] = tid < nt ? pf : 0.0f;
      if (t0 + kTcM + tid < nlive) {
        const long long e = s0 + sLive[t0 + kTcM + tid];
        pd = d[e];
        pf = fm[e];
      }
    }
    float part[2] = {0.0f, 0.0f};
    for (int c0 = 0; c0 < C; c0 += kTcN) {
      float acc[8][4];
      tc_product<true>(sTheta, image, T, c0 / kTcN, sW, acc);  // syncs first, last
      if (!DOT) {
        // out tile [64][kTcLdW] over the free ring: fm · acc
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = tc_row(h);
          if (r >= nt) continue;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            *reinterpret_cast<float2*>(sW + r * kTcLdW + tc_col(i)) =
                make_float2(acc[i][2 * h] * sFm[r], acc[i][2 * h + 1] * sFm[r]);
        }
        __syncthreads();
        // a warp stores one slot's 128 columns: 512 contiguous bytes
        for (int v = tid; v < nt * (kTcN / 4); v += kTcThreads) {
          const int r = v / (kTcN / 4), q = v % (kTcN / 4);
          const int col = c0 + 4 * q;
          if (col < C)
            *reinterpret_cast<float4*>(out + (s0 + sLive[t0 + r]) * C + col) =
                *reinterpret_cast<const float4*>(sW + r * kTcLdW + 4 * q);
        }
      } else {
        // ct tile [64][kTcLdW] over the free ring, the live rows only
        for (int v = tid; v < nt * (kTcN / 4); v += kTcThreads) {
          const int r = v / (kTcN / 4), q = v % (kTcN / 4);
          const int col = c0 + 4 * q;
          if (col < C)
            cp_async16(sW + r * kTcLdW + 4 * q,
                       ct + (s0 + sLive[t0 + r]) * C + col);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = tc_row(h);
          if (r >= nt) continue;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (c0 + tc_col(i) >= C) continue;  // C is a multiple of 4
            const float2 w =
                *reinterpret_cast<const float2*>(sW + r * kTcLdW + tc_col(i));
            part[h] = fmaf(acc[i][2 * h], w.x, part[h]);
            part[h] = fmaf(acc[i][2 * h + 1], w.y, part[h]);
          }
        }
      }
    }
    if (DOT) {
      // the quad (lanes 4g..4g+3) shares a slot: butterfly, then one lane
      // a slot writes its warpgroup's sum
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = part[h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((lane & 3) == 0) sRed[(tid >> 7) * kTcM + tc_row(h)] = v;
      }
      __syncthreads();
      if (tid < nt)
        out[s0 + sLive[t0 + tid]] = (sRed[tid] + sRed[kTcM + tid]) * sFm[tid];
    }
  }
}

// Dynamic shared memory of a kernel 5 (dot = false) or kernel 7 launch
// (ops/cheb_filter.py::tc_smem keeps the same sum): 1 KB to align the
// region, the region, θ and fm, kernel 7's warpgroup sums, the live and
// dead offsets and the warp counts.
size_t tc_smem(bool dot) {
  return 1024 +
         sizeof(float) * (kTcRegion + 2 * kTcM + (dot ? 2 * kTcM : 0)) +
         sizeof(int) * (2 * kSpan + 2 * kWarps);
}

// The series split into image, then the kernel.
template <bool DOT>
int launch(const float* d, const float* fm, const float* ser, const float* ct,
           float* out, float* image, long long e, int t, int c, float lo,
           float hi, void* stream) {
  const size_t smem = tc_smem(DOT);
  cudaError_t err = cudaFuncSetAttribute(
      cheb_tc_kernel<DOT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (e + kSpan - 1) / kSpan;
  if (blocks == 0) return cudaSuccess;
  const int rc = tc_split(ser, t, c, image, stream);
  if (rc != cudaSuccess) return rc;
  cheb_tc_kernel<DOT><<<(unsigned)blocks, kTcThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      d, fm, image, ct, out, e, t, c, lo, hi);
  return cudaGetLastError();
}

// Row 6.  Block (x, y, z) owns the output tile of series rows [64y, 64y +
// 64) and columns [128x, 128x + 128) and chunk z of the ⌈E/256⌉ slot spans
// of 256 slots cut into gridDim.z chunks, [⌊z·S/Z⌋, ⌊(z + 1)·S/Z⌋); partial[z]
// (or out, with one chunk) gets the chunk's sum.  It walks its chunk in
// windows of kProjectSlots: it compacts a window's fm ≠ 0 slots in slot
// order with their θ and fm (each thread loads 12 flags and 12 d, all in
// flight at once), then multiplies kProjectK of them a stage.
// Warpgroup q owns the tile's columns [64q, 64q + 64) and runs apart from
// the other (named barriers): cp.async brings the stage's ct rows into a
// ring of kProjectRaw raw stages, kProjectRaw − 1 stages ahead; the threads
// split a landed stage into hi/lo planes (K-major, 64-byte swizzle: the
// layout tc_split gives a series, one plane pair per 16 slots) in one of
// two plane buffers, build the A fragment of the basis fm·cos(j·θ) in
// registers (cos by tc_cos) and issue its 6 wgmma per 16 slots; those run
// while the next stage is split and its fragment built.  The sums stay on
// the tensor cores: the error is θ's (above), not theirs.
constexpr int kProjectPer = 12;                          // slots a thread compacts
constexpr int kProjectSlots = kProjectPer * kTcThreads;  // slots a window
constexpr int kProjectK = kTcK;                          // slots a stage
constexpr int kProjectSub = kProjectK / kTcK;            // plane pairs a stage
constexpr int kProjectRaw = 4;                           // raw ct stages a ring
constexpr int kRawStage = kProjectK * kTcN;              // floats of a raw stage
constexpr int kPlaneStage = kProjectSub * kTcStage;      // floats of a plane stage

// cp.async of 16 bytes, or 16 zero bytes where !valid (src is not read).
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src,
                                                 bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void wg_bar() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (int)(threadIdx.x >> 7)) : "memory");
}

__global__ void __launch_bounds__(kTcThreads, 2)
project_tc_kernel(const float* __restrict__ d, const float* __restrict__ fm,
                  const float* __restrict__ ct, float* __restrict__ partial,
                  long long E, int T, int C, float lo, float hi) {
  extern __shared__ __align__(16) float smem[];
  float* sW = smem + tc_region_offset(smem);        // [2] stages of planes
  float* sRaw = sW + 2 * kPlaneStage;               // [kProjectRaw][K][128]
  float* sTheta = sRaw + kProjectRaw * kRawStage;   // [window + 16]
  float* sFm = sTheta + kProjectSlots + kProjectK;  // [window + 16]
  int* sList = reinterpret_cast<int*>(sFm + kProjectSlots + kProjectK);
  int* sWarp = sList + kProjectSlots + kProjectK;   // [kWarps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, tw = tid & 127;
  const int c0 = blockIdx.x * kTcN, j0 = blockIdx.y * kTcM;
  const long long spans = (E + kSpan - 1) / kSpan;
  const long long z0 = blockIdx.z * spans / gridDim.z * kSpan;
  const long long z1 = min(E, (blockIdx.z + 1) * spans / gridDim.z * kSpan);
  // this thread's copies (raw rows cr + 8h, 4 columns), its plane column
  // and slots, its basis rows
  const int cc = tw & 15, cr = tw >> 4;
  const int ccol = c0 + 64 * wg + 4 * cc;
  const int n = tw & 63, kq = tw >> 6;
  const int jr0 = j0 + tc_row(0), jr1 = jr0 + 8, t4 = tid & 3;
  float* const half = sW + wg * 64 * kTcK;  // this warpgroup's columns

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  uint32_t a0[kProjectSub][2][2][4] = {}, a1[kProjectSub][2][2][4] = {};

  for (long long w0 = z0; w0 < z1; w0 += kProjectSlots) {
    // the window's live slots, in slot order, with θ and fm: thread t
    // owns the slots w0 + 12t + [0, 12)
    const long long sb = w0 + kProjectPer * tid;
    const long long wend = min(z1, w0 + kProjectSlots);
    float f[kProjectPer], dv[kProjectPer];
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < kProjectPer; ++i) {
      f[i] = sb + i < wend ? fm[sb + i] : 0.0f;
      dv[i] = sb + i < wend ? d[sb + i] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kProjectPer; ++i) cnt += f[i] != 0.0f ? 1 : 0;
    int incl = cnt;  // inclusive warp scan of the counts
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) sWarp[warp] = incl;
    __syncthreads();
    int pos = incl - cnt, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) pos += sWarp[w];
      total += sWarp[w];
    }
#pragma unroll
    for (int i = 0; i < kProjectPer; ++i) {
      if (f[i] != 0.0f) {
        sList[pos] = kProjectPer * tid + i;
        sTheta[pos] = cheb_theta(dv[i], lo, hi);
        sFm[pos] = f[i];
        ++pos;
      }
    }
    const int nk = (total + kProjectK - 1) / kProjectK;
    if (tid < nk * kProjectK - total) {  // the last stage's pad: no weight
      sTheta[total + tid] = 0.0f;
      sFm[total + tid] = 0.0f;
    }
    __syncthreads();

    // raw stage kt of this warpgroup's columns: ct rows of slots K·kt + r
    auto copy = [&](int kt) {
      float* dst = sRaw + (kt % kProjectRaw) * kRawStage + 64 * wg + 4 * cc;
#pragma unroll
      for (int h = 0; h < kProjectK / 8; ++h) {
        const int k = kt * kProjectK + cr + 8 * h;
        const bool ok = ccol < C && k < total;
        cp_async16_zfill(dst + (cr + 8 * h) * kTcN,
                         ok ? ct + (w0 + sList[k]) * C + ccol : ct, ok);
      }
    };
    // raw stage kt split into plane buffer kt & 1: element (column, slot k)
    // at byte 64·column + 4k of a plane, its 16-byte chunk XORed with bits
    // 7-8; a warp's 16-byte stores hit 32 distinct banks
    auto split = [&](int kt) {
      const float* src = sRaw + (kt % kProjectRaw) * kRawStage + 64 * wg + n;
#pragma unroll
      for (int u = 0; u < kProjectSub; ++u) {
        float* buf = half + (kt & 1) * kPlaneStage + u * kTcStage;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t hi4[4], lo4[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tf32_split(src[(kTcK * u + 8 * kq + 4 * h + i) * kTcN], hi4[i], lo4[i]);
          int o = n * 64 + 16 * (2 * kq + h);
          o ^= ((o >> 7) & 3) << 4;
          *reinterpret_cast<uint4*>(buf + o / 4) = make_uint4(hi4[0], hi4[1], hi4[2], hi4[3]);
          *reinterpret_cast<uint4*>(buf + kTcPlane + o / 4) =
              make_uint4(lo4[0], lo4[1], lo4[2], lo4[3]);
        }
      }
    };
    // the basis fragment of stage kt: rows j, slots k = K·kt + 16u + 8s +
    // t4 (+ 4)
    auto basis = [&](int kt, uint32_t(&a)[kProjectSub][2][2][4]) {
#pragma unroll
      for (int u = 0; u < kProjectSub; ++u)
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          const int k = kt * kProjectK + kTcK * u + 8 * s2 + t4;
          const float th0 = sTheta[k], f0 = sFm[k];
          const float th1 = sTheta[k + 4], f1 = sFm[k + 4];
          tf32_split(jr0 < T ? f0 * tc_cos((float)jr0 * th0) : 0.0f, a[u][s2][0][0], a[u][s2][1][0]);
          tf32_split(jr1 < T ? f0 * tc_cos((float)jr1 * th0) : 0.0f, a[u][s2][0][1], a[u][s2][1][1]);
          tf32_split(jr0 < T ? f1 * tc_cos((float)jr0 * th1) : 0.0f, a[u][s2][0][2], a[u][s2][1][2]);
          tf32_split(jr1 < T ? f1 * tc_cos((float)jr1 * th1) : 0.0f, a[u][s2][0][3], a[u][s2][1][3]);
        }
    };
    // one stage: its raw rows landed, kProjectRaw − 1 stages ahead
    // requested, split, fragment, then its wgmma issued behind the stage
    // before's, which is waited for (its fragment prev and planes free
    // again)
    auto stage = [&](int kt, uint32_t(&a)[kProjectSub][2][2][4],
                     uint32_t(&prev)[kProjectSub][2][2][4]) {
      cp_async_wait<kProjectRaw - 2>();
      wg_bar();  // raw stage kt landed; raw kt − 1 and planes kt & 1 free
      if (kt + kProjectRaw - 1 < nk) copy(kt + kProjectRaw - 1);
      cp_async_commit();
      split(kt);
      basis(kt, a);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_bar();  // the warpgroup's planes of stage kt are written
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < kProjectSub; ++u) {
        const float* buf = half + (kt & 1) * kPlaneStage + u * kTcStage;
        const uint64_t dHi = tc_desc(buf), dLo = tc_desc(buf + kTcPlane);
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          wgmma_tf32(acc, a[u][s2][1], dHi + 2 * s2);
          wgmma_tf32(acc, a[u][s2][0], dLo + 2 * s2);
          wgmma_tf32(acc, a[u][s2][0], dHi + 2 * s2);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int u = 0; u < kProjectSub; ++u) tc_hold(prev[u]);
    };
#pragma unroll
    for (int r = 0; r < kProjectRaw - 1; ++r) {
      if (r < nk) copy(r);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; kt += 2) {
      stage(kt, a0, a1);
      if (kt + 1 < nk) stage(kt + 1, a1, a0);
    }
    wgmma_wait<0>();
    tc_hold(acc);
#pragma unroll
    for (int u = 0; u < kProjectSub; ++u) {
      tc_hold(a0[u]);
      tc_hold(a1[u]);
    }
    cp_async_wait<0>();
    __syncthreads();  // the window's arrays, ring and planes are free
  }

  float* out = partial + (long long)blockIdx.z * T * C;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + tc_row(h);
    if (j >= T) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + tc_col(i);
      if (c < C)  // C is a multiple of 4: c + 1 < C too
        *reinterpret_cast<float2*>(out + (long long)j * C + c) =
            make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
    }
  }
}

// out = Σ_z partial[z] in chunk order, four floats a thread, eight
// chunks' loads in flight at a time.
__global__ void project_sum_kernel(const float4* __restrict__ partial,
                                   float4* __restrict__ out, long long n4,
                                   int chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int z0 = 0; z0 < chunks; z0 += 8) {
    float4 p[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      p[u] = z0 + u < chunks ? partial[(long long)(z0 + u) * n4 + i]
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      acc.x += p[u].x; acc.y += p[u].y; acc.z += p[u].z; acc.w += p[u].w;
    }
  }
  out[i] = acc;
}

// Dynamic shared memory of a row 6 launch (ops/cheb_filter.py::
// project_smem keeps the same sum): 1 KB to align the planes, two stages
// of planes, the ring of raw ct stages, a window's θ, fm and slot offsets
// (each with a stage of pad) and the warp counts.
size_t project_smem() {
  return 1024 +
         sizeof(float) * (2 * kPlaneStage + kProjectRaw * kRawStage +
                          2 * (kProjectSlots + kProjectK)) +
         sizeof(int) * (kProjectSlots + kProjectK + kWarps);
}

int launch_project(const float* d, const float* fm, const float* ct,
                   float* partial, float* out, long long e, int t, int c,
                   int chunks, float lo, float hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)t * c;
  if (e == 0 || chunks < 1) {
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * n, s);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  const size_t smem = project_smem();
  cudaError_t err = cudaFuncSetAttribute(
      project_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + kTcN - 1) / kTcN, (t + kTcM - 1) / kTcM, (unsigned)chunks);
  // one chunk: the block's sum is the output
  project_tc_kernel<<<grid, kTcThreads, smem, s>>>(
      d, fm, ct, chunks == 1 ? out : partial, e, t, c, lo, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const long long n4 = n / 4;
  project_sum_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      reinterpret_cast<const float4*>(partial), reinterpret_cast<float4*>(out),
      n4, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel 5.  d, fm [e]; coeffs [t, c]; out [e, c]; image
// [tc_image_floats(t, c)] scratch.  c a multiple of 4.
int tmd_cheb_filter(const float* d, const float* fm, const float* coeffs,
                    float* out, float* image, long long e, int t, int c,
                    float lo, float hi, void* stream) {
  return launch<false>(d, fm, coeffs, nullptr, out, image, e, t, c, lo, hi,
                       stream);
}

// Kernel 7.  d, fm [e]; dser [t, c]; ct [e, c]; out [e]; image as kernel
// 5's.  c a multiple of 4.
int tmd_cheb_filter_dot(const float* d, const float* fm, const float* dser,
                        const float* ct, float* out, float* image, long long e,
                        int t, int c, float lo, float hi, void* stream) {
  return launch<true>(d, fm, dser, ct, out, image, e, t, c, lo, hi, stream);
}

// Row 6.  d, fm [e]; ct [e, c]; partial [chunks, t, c] scratch (unused
// with one chunk); out [t, c].  c a multiple of 4; 1 ≤ chunks ≤ ⌈e/256⌉
// (e = 0 writes zeros).
int tmd_cheb_project(const float* d, const float* fm, const float* ct,
                     float* partial, float* out, long long e, int t, int c,
                     int chunks, float lo, float hi, void* stream) {
  return launch_project(d, fm, ct, partial, out, e, t, c, chunks, lo, hi,
                        stream);
}

// Floats of the image scratch kernels 5 and 7 take at (t, c).
int tmd_tc_image_floats(int t, int c) { return tc_image_floats(t, c); }

// What the compiler and the launch give kernels 5 (which = 5) and 7 (7)
// and row 6 (6): out = registers a thread, local (spill) bytes a thread,
// static and dynamic shared memory bytes a block, resident blocks an SM.
int tmd_cheb_attributes(int which, int* out) {
  const void* kern = which == 5   ? (const void*)cheb_tc_kernel<false>
                     : which == 7 ? (const void*)cheb_tc_kernel<true>
                                  : (const void*)project_tc_kernel;
  const size_t smem = which == 6 ? project_smem() : tc_smem(which != 5);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kTcThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = blocks;
  return cudaSuccess;
}

}  // extern "C"
