// Chebyshev-tabulated edge filters for Hopper (sm_90a), float32-accurate:
// kernels 5 and 7 form their series product on the tensor cores in 3xTF32
// (csrc/tc_tile.cuh; never single-pass TF32), row 6 in fp32 FMA.
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
// 16,750 of the 66,560 slots with fm ≠ 0): 2·live·T·C = 1.65 GFLOP,
// 0.025 ms at 67 TFLOP/s fp32, against reading d, fm and the live rows of
// ct (26 MB, 0.008 ms): operations bound it.  The TPU kernel
// runs its grid in order, adding every tile into one resident [T, C]
// output; here blocks run in parallel, so each block owns a 128 × 128
// output tile and a fixed chunk of slot spans, compacts the chunk's live
// slots in slot order, and for each tile of 64 of them puts the weighted
// basis fm·cos(j·θ) [64 × 128] and the ct rows [64 × 128] in shared memory
// and adds their transposed product into an 8 × 8 register tile per
// thread.  The per-chunk partials go to scratch and a second kernel sums
// them in chunk order: deterministic, no atomics.

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

// Row 6.  Block (x, y, z) owns output columns [128x, 128x + 128), series
// rows [128y, 128y + 128) and the slot spans [z·per, (z + 1)·per); thread
// (ty, tx) of 16 × 16 owns rows 128y + ty + 16i and columns 128x + tx + 16j
// (i, j < 8).  partial[z] gets the chunk's sum.
__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ d, const float* __restrict__ fm,
               const float* __restrict__ ct, float* __restrict__ partial,
               long long E, int T, int C, int per, float lo, float hi) {
  extern __shared__ __align__(16) float smem[];
  constexpr int ldb = kTileN + kPad;
  float* sB = smem;                        // [64][128 + pad] fm·cos(j·θ)
  float* sC = sB + kTileM * ldb;           // [64][128]       ct rows
  float* sTheta = sC + kTileM * kTileN;    // [64]
  float* sFm = sTheta + kTileM;            // [64]
  int* sList = reinterpret_cast<int*>(sFm + kTileM);  // [per·kSpan]
  int* sLive = sList + per * kSpan;                    // [kSpan]
  int* sDead = sLive + kSpan;                          // [kSpan]
  int* sCount = sDead + kSpan;                         // [2 * kWarps]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int c0 = blockIdx.x * kTileN, t0 = blockIdx.y * kTileN;
  const long long base = (long long)blockIdx.z * per * kSpan;

  // the chunk's live slots, in slot order, as offsets from base
  int total = 0;
  for (int s = 0; s < per && base + (long long)s * kSpan < E; ++s) {
    int ndead;
    const int nlive = compact_span(fm, base + (long long)s * kSpan, E, sLive,
                                   sDead, sCount, &ndead);
    for (int i = tid; i < nlive; i += kThreads)
      sList[total + i] = s * kSpan + sLive[i];
    total += nlive;
    __syncthreads();  // sLive is rewritten by the next span
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int q0 = 0; q0 < total; q0 += kTileM) {
    const int rows = min(kTileM, total - q0);
    __syncthreads();  // the previous tile's operands are consumed
    if (tid < kTileM) {
      float th = 0.0f, f = 0.0f;
      if (tid < rows) {
        const long long e = base + sList[q0 + tid];
        th = cheb_theta(d[e], lo, hi);
        f = fm[e];
      }
      sTheta[tid] = th;
      sFm[tid] = f;
    }
    __syncthreads();
    // cosf with full range reduction: j·θ reaches (T − 1)π
    for (int v = tid; v < kTileM * kTileN; v += kThreads) {
      const int r = v / kTileN, jj = v % kTileN;
      const int j = t0 + jj;
      sB[r * ldb + jj] = j < T ? sFm[r] * cosf((float)j * sTheta[r]) : 0.0f;
    }
    for (int v = tid; v < kTileM * (kTileN / 4); v += kThreads) {
      const int r = v / (kTileN / 4), col = (v % (kTileN / 4)) * 4;
      float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < rows && c0 + col < C) {
        const long long e = base + sList[q0 + r];
        w = *reinterpret_cast<const float4*>(ct + e * C + c0 + col);
      }
      *reinterpret_cast<float4*>(sC + r * kTileN + col) = w;
    }
    __syncthreads();
    for (int s = 0; s < rows; ++s) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sB[s * ldb + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sC[s * kTileN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  float* out = partial + (long long)blockIdx.z * T * C;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = t0 + ty + 16 * i;
    if (j >= T) continue;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = c0 + tx + 16 * jj;
      if (col < C) out[(long long)j * C + col] = acc[i][jj];
    }
  }
}

// out[i] = Σ_z partial[z][i] in chunk order.
__global__ void project_sum_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, long long n,
                                   int chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int z = 0; z < chunks; ++z) acc += partial[(long long)z * n + i];
  out[i] = acc;
}

int launch_project(const float* d, const float* fm, const float* ct,
                   float* partial, float* out, long long e, int t, int c,
                   int per, float lo, float hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)t * c;
  const long long chunks = (e + (long long)per * kSpan - 1) / ((long long)per * kSpan);
  if (chunks == 0) {
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * n, s);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  const size_t smem =
      sizeof(float) * ((size_t)kTileM * (kTileN + kPad) + (size_t)kTileM * kTileN +
                       2 * kTileM) +
      sizeof(int) * ((size_t)per * kSpan + 2 * kSpan + 2 * kWarps);
  cudaError_t err = cudaFuncSetAttribute(
      project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + kTileN - 1) / kTileN, (t + kTileN - 1) / kTileN,
                  (unsigned)chunks);
  project_kernel<<<grid, kThreads, smem, s>>>(d, fm, ct, partial, e, t, c, per,
                                              lo, hi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  project_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      partial, out, n, (int)chunks);
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

// Row 6.  d, fm [e]; ct [e, c]; partial [ceil(e / (256·per)), t, c]
// scratch; out [t, c].  c a multiple of 4; per ≥ 1 spans of 256 slots per
// chunk.
int tmd_cheb_project(const float* d, const float* fm, const float* ct,
                     float* partial, float* out, long long e, int t, int c,
                     int per, float lo, float hi, void* stream) {
  return launch_project(d, fm, ct, partial, out, e, t, c, per, lo, hi, stream);
}

// Floats of the image scratch kernels 5 and 7 take at (t, c).
int tmd_tc_image_floats(int t, int c) { return tc_image_floats(t, c); }

// What the compiler and the launch give kernels 5 (which = 5) and 7 (7):
// out = registers a thread, local (spill) bytes a thread, static and
// dynamic shared memory bytes a block, resident blocks an SM.
int tmd_cheb_attributes(int which, int* out) {
  const void* kern = which == 5 ? (const void*)cheb_tc_kernel<false>
                                : (const void*)cheb_tc_kernel<true>;
  const size_t smem = tc_smem(which != 5);
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
