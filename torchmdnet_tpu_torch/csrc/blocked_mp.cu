// Cell-blocked TensorNet message passing for Hopper (sm_90a), fp32 FMA
// throughout (no TF32, parity with "highest").
//
// Replaces four Pallas TPU kernels of torchmdnet_tpu/ops/pallas_blocked_mp.py,
// each with its ungrouped and its grouped (column-partitioned) body:
//   row 8   _mp_kernel (:187) / _mp_kernel_grouped (:224), pallas_call :371
//     out[n, d·F + c] = Σ_k attr[n, k, w(d)·F + c] · feats9[idx[n, k], d·F + c]
//   row 9   _dattr_kernel (:381) / _dattr_kernel_grouped (:435), :556
//     dattr[n, k, w·F + c] = Σ_{d∈w} g9[n, d·F + c] · feats9[idx[n, k], d·F + c]
//   row 10  _mp_kernel_cheb (:687) / _mp_kernel_grouped_cheb (:723), :979
//     row 8 with attr[n, k, :] = fm[n, k] · Σ_t cos(t·θ[n, k]) · coeffs[t, :]
//   row 11  _dd_kernel_cheb (:783) / _dd_kernel_grouped_cheb (:843), :1044
//     dd[n, k] = fm[n, k] · Σ_c dattr[n, k, c] · (Σ_t dser[t, c]·cos(t·θ[n, k]))
// over the sorted-space neighbor matrix idx [N, K] (N cell-blocked rows),
// with w(0) = 0 (irrep I), w(1..3) = 1 (A), w(4..8) = 2 (S), and θ =
// acos(clip(2(d − lo)/(hi − lo) − 1, −1, 1)) computed here.  The TPU kernels
// gather a window of feature rows by one-hot MXU products on hi/lo bf16
// planes, broadcast the row cotangent over its slots by 0/1 matmuls, take θ
// from outside (Mosaic has no acos) and lay the grouped edges out column-
// major: all Mosaic workarounds.  Here a kernel reads feats9[idx] directly;
// the grouped and ungrouped layouts differ only in which slots of a row are
// valid, so one kernel serves both: it compacts the valid slots of its rows
// (mask, or fm ≠ 0 for the series rows) and skips the rest, so the empty
// group slots of a K′ layout cost their mask read.
//
// Bounds on this card (the dhfr blocked path: N = 3,136 sorted rows, F = 128,
// T = 128, ~97 k live slots of K′ = 224 grouped or K = 64 brute slots a row;
// H100 SXM data sheet at 700 W: 67 TFLOP/s fp32, 3.35 TB/s):
// - row 8 moves the live slots' attr rows (~150 MB), the [N, 9F] features and
//   output (14.5 MB each) and the list: bytes, ~0.06 ms;
// - row 9 writes the whole [N, K, 3F] dattr, exact zeros on invalid slots
//   (1.08 GB at K′ = 224, 308 MB at K = 64): bytes, ~0.32 / 0.09 ms;
// - rows 10 and 11 are the [live, T]·[T, 3F] series product, 9.6 GFLOP:
//   operations, ~0.14 ms.  The features (14.5 MB) sit in the 50 MB L2, and
//   the sort keeps a row's neighbors inside 9 stencil columns, so the
//   gathers are L2 hits.
//
// Design against them:
// - blocked_sum_kernel (rows 8 and 10): a block owns kRows = 4 sorted rows
//   (784 blocks at N = 3,136, several per SM), compacts their live slots in slot
//   order and walks them in tiles of 64.  Per tile and per 128-column pass
//   of attr it stages the attr columns in shared memory — loaded (row 8) or
//   formed by the tile product of csrc/cheb_tile.cuh, the kernel-5 basis
//   and product (row 10) — and each thread then owns fixed (row, irrep,
//   channel) outputs of the block and adds Σ over the tile's slots of that
//   row of attr·feats9[j], in slot order, into a shared-memory row
//   accumulator: no atomics, and the [N, K, 3F] attr of row 10 never
//   reaches memory.  A column block w of attr feeds its 1, 3 or 5 irreps
//   from the staged tile, so the series is formed once per slot (kept in
//   shared memory, not recomputed per irrep).
// - blocked_dattr_kernel (row 9): elementwise over (slot, 4 channels) with
//   float4 loads and stores, the row's g9 and the neighbor's features gathered
//   per slot, so the store stream is the whole cost.
// - blocked_dd_kernel (row 11): kernel 7's design (csrc/cheb_filter.cu) on a
//   span of slots (256·s, s chosen so that enough blocks are in flight): live-slot
//   compaction, the basis and the tile product with the derivative series,
//   the cotangent of each (slot, column) folded from g9 and feats9 as it is
//   used, and a fixed-order shuffle reduction per slot: the [N, K, 3F]
//   dattr is never stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cheb_tile.cuh"

namespace {

constexpr int kRows = 4;  // sorted rows a sum-kernel block owns
constexpr int kLdA = kTileN + kPad;  // row stride of the staged attr tile

// First irrep of attr column block w: I = 0, A = 1..3, S = 4..8.
__device__ __forceinline__ int first_irrep(int w) { return w == 0 ? 0 : (w == 1 ? 1 : 4); }

// Writes to sLive the offsets o in [0, len) with flag[s0 + o] ≠ 0, in slot
// order; returns their count.  Every thread calls it.
template <typename FlagT>
__device__ int compact(const FlagT* __restrict__ flag, long long s0, int len,
                       int* sLive, int* sCount) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int total = 0;
  for (int b = 0; b < len; b += kThreads) {
    const bool live = b + tid < len && flag[s0 + b + tid] != 0;
    const unsigned lb = __ballot_sync(0xffffffffu, live);
    if (lane == 0) sCount[warp] = __popc(lb);
    __syncthreads();
    int before = 0, count = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += sCount[w];
      count += sCount[w];
    }
    if (live) sLive[total + before + __popc(lb & ((1u << lane) - 1u))] = b + tid;
    total += count;
    __syncthreads();  // sCount is rewritten by the next chunk
  }
  return total;
}

// CHEB = false: row 8 (attr [N, K, 3F] read; live = mask).
// CHEB = true:  row 10 (attr from the series coeffs [T, 3F]; live = fm ≠ 0).
template <bool CHEB>
__global__ void __launch_bounds__(kThreads)
blocked_sum_kernel(const long long* __restrict__ idx,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ attr, const float* __restrict__ d,
                   const float* __restrict__ fm,
                   const float* __restrict__ coeffs,
                   const float* __restrict__ feats, float* __restrict__ out,
                   int N, int K, int F, int T, float lo, float hi) {
  extern __shared__ __align__(16) float smem[];
  const int C3 = 3 * F, C9 = 9 * F;
  const int ldb = T + kPad;
  float* sB = smem;                                 // [64][T + pad] cos(t·θ)
  float* sW = sB + (CHEB ? kTileM * ldb : 0);       // [32][128] series tile
  float* sA = sW + (CHEB ? kTileK * kTileN : 0);    // [64][128 + pad] attr
  float* sAcc = sA + kTileM * kLdA;                 // [kRows][9F] outputs
  float* sTheta = sAcc + kRows * C9;                // [64]
  float* sFm = sTheta + kTileM;                     // [64]
  int* sJ = reinterpret_cast<int*>(sFm + kTileM);   // [64] neighbor rows
  int* sCount = sJ + kTileM;                        // [kWarps]
  int* sStart = sCount + kWarps;                    // [kRows + 1]
  int* sLive = sStart + kRows + 1;                  // [kRows·K]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, N - r0);
  const long long s0 = (long long)r0 * K;
  for (int v = tid; v < kRows * C9; v += kThreads) sAcc[v] = 0.0f;
  const int nlive = CHEB ? compact(fm, s0, nr * K, sLive, sCount)
                         : compact(mask, s0, nr * K, sLive, sCount);
  // sStart[r]: first compacted slot of the block's row r (slot order)
  if (tid <= kRows) {
    int a = 0, b = nlive;
    while (a < b) {
      const int m = (a + b) / 2;
      if (sLive[m] < tid * K) a = m + 1; else b = m;
    }
    sStart[tid] = a;
  }

  for (int t0 = 0; t0 < nlive; t0 += kTileM) {
    const int nt = min(kTileM, nlive - t0);
    __syncthreads();  // the previous tile is consumed, sStart is written
    if (tid < kTileM) {
      float th = 0.0f, f = 0.0f;
      int j = 0;
      if (tid < nt) {
        const long long e = s0 + sLive[t0 + tid];
        j = (int)idx[e];
        if (CHEB) {
          th = cheb_theta(d[e], lo, hi);
          f = fm[e];
        }
      }
      sJ[tid] = j;
      sTheta[tid] = th;
      sFm[tid] = f;
    }
    __syncthreads();
    if (CHEB) fill_basis(sB, ldb, sTheta, T);

    for (int c0 = 0; c0 < C3; c0 += kTileN) {
      if (CHEB) {
        float acc[4][8];
        tile_product(sB, ldb, coeffs, T, C3, c0, sW, acc);  // syncs first
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            sA[r * kLdA + tx + 16 * j] = acc[i][j] * sFm[r];
        }
      } else {
        __syncthreads();  // the previous pass's sA is consumed
        for (int v = tid; v < kTileM * (kTileN / 4); v += kThreads) {
          const int s = v / (kTileN / 4), col = (v % (kTileN / 4)) * 4;
          float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (s < nt && c0 + col < C3)
            a = *reinterpret_cast<const float4*>(
                attr + (s0 + sLive[t0 + s]) * C3 + c0 + col);
          *reinterpret_cast<float4*>(sA + s * kLdA + col) = a;
        }
      }
      __syncthreads();
      // outputs (irrep i of the column's block, row r, column cl): a warp
      // shares (i, r) and walks 32 neighbouring channels
      for (int v = tid; v < 5 * kRows * kTileN; v += kThreads) {
        const int cl = v % kTileN, r = (v / kTileN) % kRows,
                  i = v / (kTileN * kRows);
        const int col = c0 + cl;
        if (col >= C3 || r >= nr) continue;
        const int w = col / F, c = col - w * F;
        if (i > 2 * w) continue;
        const int a = max(sStart[r], t0) - t0;
        const int b = min(sStart[r + 1], t0 + nt) - t0;
        if (a >= b) continue;
        const int dcol = (first_irrep(w) + i) * F + c;
        float acc = 0.0f;
        for (int s = a; s < b; ++s)
          acc = fmaf(sA[s * kLdA + cl], feats[(long long)sJ[s] * C9 + dcol], acc);
        sAcc[r * C9 + dcol] += acc;
      }
    }
  }
  __syncthreads();
  for (int v = tid; v < nr * C9; v += kThreads)
    out[(long long)r0 * C9 + v] = sAcc[v];
}

// Row 9: one thread per (slot, 4 channels) of the [E, 3F] output.
__global__ void __launch_bounds__(kThreads)
blocked_dattr_kernel(const long long* __restrict__ idx,
                     const unsigned char* __restrict__ mask,
                     const float* __restrict__ g9,
                     const float* __restrict__ feats, float* __restrict__ out,
                     long long E, int K, int F) {
  const int C3 = 3 * F, C9 = 9 * F, q = C3 / 4;
  const long long total = E * q;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < total;
       v += (long long)gridDim.x * kThreads) {
    const long long e = v / q;
    const int col = (int)(v - e * q) * 4;
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (mask[e]) {
      const int w = col / F, c = col - w * F;
      const float* g = g9 + (e / K) * C9 + c;
      const float* x = feats + idx[e] * C9 + c;
      for (int dd = first_irrep(w); dd <= first_irrep(w) + 2 * w; ++dd) {
        const float4 a = *reinterpret_cast<const float4*>(g + dd * F);
        const float4 b = *reinterpret_cast<const float4*>(x + dd * F);
        o.x = fmaf(a.x, b.x, o.x);
        o.y = fmaf(a.y, b.y, o.y);
        o.z = fmaf(a.z, b.z, o.z);
        o.w = fmaf(a.w, b.w, o.w);
      }
    }
    *reinterpret_cast<float4*>(out + e * C3 + col) = o;
  }
}

// Row 11: a block owns `span` slots of the flat [E] slot axis.
__global__ void __launch_bounds__(kThreads)
blocked_dd_kernel(const long long* __restrict__ idx,
                  const float* __restrict__ d, const float* __restrict__ fm,
                  const float* __restrict__ dser, const float* __restrict__ g9,
                  const float* __restrict__ feats, float* __restrict__ out,
                  long long E, int K, int F, int T, float lo, float hi,
                  int span) {
  extern __shared__ __align__(16) float smem[];
  const int C3 = 3 * F, C9 = 9 * F;
  const int ldb = T + kPad;
  float* sB = smem;                                  // [64][T + pad]
  float* sW = sB + kTileM * ldb;                     // [32][128]
  float* sTheta = sW + kTileK * kTileN;              // [64]
  float* sFm = sTheta + kTileM;                      // [64]
  long long* sJ = reinterpret_cast<long long*>(sFm + kTileM);  // [64]
  long long* sRow = sJ + kTileM;                     // [64]
  int* sCount = reinterpret_cast<int*>(sRow + kTileM);  // [kWarps]
  int* sLive = sCount + kWarps;                      // [span]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long s0 = (long long)blockIdx.x * span;
  const int len = (int)min((long long)span, E - s0);
  for (int o = tid; o < len; o += kThreads)  // slots with fm = 0: exact zeros
    if (fm[s0 + o] == 0.0f) out[s0 + o] = 0.0f;
  const int nlive = compact(fm, s0, len, sLive, sCount);

  for (int t0 = 0; t0 < nlive; t0 += kTileM) {
    __syncthreads();  // the previous tile's θ, rows and basis are consumed
    if (tid < kTileM) {
      float th = 0.0f, f = 0.0f;
      long long j = 0, row = 0;
      if (t0 + tid < nlive) {
        const long long e = s0 + sLive[t0 + tid];
        th = cheb_theta(d[e], lo, hi);
        f = fm[e];
        j = idx[e];
        row = e / K;
      }
      sTheta[tid] = th;
      sFm[tid] = f;
      sJ[tid] = j * C9;
      sRow[tid] = row * C9;
    }
    __syncthreads();
    fill_basis(sB, ldb, sTheta, T);

    float acc[4][8];
    float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c0 = 0; c0 < C3; c0 += kTileN) {
      tile_product(sB, ldb, dser, T, C3, c0, sW, acc);  // syncs first
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (t0 + r >= nlive) continue;
        const float* g = g9 + sRow[r];
        const float* x = feats + sJ[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + tx + 16 * j;
          if (col >= C3) continue;
          const int w = col / F, c = col - w * F;
          float ct = 0.0f;  // dattr[slot, col], the row 9 fold
          for (int dd = first_irrep(w); dd <= first_irrep(w) + 2 * w; ++dd)
            ct = fmaf(g[dd * F + c], x[dd * F + c], ct);
          dot[i] = fmaf(acc[i][j], ct, dot[i]);
        }
      }
    }
    // a slot's 16 column threads share a half warp: butterfly sum
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = dot[i];
#pragma unroll
      for (int m = 8; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
      const int r = ty * 4 + i;
      if (tx == 0 && t0 + r < nlive) out[s0 + sLive[t0 + r]] = v * sFm[r];
    }
  }
}

// Dynamic shared memory of a launch (ops/blocked_mp.py checks the same sums).
size_t sum_smem(bool cheb, int k, int f, int t) {
  return sizeof(float) * ((cheb ? (size_t)kTileM * (t + kPad) + kTileK * kTileN : 0) +
                          (size_t)kTileM * kLdA + (size_t)kRows * 9 * f + 2 * kTileM) +
         sizeof(int) * ((size_t)kTileM + kWarps + kRows + 1 + (size_t)kRows * k);
}

size_t dd_smem(int t, int span) {
  return sizeof(float) * ((size_t)kTileM * (t + kPad) + kTileK * kTileN + 2 * kTileM) +
         sizeof(long long) * 2 * kTileM + sizeof(int) * ((size_t)kWarps + span);
}

template <bool CHEB>
int launch_sum(const long long* idx, const unsigned char* mask, const float* attr,
               const float* d, const float* fm, const float* coeffs,
               const float* feats, float* out, int n, int k, int f, int t,
               float lo, float hi, void* stream) {
  const size_t smem = sum_smem(CHEB, k, f, t);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_sum_kernel<CHEB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kRows - 1) / kRows;
  if (blocks == 0) return cudaSuccess;
  blocked_sum_kernel<CHEB><<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, mask, attr, d, fm, coeffs, feats, out, n, k, f, t, lo, hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Row 8.  idx [n, k] int64; mask [n, k] bool; attr [n, k, 3f]; feats, out
// [n, 9f].  f a multiple of 4.
int tmd_blocked_sum(const long long* idx, const unsigned char* mask,
                    const float* attr, const float* feats, float* out, int n,
                    int k, int f, void* stream) {
  return launch_sum<false>(idx, mask, attr, nullptr, nullptr, nullptr, feats,
                           out, n, k, f, 0, 0.0f, 1.0f, stream);
}

// Row 10.  idx [n, k] int64; d, fm [n, k]; coeffs [t, 3f]; feats, out [n, 9f].
int tmd_blocked_sum_cheb(const long long* idx, const float* d, const float* fm,
                         const float* coeffs, const float* feats, float* out,
                         int n, int k, int f, int t, float lo, float hi,
                         void* stream) {
  return launch_sum<true>(idx, nullptr, nullptr, d, fm, coeffs, feats, out, n,
                          k, f, t, lo, hi, stream);
}

// Row 9.  idx, mask [n, k]; g9, feats [n, 9f]; out [n, k, 3f].
int tmd_blocked_dattr(const long long* idx, const unsigned char* mask,
                      const float* g9, const float* feats, float* out, int n,
                      int k, int f, void* stream) {
  const long long e = (long long)n * k, work = e * (3 * f / 4);
  if (work == 0) return cudaSuccess;
  const long long blocks = (work + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < (1LL << 20) ? blocks : (1LL << 20));
  blocked_dattr_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, mask, g9, feats, out, e, k, f);
  return cudaGetLastError();
}

// Row 11.  idx [n, k] int64; d, fm [n, k]; dser [t, 3f]; g9, feats [n, 9f];
// out [n, k].  span a multiple of 256.
int tmd_blocked_dd_cheb(const long long* idx, const float* d, const float* fm,
                        const float* dser, const float* g9, const float* feats,
                        float* out, int n, int k, int f, int t, float lo,
                        float hi, int span, void* stream) {
  const size_t smem = dd_smem(t, span);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_dd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long e = (long long)n * k;
  const long long blocks = (e + span - 1) / span;
  if (blocks == 0) return cudaSuccess;
  blocked_dd_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, d, fm, dser, g9, feats, out, e, k, f, t, lo, hi, span);
  return cudaGetLastError();
}

}  // extern "C"
