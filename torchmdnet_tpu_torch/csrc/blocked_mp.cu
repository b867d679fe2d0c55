// Cell-blocked TensorNet message passing for Hopper (sm_90a), in fp32:
// FMA for rows 8 and 9, 3xTF32 tensor-core products for rows 10 and 11
// (csrc/tc_tile.cuh; never single-pass TF32).
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
// H100 SXM data sheet at 700 W: 67 TFLOP/s fp32, 495 TFLOP/s TF32 on the
// tensor cores, 3.35 TB/s):
// - row 8 moves the live slots' attr rows (~150 MB), the [N, 9F] features and
//   output (14.5 MB each) and the list: bytes, ~0.06 ms;
// - row 9 writes the whole [N, K, 3F] dattr, exact zeros on invalid slots
//   (1.08 GB at K′ = 224, 308 MB at K = 64): bytes, ~0.32 / 0.09 ms;
// - rows 10 and 11 are the [live, T]·[T, 3F] series product, 9.6 GFLOP:
//   operations, ~0.06 ms in 3xTF32 on the tensor cores (three TF32
//   products, 29 GFLOP at 495 TFLOP/s; ~0.14 ms at the fp32 rate).  The
//   features (14.5 MB) sit in the 50 MB L2, and the sort keeps a row's
//   neighbors inside 9 stencil columns, so the gathers are L2 hits.
//
// Design against them:
// - blocked_sum_kernel (row 8): one warp per sorted row and 128-channel
//   group (4 a block: 784 blocks at N = 3,136, F = 128), each lane four
//   channels of all nine irreps, so every thread owns outputs that exist
//   (the staged-tile kernel it replaces gave ~40% of its work items none)
//   and each sums its row's valid slots in slot order into registers, no
//   atomics.  The warp finds the valid slots by a ballot over 32 mask bytes
//   at a time and reads attr and the neighbour's features straight from
//   memory, twelve float4 loads in flight a slot: a slot's three attr
//   quads once (streaming loads, 150 MB of live rows), the neighbour's
//   nine 512-byte feature slices from L2 (the 14.5 MB of features stay
//   there), 448 MB a call at dhfr (97 k valid slots x 4.6 KB).  No shared
//   memory and no barrier: the L2 gathers are what is left.
// - blocked_dattr_kernel (row 9): a warp a (sorted row, 128-channel group,
//   32-slot round), each lane four channels of all nine irreps.  The lane
//   loads its row's nine g9 quads once a round (the kernel it replaces, a
//   thread a slot and 4 channels, read them again for every slot and
//   recomputed the row and the address per thread), stores the round's
//   dead slots' zeros first, then for each valid slot gathers the
//   neighbour's nine feature quads from L2 and stores its three output
//   quads.  Every store is a warp's 512 contiguous bytes, streaming; the
//   output stream (1.08 GB at K′ = 224, 86% of it the zero rows of dead
//   slots) is what bounds it.
// - blocked_sum_cheb_kernel (row 10) and blocked_dd_cheb_kernel (row 11):
//   the series product is the work, so it runs on the tensor cores in
//   3xTF32 (tc_tile.cuh): per tile of 64 live slots each thread computes
//   its fragment of the cos basis [64, T] from the slots' θ and hands it
//   to wgmma from registers as A; the series [T, 3F], split once per
//   launch into hi/lo planes laid out as wgmma reads them, streams
//   through a three-stage cp.async ring as B, 128 columns a pass.  The
//   SIMT product they replace (cheb_tile.cuh) issued 1.5 shared loads per
//   FMA and ran at 12-15% of the fp32 bound.  Both own kTcRows = 4 sorted
//   rows a block, as row 8 does, and compact the rows' fm ≠ 0 slots, so
//   the empty group slots of K′ cost their fm read; ~73 KB of shared
//   memory and ~80 registers keep three blocks (24 warps) on an SM, whose
//   products, gathers and serial phases overlap.  After each pass the ring
//   is free and holds the epilogue's tile: row 10 stores fm·acc there and
//   sums each row's slots against feats9[j] in slot order (float4, eight
//   neighbour rows in flight) into the block's row accumulator, written
//   once: the [N, K, 3F] attr never reaches memory.  Row 11 stages its
//   rows' g9 once, forms the cotangent tile ct[slot, col] = Σ_{d∈w}
//   g9[row, d]·feats9[j, d] there, and folds ct ⊙ (B·dser) out of the
//   accumulators: per thread, by shuffles within the quad that shares a
//   slot, then over the two warpgroups in order; fm = 0 slots are written
//   as exact zeros first.  No atomics.  What is left (PERF.md): the
//   neighbour gathers of the epilogue, which read 4.6 KB of features a
//   slot from L2, and the wgmma waits of each stage.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cheb_tile.cuh"
#include "tc_tile.cuh"

namespace {

constexpr int kSumThreads = 128;  // threads of a row 8 block
constexpr int kSumWarps = kSumThreads / 32;  // its (row, channel group) tasks
static_assert(kThreads == kTcThreads, "one launch width for rows 9-11");

// First irrep of attr column block w: I = 0, A = 1..3, S = 4..8.
__device__ __forceinline__ int first_irrep(int w) { return w == 0 ? 0 : (w == 1 ? 1 : 4); }

// Writes to sLive the offsets o in [0, len) with flag[s0 + o] ≠ 0, in slot
// order; returns their count.  Every thread calls it.  Each chunk's flag is
// loaded before the previous chunk's barriers, so a block waits for about
// one load, not one per chunk.
template <typename FlagT>
__device__ int compact(const FlagT* __restrict__ flag, long long s0, int len,
                       int* sLive, int* sCount) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int total = 0;
  FlagT next = tid < len ? flag[s0 + tid] : FlagT(0);
  for (int b = 0; b < len; b += kThreads) {
    const bool live = b + tid < len && next != 0;
    next = b + kThreads + tid < len ? flag[s0 + b + kThreads + tid] : FlagT(0);
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

// sStart[r], r ≤ rows: the first compacted slot of the block's row r (slot
// order).  Threads 0..rows write it; the caller syncs before reading.
__device__ __forceinline__ void row_starts(const int* sLive, int nlive, int K,
                                           int rows, int* sStart) {
  const int tid = threadIdx.x;
  if (tid <= rows) {
    int a = 0, b = nlive;
    while (a < b) {
      const int m = (a + b) / 2;
      if (sLive[m] < tid * K) a = m + 1; else b = m;
    }
    sStart[tid] = a;
  }
}

// Row 8: one warp a (sorted row, 128-channel group) task, kSumWarps tasks
// a block.  Lane l owns channels c = 128g + 4l … + 3 of all nine irreps:
// it walks the row's valid slots in slot order (32 mask bytes a round,
// their ballot, the valid slots' neighbour rows broadcast by shuffles)
// and per slot loads the slot's three attr quads (streaming: read once)
// and the neighbour's nine feature quads, twelve float4 loads in flight,
// into nine float4 sums, written once.  No shared memory, no barrier.
__global__ void __launch_bounds__(kSumThreads, 4)
blocked_sum_kernel(const long long* __restrict__ idx,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ attr,
                   const float* __restrict__ feats, float* __restrict__ out,
                   int N, int K, int F) {
  const int groups = (F + kTileN - 1) / kTileN;
  const long long task =
      (long long)blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (task >= (long long)N * groups) return;
  const int row = (int)(task / groups), lane = threadIdx.x & 31;
  const int c = (int)(task - (long long)row * groups) * kTileN + 4 * lane;
  const bool on = c < F;
  const int C3 = 3 * F, C9 = 9 * F;
  const long long base = (long long)row * K;
  float4 o[9];
#pragma unroll
  for (int d = 0; d < 9; ++d) o[d] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s0 = 0; s0 < K; s0 += 32) {
    const bool valid = s0 + lane < K && mask[base + s0 + lane];
    const long long j = valid ? idx[base + s0 + lane] : 0;
    unsigned bits = __ballot_sync(0xffffffffu, valid);
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      const long long jb = __shfl_sync(0xffffffffu, j, b);
      if (!on) continue;
      const float* a = attr + (base + s0 + b) * C3 + c;
      const float* x = feats + jb * C9 + c;
      float4 w[3], xs[9];
#pragma unroll
      for (int q = 0; q < 3; ++q) w[q] = __ldcs(reinterpret_cast<const float4*>(a + q * F));
#pragma unroll
      for (int d = 0; d < 9; ++d) xs[d] = __ldg(reinterpret_cast<const float4*>(x + d * F));
#pragma unroll
      for (int d = 0; d < 9; ++d) {
        const float4 y = w[d == 0 ? 0 : (d < 4 ? 1 : 2)];
        o[d].x = fmaf(y.x, xs[d].x, o[d].x);
        o[d].y = fmaf(y.y, xs[d].y, o[d].y);
        o[d].z = fmaf(y.z, xs[d].z, o[d].z);
        o[d].w = fmaf(y.w, xs[d].w, o[d].w);
      }
    }
  }
  if (on) {
#pragma unroll
    for (int d = 0; d < 9; ++d)
      *reinterpret_cast<float4*>(out + (long long)row * C9 + d * F + c) = o[d];
  }
}

// Row 9: one warp a (sorted row, 128-channel group, kDattrRounds 32-slot
// rounds) task, kSumWarps tasks a block, a row's tasks in neighbouring
// warps.  Lane l owns channels c = 128g + 4l … + 3: it loads the row's nine
// g9 quads once into registers, then for each of its rounds reads the
// round's 32 mask bytes and list entries, stores three zero quads for each
// dead slot (no load to wait for), and for each valid slot, in slot order,
// gathers the neighbour's nine feature quads (L2; the slot's neighbour row
// broadcast by a shuffle) and stores its three output quads.  A warp's
// store of one quad is 512 contiguous bytes; every store is streaming (the
// output is read once, by the caller).  No shared memory, no barrier.
// Rounds, not whole rows, make the tasks: 3,136 sorted rows would fill the
// card's resident warps 1.2 times over, and the last partial wave would
// cost a whole one.
constexpr int kDattrRounds = 1;  // 32-slot rounds a task (0: its whole row)

__global__ void __launch_bounds__(kSumThreads, 4)
blocked_dattr_kernel(const long long* __restrict__ idx,
                     const unsigned char* __restrict__ mask,
                     const float* __restrict__ g9,
                     const float* __restrict__ feats, float* __restrict__ out,
                     int N, int K, int F) {
  const int groups = (F + kTileN - 1) / kTileN, rounds = (K + 31) / 32;
  const int per = kDattrRounds > 0 ? kDattrRounds : rounds;
  const int parts = (rounds + per - 1) / per;  // tasks a (row, group)
  const long long task =
      (long long)blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (task >= (long long)N * groups * parts) return;
  const long long rg = task / parts;  // row · groups + group
  const int r0 = (int)(task - rg * parts) * per;
  const int row = (int)(rg / groups), lane = threadIdx.x & 31;
  const int c = (int)(rg - (long long)row * groups) * kTileN + 4 * lane;
  const bool on = c < F;
  const int C3 = 3 * F, C9 = 9 * F;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 g[9];
#pragma unroll
  for (int d = 0; d < 9; ++d)
    g[d] = on ? __ldg(reinterpret_cast<const float4*>(g9 + (long long)row * C9 + d * F + c))
              : zero;
  for (int r = r0; r < min(rounds, r0 + per); ++r) {
    const long long base = (long long)row * K + 32 * r;
    const int n = min(32, K - 32 * r);
    const bool valid = lane < n && mask[base + lane];
    const long long j = valid ? idx[base + lane] : 0;
    const unsigned bits = __ballot_sync(0xffffffffu, valid);
    // the dead slots' zero rows first
    unsigned dead = ~bits & (n == 32 ? 0xffffffffu : (1u << n) - 1u);
    while (dead) {
      const int b = __ffs(dead) - 1;
      dead &= dead - 1;
      if (on) {
        float* dst = out + (base + b) * C3 + c;
#pragma unroll
        for (int w = 0; w < 3; ++w) __stcs(reinterpret_cast<float4*>(dst + w * F), zero);
      }
    }
    unsigned live = bits;
    while (live) {
      const int b = __ffs(live) - 1;
      live &= live - 1;
      const long long jb = __shfl_sync(0xffffffffu, j, b);
      if (!on) continue;
      const float* x = feats + jb * C9 + c;
      float4 xs[9], o[3] = {zero, zero, zero};
#pragma unroll
      for (int d = 0; d < 9; ++d) xs[d] = __ldg(reinterpret_cast<const float4*>(x + d * F));
#pragma unroll
      for (int d = 0; d < 9; ++d) {
        float4& y = o[d == 0 ? 0 : (d < 4 ? 1 : 2)];
        y.x = fmaf(g[d].x, xs[d].x, y.x);
        y.y = fmaf(g[d].y, xs[d].y, y.y);
        y.z = fmaf(g[d].z, xs[d].z, y.z);
        y.w = fmaf(g[d].w, xs[d].w, y.w);
      }
      float* dst = out + (base + b) * C3 + c;
#pragma unroll
      for (int w = 0; w < 3; ++w) __stcs(reinterpret_cast<float4*>(dst + w * F), o[w]);
    }
  }
}

// Rows 10 and 11 share this block plan: kTcRows sorted rows, their live
// slots (fm ≠ 0) compacted in slot order and walked in tiles of kTcM.
constexpr int kTcRows = 4;  // sorted rows a row 10 / row 11 block owns

// Row 10: attr = fm · basis · coeffs formed per tile and 128-column pass
// on the tensor cores, then summed per row against the neighbour rows.
__global__ void __launch_bounds__(kTcThreads, 3)
blocked_sum_cheb_kernel(const long long* __restrict__ idx,
                        const float* __restrict__ d, const float* __restrict__ fm,
                        const float* __restrict__ image,
                        const float* __restrict__ feats, float* __restrict__ out,
                        int N, int K, int F, int T, float lo, float hi) {
  extern __shared__ __align__(16) float smem[];
  const int C3 = 3 * F, C9 = 9 * F;
  float* sW = smem + tc_region_offset(smem);  // the planes, then attr
  float* sAcc = sW + kTcRegion;               // [kTcRows][9F] outputs
  float* sTheta = sAcc + kTcRows * C9;        // [64]
  float* sFm = sTheta + kTcM;                 // [64]
  int* sJ = reinterpret_cast<int*>(sFm + kTcM);  // [64] neighbor rows
  int* sCount = sJ + kTcM;                    // [8]
  int* sStart = sCount + 8;                   // [kTcRows + 1], padded to 8
  int* sLive = sStart + 8;                    // [kTcRows·K]

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kTcRows;
  const int nr = min(kTcRows, N - r0);
  const long long s0 = (long long)r0 * K;
  for (int v = tid; v < kTcRows * C9; v += kTcThreads) sAcc[v] = 0.0f;
  const int nlive = compact(fm, s0, nr * K, sLive, sCount);
  row_starts(sLive, nlive, K, kTcRows, sStart);

  __syncthreads();  // sLive and sStart are written
  // thread t < 64 reads slot t of a tile one tile ahead of its use
  float pd = 0.0f, pf = 0.0f;
  int pj = 0;
  if (tid < min(kTcM, nlive)) {
    const long long e = s0 + sLive[tid];
    pj = (int)idx[e];
    pd = d[e];
    pf = fm[e];
  }
  for (int t0 = 0; t0 < nlive; t0 += kTcM) {
    const int nt = min(kTcM, nlive - t0);
    __syncthreads();  // the previous tile is consumed
    if (tid < kTcM) {
      sJ[tid] = tid < nt ? pj : 0;
      sTheta[tid] = tid < nt ? cheb_theta(pd, lo, hi) : 0.0f;
      sFm[tid] = tid < nt ? pf : 0.0f;
      if (t0 + kTcM + tid < nlive) {
        const long long e = s0 + sLive[t0 + kTcM + tid];
        pj = (int)idx[e];
        pd = d[e];
        pf = fm[e];
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < C3; c0 += kTcN) {
      float acc[8][4];
      tc_product(sTheta, image, T, c0 / kTcN, sW, acc);  // syncs first, last
      // attr tile [64][kTcLdW] over the free planes: fm · acc
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
      // outputs (irrep i of the column's block, row r, 4 columns q): a warp
      // shares (i, r) and walks 128 neighbouring channels; each thread adds
      // its row's slots in slot order, eight neighbour loads in flight
      for (int v = tid; v < 5 * kTcRows * (kTcN / 4); v += kTcThreads) {
        const int q = v % (kTcN / 4), r = (v / (kTcN / 4)) % kTcRows,
                  i = v / (kTcN / 4 * kTcRows);
        const int col = c0 + 4 * q;
        if (col >= C3 || r >= nr) continue;
        const int w = col / F, c = col - w * F;
        if (i > 2 * w) continue;
        const int a = max(sStart[r], t0) - t0;
        const int b = min(sStart[r + 1], t0 + nt) - t0;
        if (a >= b) continue;
        const int dcol = (first_irrep(w) + i) * F + c;
        const float* x = feats + dcol;
        const float* at = sW + 4 * q;
        float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        int s = a;
        for (; s + 8 <= b; s += 8) {
          float4 xs[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            xs[u] = __ldg(reinterpret_cast<const float4*>(x + (long long)sJ[s + u] * C9));
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const float4 y = *reinterpret_cast<const float4*>(at + (s + u) * kTcLdW);
            o.x = fmaf(y.x, xs[u].x, o.x);
            o.y = fmaf(y.y, xs[u].y, o.y);
            o.z = fmaf(y.z, xs[u].z, o.z);
            o.w = fmaf(y.w, xs[u].w, o.w);
          }
        }
        for (; s < b; ++s) {
          const float4 xs = __ldg(reinterpret_cast<const float4*>(x + (long long)sJ[s] * C9));
          const float4 y = *reinterpret_cast<const float4*>(at + s * kTcLdW);
          o.x = fmaf(y.x, xs.x, o.x);
          o.y = fmaf(y.y, xs.y, o.y);
          o.z = fmaf(y.z, xs.z, o.z);
          o.w = fmaf(y.w, xs.w, o.w);
        }
        float4* acc4 = reinterpret_cast<float4*>(sAcc + r * C9 + dcol);
        float4 p = *acc4;
        p.x += o.x; p.y += o.y; p.z += o.z; p.w += o.w;
        *acc4 = p;
      }
    }
  }
  __syncthreads();
  for (int v = tid; v < nr * C9 / 4; v += kTcThreads)
    reinterpret_cast<float4*>(out + (long long)r0 * C9)[v] =
        reinterpret_cast<const float4*>(sAcc)[v];
}

// Row 11: per tile and pass, B·dser on the tensor cores, the cotangent
// tile ct[slot, col] = Σ_{d∈w(col)} g9[row, d]·feats9[j, d] formed in the
// free stages from the block's staged g9 rows, and Σ_col ct ⊙ (B·dser)
// folded from the accumulators: per thread, then over its quad by
// shuffles, then over the 4 column warps in order.
__global__ void __launch_bounds__(kTcThreads, 3)
blocked_dd_cheb_kernel(const long long* __restrict__ idx,
                       const float* __restrict__ d, const float* __restrict__ fm,
                       const float* __restrict__ image, const float* __restrict__ g9,
                       const float* __restrict__ feats, float* __restrict__ out,
                       int N, int K, int F, int T, float lo, float hi) {
  extern __shared__ __align__(16) float smem[];
  const int C3 = 3 * F, C9 = 9 * F;
  float* sW = smem + tc_region_offset(smem);  // the planes, then ct
  float* sG = sW + kTcRegion;                 // [kTcRows][9F] the rows' g9
  float* sRed = sG + kTcRows * C9;            // [2][64] per warpgroup
  float* sTheta = sRed + 2 * kTcM;            // [64]
  float* sFm = sTheta + kTcM;                 // [64]
  int* sJ = reinterpret_cast<int*>(sFm + kTcM);  // [64] neighbor rows
  int* sR = sJ + kTcM;                        // [64] the block's row of a slot
  int* sCount = sR + kTcM;                    // [8]
  int* sLive = sCount + 8;                    // [kTcRows·K]

  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = blockIdx.x * kTcRows;
  const int nr = min(kTcRows, N - r0);
  const long long s0 = (long long)r0 * K;
  for (int o = tid; o < nr * K; o += kTcThreads)  // fm = 0: exact zeros
    if (fm[s0 + o] == 0.0f) out[s0 + o] = 0.0f;
  for (int v = tid; v < nr * C9 / 4; v += kTcThreads)
    reinterpret_cast<float4*>(sG)[v] =
        reinterpret_cast<const float4*>(g9 + (long long)r0 * C9)[v];
  const int nlive = compact(fm, s0, nr * K, sLive, sCount);

  __syncthreads();  // sLive is written
  // thread t < 64 reads slot t of a tile one tile ahead of its use
  float pd = 0.0f, pf = 0.0f;
  int pj = 0, po = 0;
  if (tid < min(kTcM, nlive)) {
    po = sLive[tid];
    pj = (int)idx[s0 + po];
    pd = d[s0 + po];
    pf = fm[s0 + po];
  }
  for (int t0 = 0; t0 < nlive; t0 += kTcM) {
    const int nt = min(kTcM, nlive - t0);
    __syncthreads();  // the previous tile's θ, rows and sRed are consumed
    if (tid < kTcM) {
      sJ[tid] = tid < nt ? pj : 0;
      sR[tid] = tid < nt ? po / K : 0;
      sTheta[tid] = tid < nt ? cheb_theta(pd, lo, hi) : 0.0f;
      sFm[tid] = tid < nt ? pf : 0.0f;
      if (t0 + kTcM + tid < nlive) {
        po = sLive[t0 + kTcM + tid];
        pj = (int)idx[s0 + po];
        pd = d[s0 + po];
        pf = fm[s0 + po];
      }
    }
    __syncthreads();
    float part[2] = {0.0f, 0.0f};
    for (int c0 = 0; c0 < C3; c0 += kTcN) {
      float acc[8][4];
      tc_product(sTheta, image, T, c0 / kTcN, sW, acc);  // syncs first, last
      // ct tile [64][kTcLdW] over the free planes, 4 columns a thread
      for (int v = tid; v < kTcM * (kTcN / 4); v += kTcThreads) {
        const int s = v / (kTcN / 4), q = v % (kTcN / 4);
        const int col = c0 + 4 * q;
        if (s >= nt || col >= C3) continue;
        const int w = col / F, c = col - w * F;
        const int d0 = first_irrep(w);
        const float* x = feats + (long long)sJ[s] * C9 + d0 * F + c;
        const float* gg = sG + sR[s] * C9 + d0 * F + c;
        // the 1, 3 or 5 neighbour loads of the column's irreps issued together
        float4 xs[5];
#pragma unroll
        for (int u = 0; u < 5; ++u)
          if (u <= 2 * w) xs[u] = __ldg(reinterpret_cast<const float4*>(x + u * F));
        float4 ct = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int u = 0; u < 5; ++u) {
          if (u > 2 * w) break;
          const float4 a = *reinterpret_cast<const float4*>(gg + u * F);
          ct.x = fmaf(a.x, xs[u].x, ct.x);
          ct.y = fmaf(a.y, xs[u].y, ct.y);
          ct.z = fmaf(a.z, xs[u].z, ct.z);
          ct.w = fmaf(a.w, xs[u].w, ct.w);
        }
        *reinterpret_cast<float4*>(sW + s * kTcLdW + 4 * q) = ct;
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tc_row(h);
        if (r >= nt) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (c0 + tc_col(i) >= C3) continue;  // C3 is a multiple of 4
          const float2 ct = *reinterpret_cast<const float2*>(sW + r * kTcLdW + tc_col(i));
          part[h] = fmaf(acc[i][2 * h], ct.x, part[h]);
          part[h] = fmaf(acc[i][2 * h + 1], ct.y, part[h]);
        }
      }
    }
    // the quad (lanes 4g..4g+3) shares a slot: butterfly, then one lane a
    // slot writes its warpgroup's sum
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = part[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0) sRed[(tid >> 7) * kTcM + tc_row(h)] = v;
    }
    __syncthreads();
    if (tid < nt) out[s0 + sLive[t0 + tid]] = (sRed[tid] + sRed[kTcM + tid]) * sFm[tid];
  }
}

// Dynamic shared memory of rows 10 and 11 (ops/blocked_mp.py keeps the
// same sums): 1 KB for aligning the region to 1024 bytes; their basis
// lives in registers.  Row 8 takes none.
size_t sum_cheb_smem(int k, int f) {
  return 1024 + sizeof(float) * (kTcRegion +
                                 (size_t)kTcRows * 9 * f + 2 * kTcM) +
         sizeof(int) * ((size_t)kTcM + 16 + (size_t)kTcRows * k);
}

size_t dd_cheb_smem(int k, int f) {
  return 1024 + sizeof(float) * (kTcRegion +
                                 (size_t)kTcRows * 9 * f + 4 * kTcM) +
         sizeof(int) * (2 * (size_t)kTcM + 8 + (size_t)kTcRows * k);
}

template <typename Kern, typename... Args>
int launch_rows(Kern kernel, int rows, int n, size_t smem, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + rows - 1) / rows;
  if (blocks == 0) return cudaSuccess;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Row 8.  idx [n, k] int64; mask [n, k] bool; attr [n, k, 3f]; feats, out
// [n, 9f].  f a multiple of 4.  Block b takes the (row, channel group)
// tasks [4b, 4b + 4), task t = row · ⌈f/128⌉ + group.
int tmd_blocked_sum(const long long* idx, const unsigned char* mask,
                    const float* attr, const float* feats, float* out, int n,
                    int k, int f, void* stream) {
  const long long tasks = (long long)n * ((f + kTileN - 1) / kTileN);
  const long long blocks = (tasks + kSumWarps - 1) / kSumWarps;
  if (blocks == 0) return cudaSuccess;
  blocked_sum_kernel<<<(unsigned)blocks, kSumThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(idx, mask, attr,
                                                            feats, out, n, k, f);
  return cudaGetLastError();
}

// Row 10.  idx [n, k] int64; d, fm [n, k]; coeffs [t, 3f]; feats, out [n, 9f];
// image [tc_image_floats(t, 3f)] scratch.
int tmd_blocked_sum_cheb(const long long* idx, const float* d, const float* fm,
                         const float* coeffs, const float* feats, float* out,
                         float* image, int n, int k, int f, int t, float lo,
                         float hi, void* stream) {
  const int err = tc_split(coeffs, t, 3 * f, image, stream);
  if (err != cudaSuccess) return err;
  return launch_rows(blocked_sum_cheb_kernel, kTcRows, n, sum_cheb_smem(k, f),
                     stream, idx, d, fm, image, feats, out, n, k, f, t, lo, hi);
}

// Row 9.  idx, mask [n, k]; g9, feats [n, 9f]; out [n, k, 3f].  f a
// multiple of 4.  Block b takes the (row, channel group, rounds) tasks
// [4b, 4b + 4), task t = (row · ⌈f/128⌉ + group) · P + part, P the row's
// ⌈⌈k/32⌉ / R⌉ parts of R = kDattrRounds 32-slot rounds.
int tmd_blocked_dattr(const long long* idx, const unsigned char* mask,
                      const float* g9, const float* feats, float* out, int n,
                      int k, int f, void* stream) {
  const int rounds = (k + 31) / 32;
  const int per = kDattrRounds > 0 ? kDattrRounds : rounds;
  const long long tasks = rounds == 0 ? 0
      : (long long)n * ((f + kTileN - 1) / kTileN) * ((rounds + per - 1) / per);
  const long long blocks = (tasks + kSumWarps - 1) / kSumWarps;
  if (blocks == 0) return cudaSuccess;
  blocked_dattr_kernel<<<(unsigned)blocks, kSumThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(idx, mask, g9,
                                                              feats, out, n, k, f);
  return cudaGetLastError();
}

// Row 11.  idx [n, k] int64; d, fm [n, k]; dser [t, 3f]; g9, feats [n, 9f];
// out [n, k]; image [tc_image_floats(t, 3f)] scratch.
int tmd_blocked_dd_cheb(const long long* idx, const float* d, const float* fm,
                        const float* dser, const float* g9, const float* feats,
                        float* out, float* image, int n, int k, int f, int t,
                        float lo, float hi, void* stream) {
  const int err = tc_split(dser, t, 3 * f, image, stream);
  if (err != cudaSuccess) return err;
  return launch_rows(blocked_dd_cheb_kernel, kTcRows, n, dd_cheb_smem(k, f),
                     stream, idx, d, fm, image, g9, feats, out, n, k, f, t, lo, hi);
}

// Floats of the image scratch rows 10 and 11 take at (t, c3 = 3f).
int tmd_tc_image_floats(int t, int c3) { return tc_image_floats(t, c3); }

// What the compiler and the launch give rows 8 (which = 8), 9 (9), 10
// (10) and 11 (11) at (k, f, t): out = registers a thread, local (spill) bytes a
// thread, static and dynamic shared memory bytes a block, resident blocks
// an SM.
int tmd_blocked_mp_attributes(int which, int k, int f, int t, int* out) {
  const bool warps = which == 8 || which == 9;  // a warp a row, no smem
  const void* kern = which == 8    ? (const void*)blocked_sum_kernel
                     : which == 9  ? (const void*)blocked_dattr_kernel
                     : which == 10 ? (const void*)blocked_sum_cheb_kernel
                                   : (const void*)blocked_dd_cheb_kernel;
  const size_t smem = warps         ? 0
                      : which == 10 ? sum_cheb_smem(k, f)
                                    : dd_cheb_smem(k, f);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kern, warps ? kSumThreads : kTcThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = blocks;
  return cudaSuccess;
}

}  // extern "C"
