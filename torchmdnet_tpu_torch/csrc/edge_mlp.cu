// TensorNet and TensorNet2 edge MLPs for Hopper (sm_90a), float32-accurate:
// both kernels form their products on the tensor cores in 3xTF32
// (csrc/tc_tile.cuh; never single-pass TF32), through one chain.
//
// Replaces two Pallas TPU kernels of torchmdnet_tpu/ops/pallas_kernels.py:
//   kernel 3  _edge_mlp_pre_kernel (:182, pallas_call :208,
//             fused_edge_mlp_pre :226), TensorNet2's charge-fold tail:
//     out[e, :] = silu(silu(silu(pre1[e, :]) W2 + b2) W3 + b3) * cw[e]
//   kernel 4  _edge_mlp_kernel (:59, pallas_call :88, fused_edge_mlp :106),
//             TensorNet's whole interaction edge MLP:
//     out[e, :] = silu(silu(silu(x[e, :] W1 + b1) W2 + b2) W3 + b3) * cw[e]
// for E = N*K edge slots; x [E, R], pre1 [E, F], W1 [R, F], W2 [F, 2F],
// W3 [2F, 3F] (input-major, the JAX kernel layout), out [E, 3F].
//
// Bounds (H100 SXM data sheet at 700 W: 495 TFLOP/s TF32 on the tensor
// cores, 3.35 TB/s).  Kernel 3 (the north star's gather path: N=25,088,
// K=96 slots at 4.5 Å + 1 Å skin, F=128, 924,946 of the 2,408,448 slots
// with cw != 0, per call): the live slots' products are 2*live*(F*2F +
// 2F*3F) = 242 GFLOP, three TF32 products each in 3xTF32, ~1.47 ms; the
// live rows of pre1, cw and the whole [E, 3F] output, zeros included, are
// 4.2 GB, ~1.25 ms: operations bound it, bytes close behind.  Kernel 4
// (dhfr: N=2,560, K=64, R=32, ~97.6 k slots with cw != 0):
// 2*97.6k*(R*F + F*2F + 2F*3F) = 26 GFLOP, ~0.16 ms in 3xTF32, against
// 0.27 GB of x, cw and the whole output (~0.08 ms): operations.  On the
// dhfr blocked path's grouped K′ = 224 list the same live slots sit among
// 702,464, and the output's 1.08 GB (~0.32 ms) bounds it: bytes.
//
// Design (edge_mlp_tc_kernel, one template for both kernels): the grid is
// one block an SM.  A first pass counts the live slots (cw != 0) of each
// 256-slot chunk (live_count_kernel), a second (range_kernel) cuts the
// chunks into one contiguous run a block of equal cost, a live slot
// weighing as much as 16 dead ones.  It walks its run 1,024 slots at a time, compacts
// the live slots in slot order, writes exact zeros for the rest (whole
// [3F] rows of float4 stores), and runs the chain on whole tiles of 64
// live slots, carrying the slots short of a tile into the next window: a
// block's only partial tile is its last, and the blocks end together.
// Per tile the whole chain stays on chip.  Kernel 4 stages the tile's x
// rows [64 x R] with float4 loads into shared memory and forms sA =
// silu(x W1 + b1) [64 x F] by tc_product_from (W1 split once per launch
// like W2 and W3; R need not be a multiple of the 16-row stage: the
// image's rows past R are zeros and the fragments' reads stop at R);
// kernel 3 loads sA = silu(pre1) from the live rows.  Then both run the
// same two products: 128-column passes of sA W2 (W2 split once per launch
// into hi/lo planes streamed through a cp.async ring, A fragments read
// from sA) whose epilogues put silu(acc + b2) from the fragments into the
// h2 tile sH [64 x 2F + 4]; then passes of sH W3 whose epilogues put
// silu(acc + b3) * cw into the free ring as a [64 x kTcLdW] tile, stored
// with coalesced float4 stores per live slot.  sA lives in sH's last F
// columns, which the last W2 pass writes after its product has read them.
// The [E, 2F] intermediate never reaches device memory, and no sum is
// split or taken by atomics: the same result on every run and every grid.
// At F = 128 the ring (48 KB), sH (66.5 KB), kernel 4's x tile (9 KB) and
// the lists make 125-135 KB, so one block of 8 warps runs an SM.  Above F
// = 256, or where kernel 4's x tile would pass a block's 232,448 B, the
// tiles (the wide form) go to each block's region of a device-memory
// scratch the wrapper allocates, tc_product_from reads its A fragments
// there, and each stage is summed in fp32 apart; no pass is held.
//
// Why this grid (tools/torch_dhfr_phases.py's variants on an H100):
// 1,024-slot runs one a block give 160 blocks at the dhfr brute list (97 k
// live of 163,840 slots), two waves at one block an SM, the second of 28,
// and a partial tile each; runs of equal slot counts leave the blocks of
// the grouped K′ list (14% live) unequal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

constexpr int kPad = 4;          // row padding of the activations in smem
constexpr int kChunk = kTcThreads;  // slots of a live count: one compaction round
constexpr int kWin = 1024;       // slots a block compacts at a time
// what a live slot costs (its share of a tile's chain) in slots with cw =
// 0 (their compaction and zero row), for the blocks' balanced ranges: 0.71
// ms of tiles for 97 k live slots against 0.32 ms to compact and zero
// 702 k slots on an H100 (tools/torch_dhfr_phases.py)
constexpr int kLiveWeight = 16;
constexpr int kWarps = kTcThreads / 32;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
static_assert(kWin % kChunk == 0, "a window is whole compaction rounds");

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// Live slots (flag != 0) of each kChunk-slot chunk of [0, E): one warp a
// chunk.
__global__ void __launch_bounds__(kTcThreads)
live_count_kernel(const float* __restrict__ flag, long long E, int nchunks,
                  int* __restrict__ counts) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (c >= nchunks) return;
  int n = 0;
#pragma unroll
  for (int i = 0; i < kChunk / 32; ++i) {
    const long long s = (long long)c * kChunk + 32 * i + lane;
    n += __popc(__ballot_sync(0xffffffffu, s < E && flag[s] != 0.0f));
  }
  if (lane == 0) counts[c] = n;
}

// The first chunk of each of the g blocks' runs, ranges[b] for b ≤ g
// (ranges[g] = nchunks), one block: with cost(c) = kLiveWeight·counts[c]
// + the chunk's slots and P(c) the cost of the chunks before c, block b
// owns the chunks with b·T ≤ P(c)·g < (b + 1)·T for the total T.  The
// runs are contiguous, cover every chunk once and hold within one chunk
// of T/g of cost each.  (Computed inside the main kernel, the same scan
// made its products ~14% slower on an H100: a pass of its own.)
__global__ void __launch_bounds__(kTcThreads)
range_kernel(const int* __restrict__ counts, int nchunks, long long E, int g,
             int* __restrict__ ranges) {
  __shared__ long long sSum[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (nchunks + kTcThreads - 1) / kTcThreads;
  const int c0 = tid * per;
  auto cost = [&](int c) {
    return c < nchunks ? (long long)kLiveWeight * counts[c] +
                             min((long long)kChunk, E - (long long)c * kChunk)
                       : 0LL;
  };
  long long mine = 0;
  for (int i = 0; i < per; ++i) mine += cost(c0 + i);
  long long incl = mine;  // inclusive warp scan
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const long long v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) sSum[warp] = incl;
  __syncthreads();
  long long p = incl - mine, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) p += sSum[w];
    total += sSum[w];
  }
  // chunk c opens the runs of the blocks b(c − 1) < b ≤ b(c), b(c) =
  // ⌊P(c)·g / T⌋; the runs past the last chunk's block open at nchunks
  long long prev = c0 == 0 ? -1 : (p - cost(c0 - 1)) * g / total;
  for (int i = 0; i < per && c0 + i < nchunks; ++i) {
    const long long bc = p * g / total;
    for (long long b = prev + 1; b <= bc; ++b) ranges[b] = c0 + i;
    prev = bc;
    p += cost(c0 + i);
    if (c0 + i == nchunks - 1)
      for (long long b = bc + 1; b <= g; ++b) ranges[b] = nchunks;
  }
}

// Appends to sLive the slots of [w0, w0 + len) with flag != 0 and writes
// to sDead the others, each in slot order, as offsets from w0 plus off
// (sLive) or from w0 (sDead), kTcThreads slots a round.  Returns the live
// count; *ndead gets the other.  Every thread calls it.
__device__ __forceinline__ int compact_window(const float* __restrict__ flag,
                                              long long w0, int len, int off,
                                              int* sLive, int* sDead,
                                              int* sCount, int* ndead) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int nlive = 0, nin = 0;
#pragma unroll 1
  for (int c0 = 0; c0 < len; c0 += kTcThreads) {
    const bool in = c0 + tid < len;
    const bool live = in && flag[w0 + c0 + tid] != 0.0f;
    const unsigned lb = __ballot_sync(0xffffffffu, live);
    const unsigned ib = __ballot_sync(0xffffffffu, in);
    if (lane == 0) {
      sCount[warp] = __popc(lb);
      sCount[kWarps + warp] = __popc(ib);
    }
    __syncthreads();
    int live_before = nlive, in_before = nin;
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
      sLive[lrank] = off + c0 + tid;
    else if (in)
      sDead[irank - lrank] = c0 + tid;
    __syncthreads();  // the lists are whole; sCount is read
  }
  *ndead = nin - nlive;
  return nlive;
}

// The h2 tile [64][ldh] in the narrow form (F ≤ 256): 2F columns, and sA
// [64][F] (silu(pre1), or kernel 4's silu(x W1 + b1)) in the columns [a0,
// a0 + F) of the same rows, a0 = 128·(P − Q) for P = ⌈2F/128⌉ W2 passes
// and Q = ⌈F/128⌉ ≤ 2: the first P − Q passes write below a0, the last
// writes over sA after the last read of it, and with Q = 2 the one before
// it keeps its result in registers until then.
__host__ __device__ __forceinline__ int pre_a0(int f) {
  return kTcN * ((2 * f + kTcN - 1) / kTcN - (f + kTcN - 1) / kTcN);
}
__host__ __device__ __forceinline__ int pre_ldh(int f) {
  return max(2 * f, pre_a0(f) + f) + kPad;
}
constexpr int kPreMaxNarrowF = 2 * kTcN;
// Row stride of kernel 4's x tile: R rounded up to 32 columns, plus 4, so
// that a warp's A fragment reads hit 32 distinct banks (≡ 4 mod 32).
__host__ __device__ __forceinline__ int x_ld(int r) {
  return (r + 31) / 32 * 32 + kPad;
}
// Floats of a block's tiles in the wide form, in device memory: h2 [64][2F
// + 4], sA [64][F + 4] and, for kernel 4 (r > 0), x [64][x_ld(r)], apart
// (no pass is held).
__host__ __device__ __forceinline__ long long chain_tile_floats(int f, int r) {
  return (long long)kTcM * (3 * f + 2 * kPad + (r > 0 ? x_ld(r) : 0));
}

// Ints of a block's lists: the live slots of a window and those held over
// from the last (< 64), the window's dead slots, the warp counts.
constexpr int kListInts = (kWin + kTcM) + kWin + 2 * kWarps;

// Dynamic shared memory of a launch at (f, r; r = 0 for kernel 3)
// (ops/edge_mlp.py::chain_smem keeps the same sum): 1 KB to align the
// region, the region (the ring, then the out tile), in the narrow form the
// h2 tile that also holds sA and kernel 4's x tile, cw, then the lists.
size_t chain_smem(int f, int r, bool wide) {
  const size_t tiles =
      wide ? 0 : (size_t)kTcM * (pre_ldh(f) + (r > 0 ? x_ld(r) : 0));
  return 1024 + sizeof(float) * ((size_t)kTcRegion + tiles + kTcM) +
         sizeof(int) * kListInts;
}

// Whether a launch keeps its tiles in device memory: kernel 3 above F =
// 256, kernel 4 also where its narrow tiles pass a block's shared memory.
bool chain_wide(int f, int r) {
  return f > kPreMaxNarrowF ||
         (r > 0 && chain_smem(f, r, false) > (size_t)kSmemLimit);
}

// A product of pass p with the activation act [64][lda] as A; it
// synchronises first (act is written, sR free) and last.  The wide form
// sums each stage apart and adds it in fp32 (kStageSums, as rows 5 and 7
// do): its sums over K = F and 2F run past 512 terms.
template <bool kStageSums>
__device__ __forceinline__ void chain_product(const float* act, int lda,
                                              const float* __restrict__ img,
                                              int kdim, int p, float* sR,
                                              float (&acc)[8][4]) {
  __syncthreads();
  tc_product_from<kStageSums>(
      TcActivation{act + tc_row(0) * lda, act + tc_row(1) * lda, kdim}, img,
      kdim, p, sR, acc);
}

// Kernels 3 (kLayer1 false: in = pre1 [E, F]) and 4 (kLayer1: in = x [E,
// R], img1 W1's split image).  img2, img3: the split images of W2 [F, 2F]
// and W3 [2F, 3F]; ranges: each block's first chunk (range_kernel).
// Block b owns the contiguous slots of its chunks, walks
// them a window at a time and forms whole 64-slot tiles across windows:
// only its last tile is partial.  In the wide form each block has its
// chain_tile_floats of tiles.
template <bool kLayer1, bool kWide>
__global__ void __launch_bounds__(kTcThreads, 1)
edge_mlp_tc_kernel(const float* __restrict__ in, const float* __restrict__ cw,
                   const float* __restrict__ img1, const float* __restrict__ b1,
                   const float* __restrict__ img2, const float* __restrict__ b2,
                   const float* __restrict__ img3, const float* __restrict__ b3,
                   float* __restrict__ out, float* tiles,
                   const int* __restrict__ ranges, long long E, int R, int F) {
  extern __shared__ __align__(16) float smem[];
  const int F2 = 2 * F, F3 = 3 * F;
  const int ldh = kWide ? F2 + kPad : pre_ldh(F);
  const int lda = kWide ? F + kPad : ldh;
  const int ldx = kLayer1 ? x_ld(R) : 0;
  float* sR = smem + tc_region_offset(smem);  // the ring, then the out tile
  float* sH;                                  // [64][ldh]  h2
  float* sA;                                  // [64][lda]  the W2 product's A
  float* sX;                                  // [64][ldx]  x (kernel 4)
  float* sCw;                                 // [64]
  if constexpr (kWide) {
    sH = tiles + (long long)blockIdx.x * chain_tile_floats(F, kLayer1 ? R : 0);
    sA = sH + kTcM * ldh;
    sX = sA + kTcM * lda;
    sCw = sR + kTcRegion;
  } else {
    sH = sR + kTcRegion;
    sA = sH + pre_a0(F);
    sX = sH + kTcM * ldh;
    sCw = sX + kTcM * ldx;
  }
  int* sLive = reinterpret_cast<int*>(sCw + kTcM);  // [kWin + 64]
  int* sDead = sLive + kWin + kTcM;                 // [kWin]
  int* sCount = sDead + kWin;                       // [2 * kWarps]

  const int tid = threadIdx.x;
  // silu(acc + bias) of pass p from the fragments into dst's columns below
  // ncols (even: F is a multiple of 4)
  auto store_silu = [&](const float (&acc)[8][4], int p, const float* bias,
                        float* dst, int ld, int ncols) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = p * kTcN + tc_col(i);
      if (col >= ncols) continue;
      const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(dst + tc_row(h) * ld + col) =
            make_float2(silu(acc[i][2 * h] + b.x), silu(acc[i][2 * h + 1] + b.y));
    }
  };
  const int npass = (F2 + kTcN - 1) / kTcN;
  const bool hold = !kWide && (F + kTcN - 1) / kTcN == 2;
  float acc[8][4], held[8][4];
  // sLive holds offsets from s0
  const long long s0 = (long long)ranges[blockIdx.x] * kChunk;
  const long long s1 = min(E, (long long)ranges[blockIdx.x + 1] * kChunk);
  int nlive = 0;  // the live slots held in sLive
  for (long long w0 = s0; w0 < s1; w0 += kWin) {
  const int len = (int)min((long long)kWin, s1 - w0);
  int ndead;
  nlive += compact_window(cw, w0, len, (int)(w0 - s0), sLive + nlive, sDead,
                          sCount, &ndead);

  // slots with cw = 0: exact zeros, no arithmetic
  const int c4 = F3 / 4;
  for (int v = tid; v < ndead * c4; v += kTcThreads)
    reinterpret_cast<float4*>(out + (w0 + sDead[v / c4]) * F3)[v % c4] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // whole tiles; the last window takes the partial one too
  const int ntiles = w0 + kWin < s1 ? nlive / kTcM : (nlive + kTcM - 1) / kTcM;
  for (int t0 = 0; t0 < ntiles * kTcM; t0 += kTcM) {
    const int nt = min(kTcM, nlive - t0);
    if constexpr (kLayer1) {
      // x of the tile's live slots; the rows past nt are zeros
      const int r4 = R / 4;
      for (int v = tid; v < kTcM * r4; v += kTcThreads) {
        const int r = v / r4, col = (v - r * r4) * 4;
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < nt)
          x = *reinterpret_cast<const float4*>(in + (s0 + sLive[t0 + r]) * R + col);
        *reinterpret_cast<float4*>(sX + r * ldx + col) = x;
      }
    } else {
      // silu(pre1) of the tile's live slots; the rows past nt are zeros
      const int f4 = F / 4;
      for (int v = tid; v < kTcM * f4; v += kTcThreads) {
        const int r = v / f4, col = (v - r * f4) * 4;
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < nt) {
          x = *reinterpret_cast<const float4*>(in + (s0 + sLive[t0 + r]) * F + col);
          x = make_float4(silu(x.x), silu(x.y), silu(x.z), silu(x.w));
        }
        *reinterpret_cast<float4*>(sA + r * lda + col) = x;
      }
    }
    if (tid < kTcM) sCw[tid] = tid < nt ? cw[s0 + sLive[t0 + tid]] : 0.0f;

    // kernel 4's first layer: sA = silu(x W1 + b1)
    if constexpr (kLayer1) {
      for (int p = 0; p * kTcN < F; ++p) {
        chain_product<kWide>(sX, ldx, img1, R, p, sR, acc);  // syncs first, last
        store_silu(acc, p, b1, sA, lda, F);
      }
    }
    // h2 = silu(sA W2 + b2)
    for (int p = 0; p < npass; ++p) {
      chain_product<kWide>(sA, lda, img2, F, p, sR, acc);  // syncs first, last
      if (hold && p == npass - 2) {  // it would overwrite what pass p + 1 reads
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) held[i][e] = acc[i][e];
        continue;
      }
      store_silu(acc, p, b2, sH, ldh, F2);
      if (hold && p == npass - 1) store_silu(held, p - 1, b2, sH, ldh, F2);
    }
    // out = silu(h2 W3 + b3) * cw, one 128-column pass at a time
    for (int p = 0; p * kTcN < F3; ++p) {
      const int c0 = p * kTcN;
      chain_product<kWide>(sH, ldh, img3, F2, p, sR, acc);  // syncs first, last
      // the out tile [64][kTcLdW] over the free ring, the live rows only
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = tc_row(h);
        if (r >= nt) continue;
        const float c = sCw[r];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = c0 + tc_col(i);  // even; F3 is a multiple of 4
          if (col >= F3) continue;
          const float2 bias = *reinterpret_cast<const float2*>(b3 + col);
          *reinterpret_cast<float2*>(sR + r * kTcLdW + tc_col(i)) =
              make_float2(silu(acc[i][2 * h] + bias.x) * c,
                          silu(acc[i][2 * h + 1] + bias.y) * c);
        }
      }
      __syncthreads();
      // a warp stores one slot's 128 columns: 512 contiguous bytes
      for (int v = tid; v < nt * (kTcN / 4); v += kTcThreads) {
        const int r = v / (kTcN / 4), q = v % (kTcN / 4);
        const int col = c0 + 4 * q;
        if (col < F3)
          *reinterpret_cast<float4*>(out + (s0 + sLive[t0 + r]) * F3 + col) =
              *reinterpret_cast<const float4*>(sR + r * kTcLdW + 4 * q);
      }
    }
  }
  __syncthreads();  // the lists, sCw and the out tile are read
  // the live slots short of a tile go to the list's front
  const int done = min(nlive, ntiles * kTcM), held_over = nlive - done;
  const int keep = tid < held_over ? sLive[done + tid] : 0;
  __syncthreads();
  if (tid < held_over) sLive[tid] = keep;
  nlive = held_over;  // the next compaction's barrier orders the writes
  }
}

template <bool kLayer1>
const void* chain_kernel(bool wide) {
  return wide ? (const void*)edge_mlp_tc_kernel<kLayer1, true>
              : (const void*)edge_mlp_tc_kernel<kLayer1, false>;
}

// Counts each chunk's live slots into counts [⌈e/256⌉], the blocks' runs
// into the grid + 1 ints after them, sets the kernel's shared memory and
// launches it; r = 0 for kernel 3.
int launch_chain(const float* in, const float* cw, const float* img1,
                 const float* b1, const float* img2, const float* b2,
                 const float* img3, const float* b3, float* out, float* tiles,
                 int* counts, long long e, int r, int f, int grid, void* stream) {
  const bool wide = chain_wide(f, r);
  if (grid < 1 || (wide && tiles == nullptr)) return cudaErrorInvalidValue;
  const void* kern = r > 0 ? chain_kernel<true>(wide) : chain_kernel<false>(wide);
  const size_t smem = chain_smem(f, r, wide);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (e == 0) return cudaSuccess;
  const long long nchunks = (e + kChunk - 1) / kChunk;
  if (nchunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  live_count_kernel<<<(unsigned)((nchunks + kWarps - 1) / kWarps), kTcThreads, 0,
                      st>>>(cw, e, (int)nchunks, counts);
  int* ranges = counts + nchunks;
  range_kernel<<<1, kTcThreads, 0, st>>>(counts, (int)nchunks, e, grid, ranges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  void* args[] = {&in, &cw, &img1, &b1, &img2, &b2, &img3, &b3, &out, &tiles,
                  &ranges, &e, (void*)&r, (void*)&f};
  err = cudaLaunchKernel(kern, dim3((unsigned)grid), dim3(kTcThreads), args, smem,
                         st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel 3.  pre1 [e, f]; cw [e]; w2 [f, 2f]; b2 [2f]; w3 [2f, 3f]; b3 [3f];
// out [e, 3f]; image [tmd_edge_mlp_image_floats(f)] scratch; for f > 256
// tiles [grid · tmd_edge_mlp_tile_floats(f, 0)] scratch (else null);
// counts [⌈e/256⌉ + grid + 1] int scratch.  f a multiple of 4; grid ≥ 1 blocks, at
// most one an SM resident.  W2 and W3 are split into image, each 256-slot
// chunk's live slots counted, then the kernel runs.
int tmd_edge_mlp_pre(const float* pre1, const float* cw, const float* w2,
                     const float* b2, const float* w3, const float* b3,
                     float* out, float* image, float* tiles, int* counts,
                     long long e, int f, int grid, void* stream) {
  if (f < 4 || f % 4) return cudaErrorInvalidValue;
  float* img3 = image + tc_image_floats(f, 2 * f);
  if (e > 0) {
    int rc = tc_split(w2, f, 2 * f, image, stream);
    if (rc != cudaSuccess) return rc;
    rc = tc_split(w3, 2 * f, 3 * f, img3, stream);
    if (rc != cudaSuccess) return rc;
  }
  return launch_chain(pre1, cw, nullptr, nullptr, image, b2, img3, b3, out,
                      tiles, counts, e, 0, f, grid, stream);
}

// Floats of kernel 3's image scratch at f: W2's image, then W3's.
int tmd_edge_mlp_image_floats(int f) {
  return tc_image_floats(f, 2 * f) + tc_image_floats(2 * f, 3 * f);
}

// Kernel 4.  x [e, r]; cw [e]; w1 [r, f]; b1 [f]; w2 [f, 2f]; b2 [2f];
// w3 [2f, 3f]; b3 [3f]; out [e, 3f]; image [tmd_edge_mlp_fused_image_floats
// (r, f)] scratch; in the wide form tiles [grid · tmd_edge_mlp_tile_floats
// (f, r)] scratch (else null); counts [⌈e/256⌉ + grid + 1] int scratch.
// r and f
// positive multiples of 4; grid ≥ 1 blocks.  W1, W2 and W3 are split into
// image, each chunk's live slots counted, then the kernel runs.
int tmd_edge_mlp(const float* x, const float* cw, const float* w1,
                 const float* b1, const float* w2, const float* b2,
                 const float* w3, const float* b3, float* out, float* image,
                 float* tiles, int* counts, long long e, int r, int f, int grid,
                 void* stream) {
  if (r < 4 || f < 4 || r % 4 || f % 4) return cudaErrorInvalidValue;
  float* img2 = image + tc_image_floats(r, f);
  float* img3 = img2 + tc_image_floats(f, 2 * f);
  if (e > 0) {
    int rc = tc_split(w1, r, f, image, stream);
    if (rc != cudaSuccess) return rc;
    rc = tc_split(w2, f, 2 * f, img2, stream);
    if (rc != cudaSuccess) return rc;
    rc = tc_split(w3, 2 * f, 3 * f, img3, stream);
    if (rc != cudaSuccess) return rc;
  }
  return launch_chain(x, cw, image, b1, img2, b2, img3, b3, out, tiles, counts,
                      e, r, f, grid, stream);
}

// Floats of kernel 4's image scratch at (r, f): W1's image, W2's, W3's.
int tmd_edge_mlp_fused_image_floats(int r, int f) {
  return tc_image_floats(r, f) + tmd_edge_mlp_image_floats(f);
}

// Floats of one resident block's tiles in device memory at (f, r; r = 0
// for kernel 3), or 0 where they sit in shared memory.
long long tmd_edge_mlp_tile_floats(int f, int r) {
  return chain_wide(f, r) ? chain_tile_floats(f, r) : 0;
}

// What the compiler and the launch give kernel 3 (r = 0) or kernel 4 at
// (f, r): out = registers a thread, local (spill) bytes a thread, static
// and dynamic shared memory bytes a block, resident blocks an SM.
int tmd_edge_mlp_attributes(int f, int r, int* out) {
  const bool wide = chain_wide(f, r);
  const void* kern = r > 0 ? chain_kernel<true>(wide) : chain_kernel<false>(wide);
  const size_t smem = chain_smem(f, r, wide);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kTcThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = (int)smem;
  out[4] = blocks;
  return cudaSuccess;
}

}  // extern "C"
