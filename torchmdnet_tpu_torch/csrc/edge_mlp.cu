// TensorNet and TensorNet2 edge MLPs for Hopper (sm_90a), float32-accurate:
// kernel 3 forms its two products on the tensor cores in 3xTF32
// (csrc/tc_tile.cuh; never single-pass TF32), kernel 4 in fp32 FMA.
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
// Bound, kernel 3 (the north star's gather path: N=25,088, K=96 slots at
// 4.5 Å + 1 Å skin, F=128, 924,946 of the 2,408,448 slots with cw != 0,
// per call; H100 SXM data sheet at 700 W: 495 TFLOP/s TF32 on the tensor
// cores, 3.35 TB/s): the live slots' products are 2*live*(F*2F + 2F*3F)
// = 242 GFLOP, three TF32 products each in 3xTF32, ~1.47 ms; the live
// rows of pre1, cw and the whole [E, 3F] output, zeros included, are
// 4.2 GB, ~1.25 ms: operations bound it, bytes close behind.  Kernel 4
// (dhfr: N=2,560, K=64, R=32, ~97.6 k slots with cw != 0):
// 2*97.6k*(R*F + F*2F + 2F*3F) = 26 GFLOP, ~0.4 ms at the fp32 rate of
// 67 TFLOP/s, against 0.25 GB of output (~0.08 ms): operations.
//
// Kernel 3's design against its bound (edge_mlp_pre_kernel): a block owns
// a span of kPreSpan = 1024 slots (~393 live on the gather MD list: six
// full 64-slot tiles and a partial one, 12% of the tiles' rows empty,
// where 256-slot spans leave 23%), compacts those with cw != 0 in slot
// order and writes exact zeros for the rest (whole [3F] rows of float4
// stores), so only live slots reach the tensor cores.  Per tile of 64
// live slots it keeps the whole chain on chip: sA = silu(pre1) [64 x F]
// from float4 loads of the live rows; two 128-column passes of sA W2
// (tc_product_from: W2 split once per launch into hi/lo planes streamed
// through a cp.async ring, A fragments read from sA) whose epilogues put
// silu(acc + b2) from the fragments into the h2 tile sH [64 x 2F + 4];
// then three passes of sH W3 whose epilogues put silu(acc + b3) * cw into
// the free ring as a [64 x kTcLdW] tile, stored with coalesced float4
// stores per live slot.  sA lives in sH's last F columns, which the last
// layer-1 pass writes after its product has read them.  The [E, 2F]
// intermediate never reaches device memory, and there are no atomics:
// the same result on every run.  The ring (48 KB), sH (66.5 KB) and the
// span's lists (8 KB) make 125,248 B at F = 128, so one block of 8 warps
// runs an SM.  Above F = 256 (the wide form) h2 and silu(pre1) do not
// fit a block: each resident block keeps them apart in its region of a
// device-memory scratch the wrapper allocates (the grid is one block an
// SM, walking the spans), and tc_product_from reads its A fragments
// there; no pass is held.

// Kernel 4's design: a block takes a tile of 64 edges and keeps the chain
// on chip the same way, on fp32 FMA: both products stream their weight
// matrix through shared memory in 32-row k-tiles of 128 columns; each of
// the 256 threads accumulates a 4 x 8 register tile, reading 4 A and 8 B
// values from shared memory per 32 FMAs.  The first layer comes in front
// (an x tile [64 x R] gives h1 = silu(x W1 + b1) in shared memory) and, as
// its cw = 0 slots (padding, beyond the cutoff) are ~40% of a dhfr list,
// a block owns a span of 256 slots, compacts those with cw != 0 and runs
// the chain on tiles of 64 of them only, writing exact zeros for the rest.
// Where 64 rows of the x, h1 and h2 tiles pass a block's 232,448 B (R =
// 64, F = 256 needs 234,816 B), the tiles take 32 rows, or 16.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

constexpr int kTileN = 128;   // output columns per pass
constexpr int kTileK = 32;    // weight rows per shared-memory tile
constexpr int kThreads = 256; // 16 x 16 threads, each RM rows x 8 columns
constexpr int kPad = 4;       // row padding of the activations in smem
constexpr int kSpan = kThreads;  // slots a kernel-4 block owns
constexpr int kPreSpan = 1024;   // slots a kernel-3 block owns
constexpr int kWarps = kThreads / 32;
static_assert(kThreads == kTcThreads, "one launch width for every kernel");
static_assert(kPreSpan % kThreads == 0, "a span is whole compaction rounds");

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// acc[i][j] = sum_k A[row_i][k] * W[k][col_j] over k < kdim for the
// 128-column block starting at c0 (columns >= ncols read as zero).
// A is a [16·RM x kdim] activation in shared memory with row stride lda;
// W is [kdim x ncols] row-major in device memory.
template <int RM>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ sAct, int lda, const float* __restrict__ W,
    int kdim, int ncols, int c0, float* __restrict__ sW, float (&acc)[RM][8]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < kdim; k0 += kTileK) {
    __syncthreads();  // previous tile fully consumed
    // load W[k0 : k0+32, c0 : c0+128] as 1024 float4s, 4 per thread
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = tid + kThreads * q;
      const int row = v / (kTileN / 4), col = (v % (kTileN / 4)) * 4;
      float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k0 + row < kdim && c0 + col < ncols)
        w = *reinterpret_cast<const float4*>(W + (long long)(k0 + row) * ncols + c0 + col);
      *reinterpret_cast<float4*>(sW + row * kTileN + col) = w;
    }
    __syncthreads();
    const int kt = min(kTileK, kdim - k0);
    for (int kk = 0; kk < kt; ++kk) {
      float a[RM], b[8];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = sAct[(ty * RM + i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sW[kk * kTileN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Splits the slots [s0, s0 + kLen) ∩ [0, E) into those with flag != 0
// (sLive) and the rest (sDead), each in slot order, as offsets from s0,
// kThreads slots a round.  Returns the live count; *ndead gets the
// other.  Every thread calls it.
template <int kLen>
__device__ __forceinline__ int compact_span(const float* __restrict__ flag,
                                            long long s0, long long E,
                                            int* sLive, int* sDead,
                                            int* sCount, int* ndead) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int nlive = 0, nin = 0;
#pragma unroll 1
  for (int c0 = 0; c0 < kLen; c0 += kThreads) {
    const bool in = s0 + c0 + tid < E;
    const bool live = in && flag[s0 + c0 + tid] != 0.0f;
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
      sLive[lrank] = c0 + tid;
    else if (in)
      sDead[irank - lrank] = c0 + tid;
    __syncthreads();  // the lists are whole; sCount is read
  }
  *ndead = nin - nlive;
  return nlive;
}

// Kernel 3's h2 tile [64][ldh] in the narrow form (F ≤ 256): 2F
// columns, and silu(pre1) [64][F] in the columns [a0, a0 + F) of the same
// rows, a0 = 128·(P − Q) for P = ⌈2F/128⌉ layer-1 passes and Q = ⌈F/128⌉
// ≤ 2: the first P − Q passes write below a0, the last writes over
// silu(pre1) after the last read of it, and with Q = 2 the one before it
// keeps its result in registers until then.
__host__ __device__ __forceinline__ int pre_a0(int f) {
  return kTcN * ((2 * f + kTcN - 1) / kTcN - (f + kTcN - 1) / kTcN);
}
__host__ __device__ __forceinline__ int pre_ldh(int f) {
  return max(2 * f, pre_a0(f) + f) + kPad;
}
constexpr int kPreMaxNarrowF = 2 * kTcN;
// Floats of a block's tiles in the wide form (F > 256), in device
// memory: h2 [64][2F + 4] and silu(pre1) [64][F + 4], apart (no pass is
// held).
__host__ __device__ __forceinline__ long long pre_tile_floats(int f) {
  return (long long)kTcM * (3 * f + 2 * kPad);
}

// Kernel 3's product of layer pass p with the activation act [64][lda]
// as A; it synchronises first (act is written, sR free) and last.  The
// wide form sums each stage apart and adds it in fp32 (kStageSums, as
// rows 5 and 7 do): its sums over K = F and 2F run past 512 terms.
template <bool kStageSums>
__device__ __forceinline__ void pre_product(const float* act, int lda,
                                            const float* __restrict__ img,
                                            int kdim, int p, float* sR,
                                            float (&acc)[8][4]) {
  __syncthreads();
  tc_product_from<kStageSums>(
      TcActivation{act + tc_row(0) * lda, act + tc_row(1) * lda, kdim}, img,
      kdim, p, sR, acc);
}

// Kernel 3.  img2, img3: the split images of W2 [F, 2F] and W3 [2F, 3F].
// Block b owns the spans b, b + grid, … of kPreSpan slots below E: one
// span each in the narrow form, whose tiles sit in shared memory; in the
// wide form (F > 256) the grid is one block an SM, each with its
// pre_tile_floats of tiles.
template <bool kWide>
__global__ void __launch_bounds__(kTcThreads, 1)
edge_mlp_pre_kernel(const float* __restrict__ pre1, const float* __restrict__ cw,
                    const float* __restrict__ img2, const float* __restrict__ b2,
                    const float* __restrict__ img3, const float* __restrict__ b3,
                    float* __restrict__ out, float* tiles, long long E, int F,
                    int F2, int F3) {
  extern __shared__ __align__(16) float smem[];
  const int ldh = kWide ? F2 + kPad : pre_ldh(F);
  const int lda = kWide ? F + kPad : ldh;
  float* sR = smem + tc_region_offset(smem);  // the ring, then the out tile
  float* sH;                                  // [64][ldh]  h2
  float* sA;                                  // [64][lda]  silu(pre1)
  float* sCw;                                 // [64]
  if constexpr (kWide) {
    sH = tiles + (long long)blockIdx.x * pre_tile_floats(F);
    sA = sH + kTcM * ldh;
    sCw = sR + kTcRegion;
  } else {
    sH = sR + kTcRegion;
    sA = sH + pre_a0(F);
    sCw = sH + kTcM * ldh;
  }
  int* sLive = reinterpret_cast<int*>(sCw + kTcM);  // [kPreSpan]
  int* sDead = sLive + kPreSpan;                    // [kPreSpan]
  int* sCount = sDead + kPreSpan;                   // [2 * kWarps]

  const int tid = threadIdx.x;
  const long long nspans = (E + kPreSpan - 1) / kPreSpan;
  // h2 = silu(acc + b2) of layer-1 pass p from the fragments into sH
  auto store_h2 = [&](const float (&acc)[8][4], int p) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = p * kTcN + tc_col(i);  // even; F2 is a multiple of 8
      if (col >= F2) continue;
      const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(sH + tc_row(h) * ldh + col) =
            make_float2(silu(acc[i][2 * h] + bias.x),
                        silu(acc[i][2 * h + 1] + bias.y));
    }
  };
  const int f4 = F / 4;
  const int npass = (F2 + kTcN - 1) / kTcN;
  const bool hold = !kWide && (F + kTcN - 1) / kTcN == 2;
  float acc[8][4], held[8][4];
  for (long long span = blockIdx.x; span < nspans; span += gridDim.x) {
  const long long s0 = span * kPreSpan;
  int ndead;
  const int nlive = compact_span<kPreSpan>(cw, s0, E, sLive, sDead, sCount, &ndead);

  // slots with cw = 0: exact zeros, no arithmetic
  const int c4 = F3 / 4;
  for (int v = tid; v < ndead * c4; v += kTcThreads)
    reinterpret_cast<float4*>(out + (s0 + sDead[v / c4]) * F3)[v % c4] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int t0 = 0; t0 < nlive; t0 += kTcM) {
    const int nt = min(kTcM, nlive - t0);
    // silu(pre1) of the tile's live slots; the rows past nt are zeros
    for (int v = tid; v < kTcM * f4; v += kTcThreads) {
      const int r = v / f4, col = (v - r * f4) * 4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < nt) {
        x = *reinterpret_cast<const float4*>(pre1 + (s0 + sLive[t0 + r]) * F + col);
        x = make_float4(silu(x.x), silu(x.y), silu(x.z), silu(x.w));
      }
      *reinterpret_cast<float4*>(sA + r * lda + col) = x;
    }
    if (tid < kTcM) sCw[tid] = tid < nt ? cw[s0 + sLive[t0 + tid]] : 0.0f;

    // h2 = silu(silu(pre1) W2 + b2)
    for (int p = 0; p < npass; ++p) {
      pre_product<kWide>(sA, lda, img2, F, p, sR, acc);  // syncs first, last
      if (hold && p == npass - 2) {  // it would overwrite what pass p + 1 reads
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) held[i][e] = acc[i][e];
        continue;
      }
      store_h2(acc, p);
      if (hold && p == npass - 1) store_h2(held, p - 1);
    }
    // out = silu(h2 W3 + b3) * cw, one 128-column pass at a time
    for (int p = 0; p * kTcN < F3; ++p) {
      const int c0 = p * kTcN;
      pre_product<kWide>(sH, ldh, img3, F2, p, sR, acc);  // syncs first, last
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
  __syncthreads();  // the span's lists, sCw and the out tile are read
  }
}

// Kernel 4: the three-layer chain on the slots with cw != 0, in tiles of
// kTileM = 16·RM of them (64; 32 or 16 where 64 rows of the x, h1 and h2
// tiles do not fit a block, fused_smem): each output's sums in the same
// order at every tile size.
template <int RM>
__global__ void __launch_bounds__(kThreads)
edge_mlp_kernel(const float* __restrict__ x, const float* __restrict__ cw,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ w3, const float* __restrict__ b3,
                float* __restrict__ out, long long E, int R, int F, int F2,
                int F3) {
  constexpr int kTileM = 16 * RM;
  extern __shared__ __align__(16) float smem[];
  const int ldx = R + kPad, lda = F + kPad, ldh = F2 + kPad;
  float* sX = smem;                  // [RM·16][R + pad]   x
  float* sA = sX + kTileM * ldx;     // [RM·16][F + pad]   h1
  float* sH = sA + kTileM * lda;     // [RM·16][2F + pad]  h2
  float* sW = sH + kTileM * ldh;     // [32][128]       weight tile
  float* sCw = sW + kTileK * kTileN; // [RM·16]
  int* sLive = reinterpret_cast<int*>(sCw + kTileM);  // [kSpan]
  int* sDead = sLive + kSpan;                          // [kSpan]
  int* sCount = sDead + kSpan;                         // [2 * kWarps]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long s0 = (long long)blockIdx.x * kSpan;
  int ndead;
  const int nlive = compact_span<kSpan>(cw, s0, E, sLive, sDead, sCount, &ndead);

  // slots with cw = 0: exact zeros, no arithmetic
  const int c4 = F3 / 4;
  for (int v = tid; v < ndead * c4; v += kThreads) {
    const long long e = s0 + sDead[v / c4];
    reinterpret_cast<float4*>(out + e * F3)[v % c4] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  float acc[RM][8];
  const int r4 = R / 4;
  for (int t0 = 0; t0 < nlive; t0 += kTileM) {
    __syncthreads();  // the previous tile's x, cw and h2 are consumed
    for (int v = tid; v < kTileM * r4; v += kThreads) {
      const int row = v / r4, col = (v % r4) * 4;
      float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (t0 + row < nlive)
        p = *reinterpret_cast<const float4*>(
            x + (s0 + sLive[t0 + row]) * R + col);
      float* dst = sX + row * ldx + col;
      dst[0] = p.x;
      dst[1] = p.y;
      dst[2] = p.z;
      dst[3] = p.w;
    }
    if (tid < kTileM)
      sCw[tid] = t0 + tid < nlive ? cw[s0 + sLive[t0 + tid]] : 0.0f;
    // h1 = silu(x W1 + b1)
    for (int c0 = 0; c0 < F; c0 += kTileN) {
      tile_product<RM>(sX, ldx, w1, R, F, c0, sW, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < F) {
          const float bias = b1[col];
#pragma unroll
          for (int i = 0; i < RM; ++i) sA[(ty * RM + i) * lda + col] = silu(acc[i][j] + bias);
        }
      }
    }
    // h2 = silu(h1 W2 + b2)
    for (int c0 = 0; c0 < F2; c0 += kTileN) {
      tile_product<RM>(sA, lda, w2, F, F2, c0, sW, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < F2) {
          const float bias = b2[col];
#pragma unroll
          for (int i = 0; i < RM; ++i) sH[(ty * RM + i) * ldh + col] = silu(acc[i][j] + bias);
        }
      }
    }
    // out = silu(h2 W3 + b3) * cw
    for (int c0 = 0; c0 < F3; c0 += kTileN) {
      tile_product<RM>(sH, ldh, w3, F2, F3, c0, sW, acc);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = ty * RM + i;
        if (t0 + row >= nlive) continue;
        const long long e = s0 + sLive[t0 + row];
        const float c = sCw[row];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + tx + 16 * j;
          if (col < F3) out[e * F3 + col] = silu(acc[i][j] + b3[col]) * c;
        }
      }
    }
  }
}

// Dynamic shared memory of a kernel-3 launch at f (ops/edge_mlp.py::
// pre_smem keeps the same sum): 1 KB to align the region, the region (the
// ring, then the out tile), in the narrow form the h2 tile that also
// holds silu(pre1), cw, then the span's live and dead offsets and the
// warp counts.
size_t pre_smem(int f) {
  const bool wide = f > kPreMaxNarrowF;
  const size_t tiles = wide ? 0 : (size_t)kTcM * pre_ldh(f);
  return 1024 +
         sizeof(float) * ((size_t)kTcRegion + tiles + kTcM) +
         sizeof(int) * (2 * kPreSpan + 2 * kWarps);
}

const void* pre_kernel(int f) {
  return f > kPreMaxNarrowF ? (const void*)edge_mlp_pre_kernel<true>
                            : (const void*)edge_mlp_pre_kernel<false>;
}

// Dynamic shared memory of a kernel-4 launch at (r, f) with tiles of rows
// slots (ops/edge_mlp.py::fused_smem keeps the same sum): the x, h1 and h2
// tiles, the weight tile, cw, then the span's live and dead offsets and the
// warp counts.
size_t fused_smem(int r, int f, int rows) {
  return sizeof(float) * ((size_t)rows * (r + kPad) + (size_t)rows * (f + kPad) +
                          (size_t)rows * (2 * f + kPad) +
                          (size_t)kTileK * kTileN + rows) +
         sizeof(int) * (2 * kSpan + 2 * kWarps);
}

}  // namespace

extern "C" {

const char* tmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel 3.  pre1 [e, f]; cw [e]; w2 [f, 2f]; b2 [2f]; w3 [2f, 3f]; b3 [3f];
// out [e, 3f]; image [tmd_edge_mlp_image_floats(f)] scratch; for f > 256
// tiles [grid · tmd_edge_mlp_tile_floats(f)] scratch (else null).  grid:
// the spans' count ⌈e/1024⌉, or for f > 256 at most that.  f a multiple
// of 4.  W2 and W3 are split into image, then the kernel runs.
int tmd_edge_mlp_pre(const float* pre1, const float* cw, const float* w2,
                     const float* b2, const float* w3, const float* b3,
                     float* out, float* image, float* tiles, long long e,
                     int f, int grid, void* stream) {
  if (f < 4 || f % 4 || grid < 1) return cudaErrorInvalidValue;
  if (f > kPreMaxNarrowF && tiles == nullptr) return cudaErrorInvalidValue;
  const int f2 = 2 * f, f3 = 3 * f;
  const void* kern = pre_kernel(f);
  const size_t smem = pre_smem(f);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (e == 0) return cudaSuccess;
  float* img3 = image + tc_image_floats(f, f2);
  int rc = tc_split(w2, f, f2, image, stream);
  if (rc != cudaSuccess) return rc;
  rc = tc_split(w3, f2, f3, img3, stream);
  if (rc != cudaSuccess) return rc;
  const float* img2 = image;
  void* args[] = {&pre1, &cw, &img2, &b2, &img3, &b3, &out, &tiles, &e,
                  (void*)&f, (void*)&f2, (void*)&f3};
  err = cudaLaunchKernel(kern, dim3((unsigned)grid), dim3(kTcThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Floats of kernel 3's image scratch at f: W2's image, then W3's.
int tmd_edge_mlp_image_floats(int f) {
  return tc_image_floats(f, 2 * f) + tc_image_floats(2 * f, 3 * f);
}

// Floats of one resident kernel-3 block's tiles in device memory (0 for
// f ≤ 256).
long long tmd_edge_mlp_tile_floats(int f) {
  return f > kPreMaxNarrowF ? pre_tile_floats(f) : 0;
}

// What the compiler and the launch give kernel 3 at f: out = registers a
// thread, local (spill) bytes a thread, static and dynamic shared memory
// bytes a block, resident blocks an SM.
int tmd_edge_mlp_attributes(int f, int* out) {
  const void* kern = pre_kernel(f);
  const size_t smem = pre_smem(f);
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

// Kernel 4.  x [e, r]; cw [e]; w1 [r, f]; b1 [f]; w2 [f, 2f]; b2 [2f];
// w3 [2f, 3f]; b3 [3f]; out [e, 3f].  r and f multiples of 4.  Tiles of
// 64 slots, or the largest of 32 and 16 whose plan fits a block.
int tmd_edge_mlp(const float* x, const float* cw, const float* w1,
                 const float* b1, const float* w2, const float* b2,
                 const float* w3, const float* b3, float* out, long long e,
                 int r, int f, void* stream) {
  if (r < 4 || f < 4 || r % 4 || f % 4) return cudaErrorInvalidValue;
  int rows = 64;
  while (rows > 16 && fused_smem(r, f, rows) > 232448) rows /= 2;
  const void* kern = rows == 64 ? (const void*)edge_mlp_kernel<4>
                   : rows == 32 ? (const void*)edge_mlp_kernel<2>
                                : (const void*)edge_mlp_kernel<1>;
  const int f2 = 2 * f, f3 = 3 * f;
  const size_t smem = fused_smem(r, f, rows);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (e + kSpan - 1) / kSpan;
  if (blocks == 0) return cudaSuccess;
  void* args[] = {&x, &cw, &w1, &b1, &w2, &b2, &w3, &b3, &out, &e,
                  (void*)&r, (void*)&f, (void*)&f2, (void*)&f3};
  err = cudaLaunchKernel(kern, dim3((unsigned)blocks), dim3(kThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
