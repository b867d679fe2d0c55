// TensorNet and TensorNet2 edge MLPs for Hopper (sm_90a), fp32 FMA
// throughout (no TF32, parity with "highest").
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
// Bound, kernel 3 (N=25,088, K=96, F=128, per call, all slots):
// 2*E*(F*2F + 2F*3F) = 631 GFLOP against 4.9 GB of traffic, so fp32
// operations bound it: ~9.4 ms at the NVIDIA H100 SXM data-sheet 67 TFLOP/s
// (700 W); tensor cores would make it memory-bound at ~1.5 ms (3.35 TB/s),
// which is later work.  Kernel 4 (dhfr: N=2,560, K=64, R=32, ~97.6 k slots
// with cw != 0): 2*97.6k*(R*F + F*2F + 2F*3F) = 26 GFLOP, ~0.4 ms at
// 67 TFLOP/s, against 0.25 GB of output (~0.08 ms): operations again.
//
// Design against that bound: a block takes a tile of 64 edges and keeps
// the whole chain on chip — silu(pre1) [64 x F] and h2 [64 x 2F] live in
// shared memory and only the [64 x 3F] result is written, so the [E, 2F]
// intermediate never reaches device memory.  Both products stream their
// weight matrix through shared memory in 32-row k-tiles of 128 columns;
// each of the 256 threads accumulates a 4 x 8 register tile, reading 4 A
// and 8 B values from shared memory per 32 FMAs.  Kernel 4 puts the first
// layer in front (an x tile [64 x R] gives h1 = silu(x W1 + b1) in shared
// memory) and, as its cw = 0 slots (padding, beyond the cutoff) are ~40%
// of a dhfr list, a block owns a span of 256 slots, compacts those with
// cw != 0 in slot order and runs the chain on tiles of 64 of them only,
// writing exact zeros for the rest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 64;    // edges per block
constexpr int kTileN = 128;   // output columns per pass
constexpr int kTileK = 32;    // weight rows per shared-memory tile
constexpr int kThreads = 256; // 16 x 16 threads, each 4 rows x 8 columns
constexpr int kPad = 4;       // row padding of the activations in smem
constexpr int kSpan = kThreads;  // slots a kernel-4 block owns
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// acc[i][j] = sum_k A[row_i][k] * W[k][col_j] over k < kdim for the
// 128-column block starting at c0 (columns >= ncols read as zero).
// A is a [64 x kdim] activation in shared memory with row stride lda;
// W is [kdim x ncols] row-major in device memory.
__device__ __forceinline__ void tile_product(
    const float* __restrict__ sAct, int lda, const float* __restrict__ W,
    int kdim, int ncols, int c0, float* __restrict__ sW, float (&acc)[4][8]) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
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
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sAct[(ty * 4 + i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sW[kk * kTileN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Splits the slots [s0, s0 + kSpan) ∩ [0, E) into those with flag != 0
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

__global__ void __launch_bounds__(kThreads)
edge_mlp_pre_kernel(const float* __restrict__ pre1, const float* __restrict__ cw,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3, const float* __restrict__ b3,
                    float* __restrict__ out, long long E, int F, int F2, int F3) {
  extern __shared__ __align__(16) float smem[];
  const int lda = F + kPad, ldh = F2 + kPad;
  float* sA = smem;                  // [64][F + pad]   silu(pre1)
  float* sH = sA + kTileM * lda;     // [64][2F + pad]  h2
  float* sW = sH + kTileM * ldh;     // [32][128]       weight tile

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long e0 = (long long)blockIdx.x * kTileM;

  // silu(pre1) tile; rows past E are zero
  const int f4 = F / 4;
  for (int v = tid; v < kTileM * f4; v += kThreads) {
    const int row = v / f4, col = (v % f4) * 4;
    float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (e0 + row < E) {
      p = *reinterpret_cast<const float4*>(pre1 + (e0 + row) * F + col);
      p.x = silu(p.x);
      p.y = silu(p.y);
      p.z = silu(p.z);
      p.w = silu(p.w);
    }
    float* dst = sA + row * lda + col;
    dst[0] = p.x;
    dst[1] = p.y;
    dst[2] = p.z;
    dst[3] = p.w;
  }

  float acc[4][8];
  // h2 = silu(sA W2 + b2) into shared memory
  for (int c0 = 0; c0 < F2; c0 += kTileN) {
    tile_product(sA, lda, w2, F, F2, c0, sW, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < F2) {
        const float bias = b2[col];
#pragma unroll
        for (int i = 0; i < 4; ++i) sH[(ty * 4 + i) * ldh + col] = silu(acc[i][j] + bias);
      }
    }
  }
  // out = silu(h2 W3 + b3) * cw, one 128-column block at a time
  for (int c0 = 0; c0 < F3; c0 += kTileN) {
    tile_product(sH, ldh, w3, F2, F3, c0, sW, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long e = e0 + ty * 4 + i;
      if (e >= E) continue;
      const float c = cw[e];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < F3) out[e * F3 + col] = silu(acc[i][j] + b3[col]) * c;
      }
    }
  }
}

// Kernel 4: the three-layer chain on the slots with cw != 0.
__global__ void __launch_bounds__(kThreads)
edge_mlp_kernel(const float* __restrict__ x, const float* __restrict__ cw,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ w3, const float* __restrict__ b3,
                float* __restrict__ out, long long E, int R, int F, int F2,
                int F3) {
  extern __shared__ __align__(16) float smem[];
  const int ldx = R + kPad, lda = F + kPad, ldh = F2 + kPad;
  float* sX = smem;                  // [64][R + pad]   x
  float* sA = sX + kTileM * ldx;     // [64][F + pad]   h1
  float* sH = sA + kTileM * lda;     // [64][2F + pad]  h2
  float* sW = sH + kTileM * ldh;     // [32][128]       weight tile
  float* sCw = sW + kTileK * kTileN; // [64]
  int* sLive = reinterpret_cast<int*>(sCw + kTileM);  // [kSpan]
  int* sDead = sLive + kSpan;                          // [kSpan]
  int* sCount = sDead + kSpan;                         // [2 * kWarps]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long s0 = (long long)blockIdx.x * kSpan;
  int ndead;
  const int nlive = compact_span(cw, s0, E, sLive, sDead, sCount, &ndead);

  // slots with cw = 0: exact zeros, no arithmetic
  const int c4 = F3 / 4;
  for (int v = tid; v < ndead * c4; v += kThreads) {
    const long long e = s0 + sDead[v / c4];
    reinterpret_cast<float4*>(out + e * F3)[v % c4] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  float acc[4][8];
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
      tile_product(sX, ldx, w1, R, F, c0, sW, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < F) {
          const float bias = b1[col];
#pragma unroll
          for (int i = 0; i < 4; ++i) sA[(ty * 4 + i) * lda + col] = silu(acc[i][j] + bias);
        }
      }
    }
    // h2 = silu(h1 W2 + b2)
    for (int c0 = 0; c0 < F2; c0 += kTileN) {
      tile_product(sA, lda, w2, F, F2, c0, sW, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col < F2) {
          const float bias = b2[col];
#pragma unroll
          for (int i = 0; i < 4; ++i) sH[(ty * 4 + i) * ldh + col] = silu(acc[i][j] + bias);
        }
      }
    }
    // out = silu(h2 W3 + b3) * cw
    for (int c0 = 0; c0 < F3; c0 += kTileN) {
      tile_product(sH, ldh, w3, F2, F3, c0, sW, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty * 4 + i;
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

}  // namespace

extern "C" {

const char* tmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// pre1 [e, f]; cw [e]; w2 [f, 2f]; b2 [2f]; w3 [2f, 3f]; b3 [3f]; out [e, 3f].
// f must be a multiple of 4.
int tmd_edge_mlp_pre(const float* pre1, const float* cw, const float* w2,
                     const float* b2, const float* w3, const float* b3,
                     float* out, long long e, int f, void* stream) {
  const int f2 = 2 * f, f3 = 3 * f;
  const size_t smem = sizeof(float) * ((size_t)kTileM * (f + kPad) +
                                       (size_t)kTileM * (f2 + kPad) +
                                       (size_t)kTileK * kTileN);
  cudaError_t err = cudaFuncSetAttribute(
      edge_mlp_pre_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (e + kTileM - 1) / kTileM;
  if (blocks == 0) return cudaSuccess;
  edge_mlp_pre_kernel<<<(unsigned)blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      pre1, cw, w2, b2, w3, b3, out, e, f, f2, f3);
  return cudaGetLastError();
}

// Kernel 4.  x [e, r]; cw [e]; w1 [r, f]; b1 [f]; w2 [f, 2f]; b2 [2f];
// w3 [2f, 3f]; b3 [3f]; out [e, 3f].  r and f multiples of 4.
int tmd_edge_mlp(const float* x, const float* cw, const float* w1,
                 const float* b1, const float* w2, const float* b2,
                 const float* w3, const float* b3, float* out, long long e,
                 int r, int f, void* stream) {
  const int f2 = 2 * f, f3 = 3 * f;
  const size_t smem = sizeof(float) * ((size_t)kTileM * (r + kPad) +
                                       (size_t)kTileM * (f + kPad) +
                                       (size_t)kTileM * (f2 + kPad) +
                                       (size_t)kTileK * kTileN + kTileM) +
                      sizeof(int) * (2 * kSpan + 2 * kWarps);
  cudaError_t err = cudaFuncSetAttribute(
      edge_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (e + kSpan - 1) / kSpan;
  if (blocks == 0) return cudaSuccess;
  edge_mlp_kernel<<<(unsigned)blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      x, cw, w1, b1, w2, b2, w3, b3, out, e, r, f, f2, f3);
  return cudaGetLastError();
}

}  // extern "C"
