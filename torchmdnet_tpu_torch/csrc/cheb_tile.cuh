// The Chebyshev basis and the SIMT tile product of csrc/cheb_filter.cu
// (Pallas rows 5 and 7): fp32 FMA throughout, no TF32.  csrc/blocked_mp.cu
// takes its tile constants (row 8) and cheb_theta (rows 10 and 11, whose
// product is csrc/tc_tile.cuh's).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;     // live slots per tile
constexpr int kTileN = 128;    // output columns per pass
constexpr int kTileK = 32;     // series rows per shared-memory tile
constexpr int kThreads = 256;  // 16 x 16 threads, each 4 rows x 8 columns
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;        // row padding of the basis in smem

// acc[i][j] = Σ_k A[row_i][k]·W[k][col_j] over k < kdim for the 128-column
// block starting at c0 (columns >= ncols read as zero).  A is a [64 x kdim]
// shared-memory array with row stride lda; W is [kdim x ncols] row-major in
// device memory.  The same product as csrc/edge_mlp.cu.
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

// θ = acos(clip(2(d − lo)/(hi − lo) − 1, −1, 1)), finite for any d: the
// clip comes before acosf.
__device__ __forceinline__ float cheb_theta(float d, float lo, float hi) {
  float x = 2.0f * (d - lo) / (hi - lo) - 1.0f;
  x = fminf(fmaxf(x, -1.0f), 1.0f);
  return acosf(x);
}

// sB[r][j] = cos(j·θ_r) for the 64 rows of a tile and j < T — cosf with full
// range reduction, since j·θ reaches (T − 1)π; never __cosf or fast math.
__device__ __forceinline__ void fill_basis(float* __restrict__ sB, int ldb,
                                           const float* __restrict__ sTheta,
                                           int T) {
  for (int v = threadIdx.x; v < kTileM * T; v += kThreads) {
    const int r = v / T, j = v % T;
    sB[r * ldb + j] = cosf((float)j * sTheta[r]);
  }
}

}  // namespace
