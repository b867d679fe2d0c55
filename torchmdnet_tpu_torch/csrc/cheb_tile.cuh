// What the Chebyshev kernels of csrc/cheb_filter.cu (rows 5-7) and
// csrc/blocked_mp.cu (rows 8-11) share: the block and tile constants and
// θ.  Their products live beside them: rows 5, 7, 10 and 11 on the tensor
// cores (csrc/tc_tile.cuh), rows 6 and 8 in fp32 FMA.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;     // live slots per tile
constexpr int kTileN = 128;    // output columns per pass
constexpr int kThreads = 256;  // threads of every block
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;        // row padding of a staged tile in smem

// θ = acos(clip(2(d − lo)/(hi − lo) − 1, −1, 1)), finite for any d: the
// clip comes before acosf.
__device__ __forceinline__ float cheb_theta(float d, float lo, float hi) {
  float x = 2.0f * (d - lo) / (hi - lo) - 1.0f;
  x = fminf(fmaxf(x, -1.0f), 1.0f);
  return acosf(x);
}

}  // namespace
