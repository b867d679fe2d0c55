// What the Chebyshev kernels of csrc/cheb_filter.cu (rows 5-7) and
// csrc/blocked_mp.cu (rows 8-11) share: the block constants and θ.  Their
// products live beside them: rows 5-7, 10 and 11 on the tensor cores
// (csrc/tc_tile.cuh), rows 8 and 9 in fp32 FMA.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTileN = 128;    // channels a row 8 or 9 warp owns
constexpr int kThreads = 256;  // threads of every block
constexpr int kWarps = kThreads / 32;

// θ = acos(clip(2(d − lo)/(hi − lo) − 1, −1, 1)), finite for any d: the
// clip comes before acosf.
__device__ __forceinline__ float cheb_theta(float d, float lo, float hi) {
  float x = 2.0f * (d - lo) / (hi - lo) - 1.0f;
  x = fminf(fmaxf(x, -1.0f), 1.0f);
  return acosf(x);
}

}  // namespace
