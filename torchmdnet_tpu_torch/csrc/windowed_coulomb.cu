// Windowed direct-pair reaction-field Coulomb for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernels of torchmdnet_tpu/ops/pallas_coulomb.py:
//   kernel C  _wc_fwd_kernel (:280, pallas_call :407)
//     Φ[i, c] = Σ_j G(d_ij)·b[j, c]
//   kernel D  _wc_bwd_kernel (:297, pallas_call :446)
//     S2[i, c] = Σ_j G(d_ij)·ct[j]·b[j, c]
//     dpos[i]  = Σ_j G'(d_ij)·pd_ij·(ct[i] + ct[j])/d_ij·Δ_ij,
//     pd_ij    = Σ_c qw[c]·b[i, c]·b[j, c]
// for the real rows i of each cell block, over the partner rows j of the
// block's exact stencil-window pieces (ops/cell_blocks.py) that are real
// atoms with 0 < d² (> 1e-12) and d < rc, Δ_ij the minimum-image delta
// (one rint per axis, as _pair_geometry :258-277 computes it), and
// G(d) = factor·(1 − f_exp(d))·(1/d + k_rf·d² − c_rf).  Ghost rows get 0.
//
// What the TPU kernels do that this one does not: DMA whole 8-row-floored
// runs and mask them with a per-slot window mask, bf16 hi/lo MXU passes.
// Here a block reads exactly its pieces' rows.
//
// Bound (north star, per call: 27,024 sorted rows in 1,689 blocks of 16,
// C = 48, ±2-column stencil, ~2,340 partner rows a block): ~61 M candidate
// pairs, each needing ~20 FLOP of geometry; only the ~14 M pairs inside
// 11 Å need G and the channel FMAs (kernel C ~136 FLOP, kernel D ~262 with
// pd, S2 and dpos).  That is ~3.1 / ~4.9 GFLOP, ~0.05 / ~0.07 ms at the
// H100 SXM data-sheet 67 TFLOP/s (700 W); reading each input once takes
// far less.  This kernel runs the Φ/S2 FMAs on every staged pair (G = 0
// outside rc) and re-reads partner rows per block, mostly from L2.
//
// Design: one block of 256 threads per cell block.  Partner rows are
// staged through shared memory 128 at a time (row = x, y, z, ct, b[0..C));
// 16 threads per block row evaluate the pair geometry and G into a
// [16 x 128] plane (kernel D also folds dpos there, in registers), then 16
// threads per row accumulate Φ (or S2) over the plane with the channels on
// the lanes.  Every sum runs in a fixed order: no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsG = 16;     // block rows per pass
constexpr int kP = 128;        // partner rows per staged tile
constexpr int kMaxCg = 8;      // channels per thread: C <= 128
constexpr int kMaxPieces = 2 * 121;  // two pieces per stencil column, S <= 5
constexpr float kDampRc = 4.6f;
constexpr float kInvE = 0.36787944117144233f;

struct WParams {
  const float* src;         // [n_pad, ld]: x, y, z, ct, b[0..c)
  const long long* a1;      // [n_blocks, nsc] piece bounds
  const long long* e1;
  const long long* a2;
  const long long* e2;
  const uint8_t* row_valid; // [n_pad]
  const float* qw;          // [c] (kernel D)
  float* out;               // [n_pad, c]: Φ (C) or S2 (D)
  float* dpos;              // [n_pad, 3] (D)
  int cap, nsc, c, ld;
  float bx, by, bz, rc2, k_rf, c_rf, factor;
};

// G(d) and G'(d) as ops/coulomb.py::g_and_grad computes them.
__device__ __forceinline__ void g_and_grad(float d, const WParams& p, float& g,
                                           float& gp) {
  const float t_raw = d / kDampRc;
  const bool inside = t_raw > 0.0f && t_raw < 1.0f - 1e-6f;
  const float t = fminf(fmaxf(t_raw, 0.0f), 1.0f - 1e-6f);
  const float one_m = 1.0f - t * t;
  const float fexp = expf(-1.0f / one_m) / kInvE;
  const float dfexp = inside ? fexp * (-2.0f * t / (one_m * one_m)) / kDampRc : 0.0f;
  const float h = 1.0f / d + p.k_rf * d * d - p.c_rf;
  const float dh = -1.0f / (d * d) + 2.0f * p.k_rf * d;
  g = p.factor * (1.0f - fexp) * h;
  gp = p.factor * ((1.0f - fexp) * dh - dfexp * h);
}

__device__ __forceinline__ float wrap(float dc, float b) {
  return dc - b * rintf(dc * (1.0f / b));
}

template <bool BWD>
__global__ void __launch_bounds__(kThreads) wc_kernel(WParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long sStart[kMaxPieces];
  __shared__ int sOff[kMaxPieces + 1];
  __shared__ int sRowIdx[kP];
  const int ldp = p.ld + 1;           // odd stride: conflict-free columns
  float* sPart = smem;                // [kP][ldp] partner rows
  float* sRowD = sPart + kP * ldp;    // [16][ldp] block rows
  float* sG = sRowD + kRowsG * ldp;   // [16][kP + 1] G (·ct_j in D)
  float* sWb = sG + kRowsG * (kP + 1);  // [16][c] qw ⊙ b_i (D)

  const int tid = threadIdx.x;
  const int i = tid / 16, lane = tid % 16;
  const long long blk = blockIdx.x;
  const int npieces = 2 * p.nsc;
  if (tid == 0) {
    int off = 0;
    for (int q = 0; q < npieces; ++q) {
      const long long* a = q < p.nsc ? p.a1 : p.a2;
      const long long* e = q < p.nsc ? p.e1 : p.e2;
      const int s = q % p.nsc;
      const long long lo = a[blk * p.nsc + s], hi = e[blk * p.nsc + s];
      sStart[q] = lo;
      sOff[q] = off;
      off += hi > lo ? (int)(hi - lo) : 0;
    }
    sOff[npieces] = off;
  }
  __syncthreads();
  const int total = sOff[npieces];
  const int mc = (p.c + 15) / 16;

  for (int rg = 0; rg < p.cap; rg += kRowsG) {
    const long long row0 = blk * p.cap + rg;
    const int nr = min(kRowsG, p.cap - rg);
    for (int v = tid; v < kRowsG * p.ld; v += kThreads) {
      const int r = v / p.ld, col = v % p.ld;
      sRowD[r * ldp + col] = r < nr ? p.src[(row0 + r) * p.ld + col] : 0.0f;
    }
    __syncthreads();
    if (BWD)
      for (int v = tid; v < kRowsG * p.c; v += kThreads) {
        const int r = v / p.c, c = v % p.c;
        sWb[r * p.c + c] = p.qw[c] * sRowD[r * ldp + 4 + c];
      }
    const bool row_ok = i < nr && p.row_valid[row0 + i];
    const float px = sRowD[i * ldp], py = sRowD[i * ldp + 1],
                pz = sRowD[i * ldp + 2], cti = sRowD[i * ldp + 3];
    float acc[kMaxCg];
#pragma unroll
    for (int m = 0; m < kMaxCg; ++m) acc[m] = 0.0f;
    float ax = 0.0f, ay = 0.0f, az = 0.0f;

    for (int t0 = 0; t0 < total; t0 += kP) {
      const int np = min(kP, total - t0);
      if (tid < kP) {
        int r = -1;
        if (tid < np) {
          const int q = t0 + tid;
          int lo = 0, hi = npieces;  // last piece with sOff <= q
          while (hi - lo > 1) {
            const int mid = (lo + hi) / 2;
            if (sOff[mid] <= q) lo = mid; else hi = mid;
          }
          const long long row = sStart[lo] + (q - sOff[lo]);
          if (p.row_valid[row]) r = (int)row;
        }
        sRowIdx[tid] = r;
      }
      __syncthreads();
      for (int v = tid; v < np * p.ld; v += kThreads) {
        const int pp = v / p.ld, col = v % p.ld;
        const int r = sRowIdx[pp];
        sPart[pp * ldp + col] = r >= 0 ? p.src[(long long)r * p.ld + col] : 0.0f;
      }
      __syncthreads();
      // pair geometry and G, 16 threads per block row
      for (int pp = lane; pp < np; pp += 16) {
        float gv = 0.0f;
        if (row_ok && sRowIdx[pp] >= 0) {
          const float* q = sPart + pp * ldp;
          const float dx = wrap(px - q[0], p.bx);
          const float dy = wrap(py - q[1], p.by);
          const float dz = wrap(pz - q[2], p.bz);
          const float d2 = dx * dx + dy * dy + dz * dz;
          if (d2 > 1e-12f && d2 < p.rc2) {
            const float d = sqrtf(d2);
            float g, gp;
            g_and_grad(d, p, g, gp);
            if (BWD) {
              const float ctj = q[3];
              gv = g * ctj;
              float pd = 0.0f;
              for (int c = 0; c < p.c; ++c) pd = fmaf(sWb[i * p.c + c], q[4 + c], pd);
              const float s = gp * pd * (cti + ctj) / d;
              ax = fmaf(s, dx, ax);
              ay = fmaf(s, dy, ay);
              az = fmaf(s, dz, az);
            } else {
              gv = g;
            }
          }
        }
        sG[i * (kP + 1) + pp] = gv;
      }
      __syncthreads();
      // Φ (or S2) over the staged plane: channels on the lanes
      for (int pp = 0; pp < np; ++pp) {
        const float gv = sG[i * (kP + 1) + pp];
        const float* q = sPart + pp * ldp + 4;
#pragma unroll
        for (int m = 0; m < kMaxCg; ++m) {
          const int c = lane + 16 * m;
          if (m < mc && c < p.c) acc[m] = fmaf(gv, q[c], acc[m]);
        }
      }
      __syncthreads();
    }
    if (i < nr) {
#pragma unroll
      for (int m = 0; m < kMaxCg; ++m) {
        const int c = lane + 16 * m;
        if (m < mc && c < p.c) p.out[(row0 + i) * p.c + c] = row_ok ? acc[m] : 0.0f;
      }
    }
    if (BWD) {
#pragma unroll
      for (int off = 8; off > 0; off /= 2) {
        ax += __shfl_xor_sync(0xffffffffu, ax, off, 16);
        ay += __shfl_xor_sync(0xffffffffu, ay, off, 16);
        az += __shfl_xor_sync(0xffffffffu, az, off, 16);
      }
      if (i < nr && lane == 0) {
        p.dpos[(row0 + i) * 3 + 0] = row_ok ? ax : 0.0f;
        p.dpos[(row0 + i) * 3 + 1] = row_ok ? ay : 0.0f;
        p.dpos[(row0 + i) * 3 + 2] = row_ok ? az : 0.0f;
      }
    }
    __syncthreads();
  }
}

template <bool BWD>
int launch(const WParams& p, long long n_blocks, void* stream) {
  if (p.nsc * 2 > kMaxPieces || p.c > 16 * kMaxCg) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)(kP + kRowsG) * (p.ld + 1) +
                                       kRowsG * (kP + 1) + kRowsG * p.c);
  cudaError_t err = cudaFuncSetAttribute(
      wc_kernel<BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (n_blocks == 0) return cudaSuccess;
  wc_kernel<BWD><<<(unsigned)n_blocks, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

WParams make_params(const float* src, const long long* a1, const long long* e1,
                    const long long* a2, const long long* e2,
                    const uint8_t* row_valid, int cap, int nsc, int c,
                    float bx, float by, float bz, float rc2, float k_rf,
                    float c_rf, float factor) {
  WParams p{};
  p.src = src; p.a1 = a1; p.e1 = e1; p.a2 = a2; p.e2 = e2;
  p.row_valid = row_valid; p.cap = cap; p.nsc = nsc; p.c = c; p.ld = 4 + c;
  p.bx = bx; p.by = by; p.bz = bz; p.rc2 = rc2; p.k_rf = k_rf; p.c_rf = c_rf;
  p.factor = factor;
  return p;
}

}  // namespace

extern "C" {

const char* tmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel C.  src [n_blocks·cap, 4+c] (x, y, z, unused, b); a1, e1, a2, e2
// [n_blocks, nsc] int64; row_valid [n_blocks·cap] bytes; phi [.., c].
int tmd_windowed_coulomb_fwd(const float* src, const long long* a1,
                             const long long* e1, const long long* a2,
                             const long long* e2, const uint8_t* row_valid,
                             float* phi, long long n_blocks, int cap, int nsc,
                             int c, float bx, float by, float bz, float rc2,
                             float k_rf, float c_rf, float factor,
                             void* stream) {
  WParams p = make_params(src, a1, e1, a2, e2, row_valid, cap, nsc, c, bx, by,
                          bz, rc2, k_rf, c_rf, factor);
  p.out = phi;
  return launch<false>(p, n_blocks, stream);
}

// Kernel D.  src carries ct in column 3; qw [c]; s2 [.., c]; dpos [.., 3].
int tmd_windowed_coulomb_bwd(const float* src, const long long* a1,
                             const long long* e1, const long long* a2,
                             const long long* e2, const uint8_t* row_valid,
                             const float* qw, float* s2, float* dpos,
                             long long n_blocks, int cap, int nsc, int c,
                             float bx, float by, float bz, float rc2,
                             float k_rf, float c_rf, float factor,
                             void* stream) {
  WParams p = make_params(src, a1, e1, a2, e2, row_valid, cap, nsc, c, bx, by,
                          bz, rc2, k_rf, c_rf, factor);
  p.qw = qw; p.out = s2; p.dpos = dpos;
  return launch<true>(p, n_blocks, stream);
}

}  // extern "C"
