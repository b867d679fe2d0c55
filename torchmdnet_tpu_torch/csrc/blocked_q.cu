// TensorNet2 fused charge-fold message passing (the q-tier) for Hopper
// (sm_90a), float32-accurate: kernel A in fp32 FMA, kernel B's products on
// the tensor cores in 3xTF32 (csrc/tc_tile.cuh; never single-pass TF32).
//
// Replaces the Pallas TPU kernels of torchmdnet_tpu/ops/pallas_blocked_mp.py
//   kernel A  _mp_kernel_q (:1211) and _mp_kernel_q_grouped (:1324),
//             pallas_call :1890, without and with `with_du`;
//   kernel B  _dq_kernel (:1504) and _dq_kernel_grouped (:1623),
//             pallas_call :2017, emit="edge_du";
// each with its two bases: tab=True (the θ-tabulated series, RBF = false
// here) and tab=False (the exact rbf operand, RBF = true).
// Per valid slot e = (row n, slot k) of the sorted-space neighbor matrix,
// j = idx[n, k]:
//   base  = Σ_t cos(t·θ_e)·coeffs[t],  θ_e = acos(clip(2(d−lo)/(hi−lo)−1))
//           or, with RBF, Σ_r rbf[e, r]·W1a[r]  (coeffs carries W1a [R, F])
//   pre1  = base + urow[n] + ucol[j]
//   z2 = silu(pre1)·W2 + b2,  z3 = silu(z2)·W3 + b3,  h3 = silu(z3)
// Kernel A:   out[n, d·F + f] = Σ_k h3[e, w(d)·F + f]·cw[e]·xwin[j, d·F + f]
//   (w(0) = 0, w(1..3) = 1, w(4..8) = 2); with du it also backprops
//   fold[e, w·F + f] = Σ_{d∈w} grow[n, d·F + f]·cw[e]·xwin[j, d·F + f]
//   through the chain and writes du[n] = Σ_k ∂/∂pre1.
// Kernel B:   the same fold without cw, then dcw[e] = Σ_c fold·h3 on every
//   valid slot, du[n] = Σ_k ∂/∂pre1 of fold·cw, and dd[e] = Σ_f ∂/∂pre1·
//   Σ_t cos(t·θ)·dser[t] (the derivative in x; the caller applies dx/dd =
//   2/(hi−lo)) or, with RBF, the rbf cotangent drbf[e, r] = Σ_f ∂/∂pre1·
//   W1a[r, f]; every output exact zeros on invalid slots.
//
// The grouped (column-partitioned, K′ = Σ col_slots) and the ungrouped
// layouts differ only in which slots of a row are valid: every gather here
// is a plain load by the sorted-space index, so one kernel serves both,
// and a K′ list's empty group slots cost their mask read.  What the TPU
// kernels do that these do not: one-hot MXU gathers from DMA'd
// cell-block windows, column-major grouped edge layouts, hi/lo bf16
// splits, θ computed outside the kernel.
//
// Bound (north star, per call: 25,088 atoms in 27,024 sorted rows, K = 96
// or K′ ≈ 320, F = 128, T = 64, R = 32; H100 SXM data sheet at 700 W: 67
// TFLOP/s fp32, 495 TFLOP/s TF32 on the tensor cores): ~140 k FMA per slot
// (base 8,192 or 4,096, W2 32,768, W3 98,304, gather 1,152) over ~0.92 M
// slots with cw ≠ 0 (kernel A) is ~0.28 TFLOP, so fp32 operations bound it
// (~4 ms); kernel A with du adds the W3ᵀ/W2ᵀ backprop.  Kernel B runs the
// forward chain on all ~1.79 M valid slots and the backprop on the live
// ones, ~0.76 TFLOP of products: ~4.6 ms as three TF32 products each on
// the tensor cores.  The exact base reads the [N, K, R] rbf (332 MB at K =
// 96; B writes its cotangent, as much): ~0.1 ms of bytes each.
//
// Kernel A's design: a block owns kRows consecutive sorted rows and
// compacts their live slots (in chunks of kListCap slots, so that a long
// K′ row fits shared memory); each tile of TM slots keeps the whole chain
// on chip (basis or rbf tile, silu(pre1), h2, the 128-column h3 block, and
// for the with-du form dsilu planes and dz3), streaming weight k-tiles
// through shared memory in fp32 FMA.  Each row's 9F
// sum completes inside its block: one thread owns one output column of the
// block's rows and adds the tile's slots in slot order, so the sums need
// no atomics and their order is fixed.  Kernel A skips slots with cw = 0
// (their terms are exactly zero).  Kernel B's design is at dq_tc_kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 product threads
constexpr int kRows = 16;      // sorted rows per block
constexpr int kTileN = 128;    // output columns per product pass
constexpr int kTileK = 32;     // weight rows per shared-memory tile
constexpr int kPad = 4;
// slots compacted at a time: a 16-bit id each, 16 KB of shared memory
// (every slot of a block up to K = 512 in one pass)
constexpr int kListCap = kRows * 512;

enum Mode { kFwd = 0, kFwdDu = 1 };

struct QParams {
  const float* d;       // [n, k] (series base)
  const float* rbf;     // [n, k, t] (rbf base)
  const float* cw;      // [n, k]
  const uint8_t* mask;  // [n, k]
  const long long* idx; // [n, k]
  const float* urow;    // [n, f]
  const float* ucol;    // [n, f]
  const float* xwin;    // [n, 9f]
  const float* grow;    // [n, 9f] (du form)
  const float* coeffs;  // [t, f] (series terms, or W1a for the rbf base)
  const float* w2;      // [f, 2f]
  const float* b2;      // [2f]
  const float* w3;      // [2f, 3f]
  const float* b3;      // [3f]
  const float* w2t;     // [2f, f] (du form)
  const float* w3t;     // [3f, 2f] (du form)
  float* out;           // [n, 9f]
  float* du;            // [n, f] (du form)
  long long n;
  int k, f, t;
  float lo, span;       // span = hi - lo
};

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float silu(float x) { return x * sigm(x); }
__device__ __forceinline__ float dsilu(float x) {
  const float s = sigm(x);
  return s * (1.0f + x * (1.0f - s));
}

// acc[i][j] = Σ_k A[ty·RM + i][k]·W[k][c0 + tx + 16j] over k < kdim, for
// the 128-column block at c0 (columns ≥ ncols read as zero).  A is a
// [TM x kdim] activation in shared memory with row stride lda; W is
// [kdim x ncols] row-major in device memory (ncols a multiple of 4).
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
    __syncthreads();
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

// Appends, in slot order, the local slot ids s < total with pred(s) to
// list[base..]; returns how many.  Deterministic block-wide compaction.
template <class Pred>
__device__ int compact(int total, Pred pred, unsigned short* list, int base,
                       int* sWarp) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = (total + kThreads - 1) / kThreads;
  const int s0 = tid * per, s1 = min(total, s0 + per);
  int cnt = 0;
  for (int s = s0; s < s1; ++s) cnt += pred(s) ? 1 : 0;
  int incl = cnt;  // inclusive warp scan
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  __syncthreads();  // sWarp reuse
  if (lane == 31) sWarp[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) before += sWarp[w];
    all += sWarp[w];
  }
  int pos = base + before + incl - cnt;
  for (int s = s0; s < s1; ++s)
    if (pred(s)) list[pos++] = (unsigned short)s;
  __syncthreads();
  return all;
}

template <int MODE, bool RBF>
__global__ void __launch_bounds__(kThreads) q_kernel(QParams p) {
  constexpr int TM = MODE == kFwd ? 64 : 32;  // slots per tile
  constexpr int RM = TM / 16;
  constexpr bool kBwd = MODE != kFwd;
  extern __shared__ __align__(16) float smem[];
  __shared__ int sRow[TM];
  __shared__ long long sIdx[TM], sSlot[TM];
  __shared__ float sCw[TM], sTheta[TM];
  __shared__ int sWarp[kThreads / 32];

  const int F = p.f, F2 = 2 * F, F3 = 3 * F, F9 = 9 * F, T = p.t, K = p.k;
  const int lda = F + kPad, ldh = F2 + kPad, ldb = T + kPad, ldz = F3 + kPad;
  const int ldt = kTileN + kPad;
  float* sW = smem;                      // [32][128] weight k-tile
  float* sBasis = sW + kTileK * kTileN;  // [TM][T]    cos(t·θ) or the rbf
  float* sA = sBasis + TM * ldb;         // [TM][F]    silu(pre1), later dpre
  float* sH = sA + TM * lda;             // [TM][2F]   h2, later dz2
  float* sT = sH + TM * ldh;             // [TM][128]  h3 block (·cw in fwd)
  float* sP = sT + TM * ldt;             // [TM][F]    dsilu(pre1)
  float* sZ2 = sP + (kBwd ? TM * lda : 0);   // [TM][2F] dsilu(z2)
  float* sG = sZ2 + (kBwd ? TM * ldh : 0);   // [TM][128] dsilu(z3) block
  float* sDZ = sG + (kBwd ? TM * ldt : 0);   // [TM][3F] dz3
  unsigned short* sList =
      reinterpret_cast<unsigned short*>(sDZ + (kBwd ? TM * ldz : 0));

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int nrows = (int)min((long long)kRows, p.n - r0);
  const long long g0 = r0 * K;  // first slot of the block
  const int total = nrows * K;

  // zero the owned rows of every output (rows without live slots stay 0)
  for (int v = tid; v < nrows * F9; v += kThreads) p.out[r0 * F9 + v] = 0.0f;
  if (kBwd)
    for (int v = tid; v < nrows * F; v += kThreads) p.du[r0 * F + v] = 0.0f;

  const uint8_t* mask = p.mask + g0;
  const float* cwb = p.cw + g0;
  for (int q0 = 0; q0 < total; q0 += kListCap) {
    const int cn = min(kListCap, total - q0);
    // live slots of the chunk, in slot order
    const int n_all = compact(
        cn, [&](int s) { return mask[q0 + s] && cwb[q0 + s] != 0.0f; },
        sList, 0, sWarp);

  for (int t0 = 0; t0 < n_all; t0 += TM) {
    // ---- slot metadata and θ
    if (tid < TM) {
      const int e = t0 + tid;
      if (e < n_all) {
        const int s = q0 + sList[e];
        const long long g = g0 + s;
        sRow[tid] = s / K;
        sSlot[tid] = g;
        sIdx[tid] = p.idx[g];
        sCw[tid] = p.cw[g];
        if (!RBF) {
          float x = 2.0f * (p.d[g] - p.lo) / p.span - 1.0f;
          x = fminf(fmaxf(x, -1.0f), 1.0f);
          sTheta[tid] = acosf(x);
        }
      } else {
        sRow[tid] = -1;
        sSlot[tid] = -1;
        sIdx[tid] = r0;
        sCw[tid] = 0.0f;
        sTheta[tid] = 0.0f;
      }
    }
    __syncthreads();
    for (int v = tid; v < TM * T; v += kThreads) {
      const int e = v / T, j = v % T;
      float b;
      if (RBF)
        b = sSlot[e] >= 0 ? p.rbf[sSlot[e] * T + j] : 0.0f;
      else
        b = cosf((float)j * sTheta[e]);
      sBasis[e * ldb + j] = b;
    }

    float acc[RM][8];
    // ---- pre1 = basis·coeffs + urow[row] + ucol[j]
    for (int c0 = 0; c0 < F; c0 += kTileN) {
      tile_product<RM>(sBasis, ldb, p.coeffs, T, F, c0, sW, acc);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int e = ty * RM + i;
        const int r = sRow[e];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + tx + 16 * j;
          if (col >= F) continue;
          float pre = 0.0f;
          if (r >= 0)
            pre = acc[i][j] + p.urow[(r0 + r) * F + col] + p.ucol[sIdx[e] * F + col];
          sA[e * lda + col] = silu(pre);
          if (kBwd) sP[e * lda + col] = dsilu(pre);
        }
      }
    }
    // ---- h2 = silu(silu(pre1)·W2 + b2)
    for (int c0 = 0; c0 < F2; c0 += kTileN) {
      tile_product<RM>(sA, lda, p.w2, F, F2, c0, sW, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + tx + 16 * j;
        if (col >= F2) continue;
        const float bias = p.b2[col];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int e = ty * RM + i;
          const float z = acc[i][j] + bias;
          sH[e * ldh + col] = silu(z);
          if (kBwd) sZ2[e * ldh + col] = dsilu(z);
        }
      }
    }
    // ---- per 128-column block of h3: the neighbor sum and the fold
    for (int c0 = 0; c0 < F3; c0 += kTileN) {
      tile_product<RM>(sH, ldh, p.w3, F2, F3, c0, sW, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = tx + 16 * j, col = c0 + cl;
        if (col >= F3) continue;
        const float bias = p.b3[col];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int e = ty * RM + i;
          const float z = acc[i][j] + bias;
          sT[e * ldt + cl] = silu(z) * sCw[e];
          if (kBwd) sG[e * ldt + cl] = dsilu(z);
        }
      }
      __syncthreads();
      if (tid < kTileN && c0 + tid < F3) {
        const int cl = tid, c = c0 + cl;
        const int w = c / F, f = c % F;
        const int dlo = w == 0 ? 0 : (w == 1 ? 1 : 4);
        const int dn = w == 0 ? 1 : (w == 1 ? 3 : 5);
        float sum[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        int cur = -1;
        for (int e = 0; e < TM; ++e) {
          const int r = sRow[e];
          if (r < 0) break;
          if (r != cur) {
            if (cur >= 0)
              for (int q = 0; q < dn; ++q) p.out[(r0 + cur) * F9 + (dlo + q) * F + f] += sum[q];
#pragma unroll
            for (int q = 0; q < 5; ++q) sum[q] = 0.0f;
            cur = r;
          }
          const float* xj = p.xwin + sIdx[e] * F9 + dlo * F + f;
          const float h = sT[e * ldt + cl];
          float fold = 0.0f;
#pragma unroll
          for (int q = 0; q < 5; ++q) {
            if (q >= dn) break;
            const float x = xj[q * F];
            sum[q] = fmaf(h, x, sum[q]);
            if (kBwd) fold = fmaf(p.grow[(r0 + r) * F9 + (dlo + q) * F + f], x, fold);
          }
          if (kBwd) sDZ[e * ldz + c] = fold * sCw[e] * sG[e * ldt + cl];
        }
        if (cur >= 0)
          for (int q = 0; q < dn; ++q) p.out[(r0 + cur) * F9 + (dlo + q) * F + f] += sum[q];
      }
    }

    if (kBwd) {
      // ---- dz2 = (dz3·W3ᵀ) ⊙ dsilu(z2), into sH
      for (int c0 = 0; c0 < F2; c0 += kTileN) {
        tile_product<RM>(sDZ, ldz, p.w3t, F3, F2, c0, sW, acc);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + tx + 16 * j;
          if (col >= F2) continue;
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const int e = ty * RM + i;
            sH[e * ldh + col] = acc[i][j] * sZ2[e * ldh + col];
          }
        }
      }
      // ---- dpre = (dz2·W2ᵀ) ⊙ dsilu(pre1), into sA
      for (int c0 = 0; c0 < F; c0 += kTileN) {
        tile_product<RM>(sH, ldh, p.w2t, F2, F, c0, sW, acc);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c0 + tx + 16 * j;
          if (col >= F) continue;
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const int e = ty * RM + i;
            sA[e * lda + col] = acc[i][j] * sP[e * lda + col];
          }
        }
      }
      __syncthreads();
      // ---- du[row] += Σ_k dpre, one thread per channel, slots in order
      for (int f = tid; f < F; f += kThreads) {
        float sum = 0.0f;
        int cur = -1;
        for (int e = 0; e < TM; ++e) {
          const int r = sRow[e];
          if (r < 0) break;
          if (r != cur) {
            if (cur >= 0) p.du[(r0 + cur) * F + f] += sum;
            sum = 0.0f;
            cur = r;
          }
          sum += sA[e * lda + f];
        }
        if (cur >= 0) p.du[(r0 + cur) * F + f] += sum;
      }
    }
    __syncthreads();
  }
  }
}

template <int MODE>
size_t smem_bytes(int f, int t, int k) {
  constexpr int TM = MODE == kFwd ? 64 : 32;
  const size_t lda = f + kPad, ldh = 2 * f + kPad, ldb = t + kPad,
               ldz = 3 * f + kPad, ldt = kTileN + kPad;
  size_t floats = (size_t)kTileK * kTileN + TM * (ldb + lda + ldh + ldt);
  if (MODE != kFwd) floats += TM * (lda + ldh + ldt + ldz);
  const size_t list = (size_t)kRows * k < (size_t)kListCap ? (size_t)kRows * k
                                                           : (size_t)kListCap;
  return floats * sizeof(float) + list * sizeof(unsigned short);
}

template <int MODE, bool RBF>
int launch(const QParams& p, void* stream) {
  const size_t smem = smem_bytes<MODE>(p.f, p.t, p.k);
  cudaError_t err = cudaFuncSetAttribute(
      q_kernel<MODE, RBF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (p.n + kRows - 1) / kRows;
  if (blocks == 0) return cudaSuccess;
  q_kernel<MODE, RBF><<<(unsigned)blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}


// ---- kernel B on the tensor cores

constexpr int kDqRows = 16;      // sorted rows a kernel B block owns
constexpr int kDqChunk = 4096;   // slots it compacts at a time (16-bit ids)
constexpr int kWarps = kTcThreads / 32;
static_assert(kThreads == kTcThreads, "one launch width for every kernel");

struct DqParams {
  const float* d;       // [n, k] (series base)
  const float* rbf;     // [n, k, r] (rbf base)
  const float* cw;      // [n, k]
  const uint8_t* mask;  // [n, k]
  const long long* idx; // [n, k]
  const float* urow;    // [n, f]
  const float* ucol;    // [n, f]
  const float* xwin;    // [n, 9f]
  const float* grow;    // [n, 9f]
  const float* b2;      // [2f]
  const float* b3;      // [3f]
  // split images (tc_split): the base (coeffs [t, f] or W1a [r, f]), W2
  // [f, 2f], W3 [2f, 3f], W3ᵀ [3f, 2f], W2ᵀ [2f, f] and the base's
  // cotangent (dser [t, f] or W1aᵀ [f, r])
  const float* img_base;
  const float* img2;
  const float* img3;
  const float* img3t;
  const float* img2t;
  const float* img_cot;
  float* du;            // [n, f]
  float* dd;            // [n, k] (series base)
  float* drbf;          // [n, k, r] (rbf base)
  float* dcw;           // [n, k]
  long long n;
  int k, f, t;          // t: series terms, or the rbf width r
  float lo, span;       // span = hi − lo
};

// Slot ids a block compacts at a time.
__host__ __device__ __forceinline__ int dq_list_cap(int k) {
  return kDqRows * k < kDqChunk ? kDqRows * k : kDqChunk;
}

// Dynamic shared memory of a kernel B launch (ops/blocked_q.py::dq_smem
// keeps the same sum): 1 KB to align the ring, the ring, sX [64][3F + 4],
// sZ [64][2F + 4], the [2][64] warpgroup sums, dcw, cw and θ, the tile's rows,
// neighbours and slot offsets, the warp counts, the slot ids.
size_t dq_smem(int f, int k) {
  return 1024 +
         sizeof(float) * ((size_t)kTcRegion + (size_t)kTcM * (3 * f + kPad) +
                          (size_t)kTcM * (2 * f + kPad) + 5 * kTcM) +
         sizeof(int) * (3 * kTcM + kWarps) +
         sizeof(unsigned short) * dq_list_cap(k);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
// First irrep of weight block w: I = 0, A = 1..3, S = 4..8.
__device__ __forceinline__ int first_irrep(int w) { return w == 0 ? 0 : (w == 1 ? 1 : 4); }

// Kernel B.  Block b owns the sorted rows [16b, 16b + 16) and walks their
// valid slots, compacted per chunk of kDqChunk slots with cw ≠ 0 first
// (the live slots) and then cw = 0, each group in slot order, in tiles of
// 64.  Per tile, in sX [64][3F + 4] and sZ [64][2F + 4] (F ≤ 128):
//   base   pre1 = base + urow + ucol; silu(pre1) into sX[:, 2F:3F]
//   W2     z2 = silu(pre1)·W2 + b2 into sZ, silu(z2) into sX[:, 0:2F]
//   W3     z3 = silu(z2)·W3 + b3 per 128-column pass, put into the free
//          ring; then a warp a slot gathers its fold from g9 and xwin[j]
//          (float4 rows), adds fold·silu(z3) into dcw and, on a tile with
//          a live slot, puts dz3 = fold·cw·dsilu(z3) into sX[:, pass
//          columns].  The passes whose columns start at 2F or
//          beyond run first; those below 2F overwrite silu(z2), which
//          every pass reads, so they run last, the last storing after its
//          product and the one before it (at most one for F ≤ 128) held
//          in registers until then.
// and on a tile with a live slot:
//   W3ᵀ    dz2 = (dz3·W3ᵀ) ⊙ dsilu(z2), over z2 in sZ
//   base   pre1 again, into sX[:, 0:F] (dz3 is consumed)
//   W2ᵀ    dpre = (dz2·W2ᵀ) ⊙ dsilu(pre1), over pre1
//   du     the row sums of dpre, one thread a channel, slots in order
//   base′  dd = Σ_f dpre·(B(θ)·dser), or drbf = dpre·W1aᵀ
// Every product is tc_product_from on the split images.  dcw is summed
// per slot by one warp's shuffles, then over the passes in order; dd is
// folded from the accumulators: per thread, by shuffles within the quad
// that shares a slot, then over the two warpgroups in order.  No atomics:
// the same result on every run.
template <bool RBF>
__global__ void __launch_bounds__(kTcThreads, 1) dq_tc_kernel(DqParams p) {
  extern __shared__ __align__(16) float smem[];
  const int F = p.f, F2 = 2 * F, F3 = 3 * F, F9 = 9 * F, T = p.t, K = p.k;
  const int ldx = F3 + kPad, ldz = F2 + kPad;
  float* sR = smem + tc_region_offset(smem);  // the ring
  float* sX = sR + kTcRegion;                 // [64][3F + pad]
  float* sZ = sX + kTcM * ldx;                // [64][2F + pad]  z2, then dz2
  float* sRed = sZ + kTcM * ldz;              // [2][64]
  float* sDcw = sRed + 2 * kTcM;              // [64]
  float* sCw = sDcw + kTcM;                   // [64]
  float* sTheta = sCw + kTcM;                 // [64]
  int* sRow = reinterpret_cast<int*>(sTheta + kTcM);  // [64] block row, −1 past the tile
  int* sJ = sRow + kTcM;                      // [64] neighbour row
  int* sOff = sJ + kTcM;                      // [64] slot offset in the block
  int* sCount = sOff + kTcM;                  // [kWarps]
  unsigned short* sList = reinterpret_cast<unsigned short*>(sCount + kWarps);

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const long long r0 = (long long)blockIdx.x * kDqRows;
  const int nrows = (int)min((long long)kDqRows, p.n - r0);
  const long long g0 = r0 * K;  // first slot of the block
  const int total = nrows * K;
  const int cap = dq_list_cap(K);
  const int np2 = (F2 + kTcN - 1) / kTcN, np3 = (F3 + kTcN - 1) / kTcN;
  const int fr0 = tc_row(0), fr1 = tc_row(1);  // this thread's fragment rows

  // du starts at 0; invalid slots get exact zeros
  for (int v = tid; v < nrows * F; v += kTcThreads) p.du[r0 * F + v] = 0.0f;
  for (int s = tid; s < total; s += kTcThreads) {
    if (p.mask[g0 + s]) continue;
    p.dcw[g0 + s] = 0.0f;
    if (!RBF) p.dd[g0 + s] = 0.0f;
  }
  if (RBF)
    for (long long v = tid; v < (long long)total * T; v += kTcThreads)
      if (!p.mask[g0 + v / T]) p.drbf[g0 * T + v] = 0.0f;

  // the tile's base product: B(θ)·coeffs or rbf·W1a
  auto base = [&](float (&acc)[8][4]) {
    if constexpr (RBF) {
      const float* a0 = p.rbf + (g0 + sOff[sRow[fr0] >= 0 ? fr0 : 0]) * T;
      const float* a1 = p.rbf + (g0 + sOff[sRow[fr1] >= 0 ? fr1 : 0]) * T;
      tc_product_from(TcActivation{a0, a1, T}, p.img_base, T, 0, sR, acc);
    } else {
      tc_product_from(TcCosBasis{sTheta[fr0], sTheta[fr1], T}, p.img_base, T,
                      0, sR, acc);
    }
  };
  // pre1 = acc + urow[row] + ucol[j] (0 on rows past the tile) through
  // op, stored at column col0 + c of sX
  auto store_pre1 = [&](const float (&acc)[8][4], int col0, auto op) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tc_row(h), row = sRow[r];
      const float* ur = p.urow + (r0 + max(row, 0)) * F;
      const float* uc = p.ucol + (long long)sJ[r] * F;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = tc_col(i);  // even; F is a multiple of 4
        if (c >= F) continue;
        float x = 0.0f, y = 0.0f;
        if (row >= 0) {
          const float2 a = ld2(ur + c), b = ld2(uc + c);
          x = acc[i][2 * h] + a.x + b.x;
          y = acc[i][2 * h + 1] + a.y + b.y;
        }
        st2(sX + r * ldx + col0 + c, op(x), op(y));
      }
    }
  };
  float acc[8][4];
  float4 held[kTcM / kWarps];  // a pass's dz3 kept past the next product
  for (int q0 = 0; q0 < total; q0 += cap) {
    const int cn = min(cap, total - q0);
    const uint8_t* mk = p.mask + g0 + q0;
    const float* cwq = p.cw + g0 + q0;
    const int n_live = compact(
        cn, [&](int s) { return mk[s] && cwq[s] != 0.0f; }, sList, 0, sCount);
    const int n_all = n_live + compact(
        cn, [&](int s) { return mk[s] && cwq[s] == 0.0f; }, sList, n_live,
        sCount);

    for (int t0 = 0; t0 < n_all; t0 += kTcM) {
      const int nt = min(kTcM, n_all - t0);
      const bool bwd = t0 < n_live;  // the tile has a slot with cw ≠ 0
      if (tid < kTcM) {
        if (tid < nt) {
          const int s = q0 + sList[t0 + tid];
          const long long g = g0 + s;
          sRow[tid] = s / K;
          sOff[tid] = s;
          sJ[tid] = (int)p.idx[g];
          sCw[tid] = p.cw[g];
          if (!RBF) {
            float x = 2.0f * (p.d[g] - p.lo) / p.span - 1.0f;
            x = fminf(fmaxf(x, -1.0f), 1.0f);
            sTheta[tid] = acosf(x);
          }
        } else {
          sRow[tid] = -1;
          sOff[tid] = 0;
          sJ[tid] = 0;
          sCw[tid] = 0.0f;
          sTheta[tid] = 0.0f;
        }
      }
      __syncthreads();

      // ---- forward: silu(pre1), z2 and silu(z2)
      base(acc);
      store_pre1(acc, F2, [](float x) { return silu(x); });
      for (int pz = 0; pz < np2; ++pz) {
        __syncthreads();  // silu(pre1) is written
        tc_product_from(TcActivation{sX + fr0 * ldx + F2, sX + fr1 * ldx + F2, F},
                        p.img2, F, pz, sR, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = pz * kTcN + tc_col(i);
          if (col >= F2) continue;
          const float2 b = ld2(p.b2 + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = tc_row(h);
            const float x = acc[i][2 * h] + b.x, y = acc[i][2 * h + 1] + b.y;
            st2(sZ + r * ldz + col, x, y);
            st2(sX + r * ldx + col, silu(x), silu(y));
          }
        }
      }

      // ---- z3 per pass: dcw and dz3
      if (tid < kTcM) sDcw[tid] = 0.0f;
      for (int step = 0; step < np3; ++step) {
        const int pz = (step + np2) % np3;  // passes np2.., then 0..np2 − 1
        __syncthreads();  // silu(z2) is written; sR's z3 tile is read
        tc_product_from(TcActivation{sX + fr0 * ldx, sX + fr1 * ldx, F2},
                        p.img3, F2, pz, sR, acc);
        // the pass's z3 − b3 [64][kTcLdW] over the free ring
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            st2(sR + tc_row(h) * kTcLdW + tc_col(i), acc[i][2 * h], acc[i][2 * h + 1]);
        __syncthreads();
        // a warp takes one slot's 128 columns, 4 a lane, 8 slots a pass:
        // the fold from coalesced g9 and xwin[j] rows, Σ fold·silu(z3)
        // into dcw (the warp's shuffles, then slot order by pass), and dz3
        const bool hold = bwd && pz < np2 - 1;  // it would overwrite what
                                                // pass pz + 1 reads
        const bool last = bwd && pz == np2 - 1 && np2 > 1;
#pragma unroll
        for (int m = 0; m < kTcM / kWarps; ++m) {
          const int e = (tid >> 5) + kWarps * m, q = lane;
          const int col = pz * kTcN + 4 * q, row = sRow[e];
          float4 dz = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          float part = 0.0f;
          if (row >= 0 && col < F3) {
            const int w = col / F, f = col - w * F, d0 = first_irrep(w);
            const float* gr = p.grow + (r0 + row) * F9 + d0 * F + f;
            const float* xj = p.xwin + (long long)sJ[e] * F9 + d0 * F + f;
            float4 a[5], b[5];
#pragma unroll
            for (int u = 0; u < 5; ++u)
              if (u <= 2 * w) {
                a[u] = __ldg(reinterpret_cast<const float4*>(gr + u * F));
                b[u] = __ldg(reinterpret_cast<const float4*>(xj + u * F));
              }
            float4 fo = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
            for (int u = 0; u < 5; ++u)
              if (u <= 2 * w) {
                fo.x = fmaf(a[u].x, b[u].x, fo.x);
                fo.y = fmaf(a[u].y, b[u].y, fo.y);
                fo.z = fmaf(a[u].z, b[u].z, fo.z);
                fo.w = fmaf(a[u].w, b[u].w, fo.w);
              }
            const float4 z0 = *reinterpret_cast<const float4*>(sR + e * kTcLdW + 4 * q);
            const float4 bb = *reinterpret_cast<const float4*>(p.b3 + col);
            const float c = sCw[e];
            const float z[4] = {z0.x + bb.x, z0.y + bb.y, z0.z + bb.z, z0.w + bb.w};
            const float fv[4] = {fo.x, fo.y, fo.z, fo.w};
            float d[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float sg = sigm(z[u]);
              part = fmaf(fv[u], z[u] * sg, part);
              d[u] = fv[u] * c * (sg * (1.0f + z[u] * (1.0f - sg)));
            }
            dz = make_float4(d[0], d[1], d[2], d[3]);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          if (lane == 0) sDcw[e] += part;
          if (hold) {
            held[m] = dz;
          } else if (bwd) {
            if (col < F3) *reinterpret_cast<float4*>(sX + e * ldx + col) = dz;
            if (last)  // the held pass's columns, below F3 where np2 = 2
              *reinterpret_cast<float4*>(sX + e * ldx + col - kTcN) = held[m];
          }
        }
      }
      __syncthreads();
      if (tid < nt) p.dcw[g0 + sOff[tid]] = sDcw[tid];
      if (!bwd) {  // every slot has cw = 0: the base cotangent is 0
        if (RBF) {
          for (int v = tid; v < nt * T; v += kTcThreads)
            p.drbf[(g0 + sOff[v / T]) * T + v % T] = 0.0f;
        } else if (tid < nt) {
          p.dd[g0 + sOff[tid]] = 0.0f;
        }
        __syncthreads();  // the tile's metadata is read
        continue;
      }

      // ---- backward: dz2 over z2
      for (int pz = 0; pz < np2; ++pz) {
        __syncthreads();  // dz3 is written
        tc_product_from(TcActivation{sX + fr0 * ldx, sX + fr1 * ldx, F3},
                        p.img3t, F3, pz, sR, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = pz * kTcN + tc_col(i);
          if (col >= F2) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* z = sZ + tc_row(h) * ldz + col;
            const float2 v = ld2(z);
            st2(z, acc[i][2 * h] * dsilu(v.x), acc[i][2 * h + 1] * dsilu(v.y));
          }
        }
      }
      // pre1 again, then dpre over it
      base(acc);
      store_pre1(acc, 0, [](float x) { return x; });
      __syncthreads();  // dz2 is written
      tc_product_from(TcActivation{sZ + fr0 * ldz, sZ + fr1 * ldz, F2}, p.img2t,
                      F2, 0, sR, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = tc_col(i);
        if (col >= F) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* x = sX + tc_row(h) * ldx + col;
          const float2 v = ld2(x);
          st2(x, acc[i][2 * h] * dsilu(v.x), acc[i][2 * h + 1] * dsilu(v.y));
        }
      }
      __syncthreads();  // dpre is written
      // du[row] += Σ dpre over the tile's live slots, in slot order
      const int ne = min(nt, n_live - t0);
      for (int f = tid; f < F; f += kTcThreads) {
        float sum = 0.0f;
        int cur = sRow[0];
        for (int e = 0; e < ne; ++e) {
          const int r = sRow[e];
          if (r != cur) {
            p.du[(r0 + cur) * F + f] += sum;
            sum = 0.0f;
            cur = r;
          }
          sum += sX[e * ldx + f];
        }
        p.du[(r0 + cur) * F + f] += sum;
      }
      // the base's cotangent
      if (RBF) {
        tc_product_from(TcActivation{sX + fr0 * ldx, sX + fr1 * ldx, F},
                        p.img_cot, F, 0, sR, acc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = tc_row(h);
          if (r >= nt) continue;
          float* out = p.drbf + (g0 + sOff[r]) * T;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int col = tc_col(i);
            if (col < T) out[col] = acc[i][2 * h];
            if (col + 1 < T) out[col + 1] = acc[i][2 * h + 1];
          }
        }
      } else {
        tc_product_from(TcCosBasis{sTheta[fr0], sTheta[fr1], T}, p.img_cot, T,
                        0, sR, acc);
        float dpart[2] = {0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = tc_col(i);
          if (col >= F) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v = ld2(sX + tc_row(h) * ldx + col);
            dpart[h] = fmaf(acc[i][2 * h], v.x, dpart[h]);
            dpart[h] = fmaf(acc[i][2 * h + 1], v.y, dpart[h]);
          }
        }
        // Σ over the quad that shares a slot, then the two warpgroups in order
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = dpart[h];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if ((lane & 3) == 0) sRed[wg * kTcM + tc_row(h)] = v;
        }
        __syncthreads();
        if (tid < nt) p.dd[g0 + sOff[tid]] = sRed[tid] + sRed[kTcM + tid];
      }
      __syncthreads();  // the tile's metadata and sRed are read
    }
  }
}

// Splits the six weights of kernel B into image (tmd_blocked_q_dq_image_
// floats), fills in the image pointers of p and launches it.  base and
// cot are the base's weight [t, f] and its cotangent's: dser [t, f], or
// with rbf W1a again, split as W1aᵀ [f, t].
template <bool RBF>
int launch_dq(DqParams p, const float* base, const float* cot,
              const float* w2, const float* w3, float* image, void* stream) {
  const int f = p.f, t = p.t;
  if (f < 4 || f > kTcN || f % 4 || t < 1 || (RBF && t > kTcN))
    return cudaErrorInvalidValue;
  struct Piece { const float* w; int kdim, ncols; bool trans; const float** img; };
  const Piece pieces[] = {{base, t, f, false, &p.img_base},
                          {w2, f, 2 * f, false, &p.img2},
                          {w3, 2 * f, 3 * f, false, &p.img3},
                          {w3, 3 * f, 2 * f, true, &p.img3t},
                          {w2, 2 * f, f, true, &p.img2t},
                          {cot, RBF ? f : t, RBF ? t : f, RBF, &p.img_cot}};
  float* at = image;
  for (const Piece& q : pieces) {
    const int rc = tc_split(q.w, q.kdim, q.ncols, at, stream, q.trans);
    if (rc != cudaSuccess) return rc;
    *q.img = at;
    at += tc_image_floats(q.kdim, q.ncols);
  }
  const size_t smem = dq_smem(f, p.k);
  cudaError_t err = cudaFuncSetAttribute(
      dq_tc_kernel<RBF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (p.n + kDqRows - 1) / kDqRows;
  if (blocks == 0) return cudaSuccess;
  dq_tc_kernel<RBF><<<(unsigned)blocks, kTcThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// Floats of kernel B's image scratch at (f, t): the base's, W2's, W3's,
// W3ᵀ's, W2ᵀ's and the cotangent's split images.
int dq_image_floats(int f, int t, bool rbf) {
  return tc_image_floats(t, f) + tc_image_floats(f, 2 * f) +
         tc_image_floats(2 * f, 3 * f) + tc_image_floats(3 * f, 2 * f) +
         tc_image_floats(2 * f, f) +
         (rbf ? tc_image_floats(f, t) : tc_image_floats(t, f));
}

DqParams make_dq_params(const float* cw, const uint8_t* mask,
                        const long long* idx, const float* urow,
                        const float* ucol, const float* xwin,
                        const float* grow, const float* b2, const float* b3,
                        float* du, float* dcw, long long n, int k, int f,
                        int t) {
  DqParams p{};
  p.cw = cw; p.mask = mask; p.idx = idx; p.urow = urow; p.ucol = ucol;
  p.xwin = xwin; p.grow = grow; p.b2 = b2; p.b3 = b3; p.du = du; p.dcw = dcw;
  p.n = n; p.k = k; p.f = f; p.t = t;
  return p;
}

// base: d [n, k] for the series, rbf [n, k, t] with rbf = true
QParams make_params(bool rbf, const float* base, const float* cw,
                    const uint8_t* mask, const long long* idx,
                    const float* urow, const float* ucol, const float* xwin,
                    const float* coeffs, const float* w2, const float* b2,
                    const float* w3, const float* b3, long long n, int k,
                    int f, int t, float lo, float span) {
  QParams p{};
  if (rbf) p.rbf = base; else p.d = base;
  p.cw = cw; p.mask = mask; p.idx = idx; p.urow = urow; p.ucol = ucol;
  p.xwin = xwin; p.coeffs = coeffs; p.w2 = w2; p.b2 = b2; p.w3 = w3; p.b3 = b3;
  p.n = n; p.k = k; p.f = f; p.t = t; p.lo = lo; p.span = span;
  return p;
}

}  // namespace

extern "C" {

const char* tmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel A.  d, cw [n,k]; mask [n,k] bytes; idx [n,k] int64; urow, ucol
// [n,f]; xwin [n,9f]; coeffs [t,f]; w2 [f,2f]; b2 [2f]; w3 [2f,3f]; b3 [3f];
// out [n,9f].  f a multiple of 4.
int tmd_blocked_q_fwd(const float* d, const float* cw, const uint8_t* mask,
                      const long long* idx, const float* urow,
                      const float* ucol, const float* xwin, const float* coeffs,
                      const float* w2, const float* b2, const float* w3,
                      const float* b3, float* out, long long n, int k, int f,
                      int t, float lo, float span, void* stream) {
  QParams p = make_params(false, d, cw, mask, idx, urow, ucol, xwin, coeffs,
                          w2, b2, w3, b3, n, k, f, t, lo, span);
  p.out = out;
  return launch<kFwd, false>(p, stream);
}

// Kernel A with du: as above plus grow [n,9f], w2t [2f,f], w3t [3f,2f] and
// du [n,f].
int tmd_blocked_q_fwd_du(const float* d, const float* cw, const uint8_t* mask,
                         const long long* idx, const float* urow,
                         const float* ucol, const float* xwin,
                         const float* grow, const float* coeffs,
                         const float* w2, const float* b2, const float* w3,
                         const float* b3, const float* w2t, const float* w3t,
                         float* out, float* du, long long n, int k, int f,
                         int t, float lo, float span, void* stream) {
  QParams p = make_params(false, d, cw, mask, idx, urow, ucol, xwin, coeffs,
                          w2, b2, w3, b3, n, k, f, t, lo, span);
  p.grow = grow; p.w2t = w2t; p.w3t = w3t; p.out = out; p.du = du;
  return launch<kFwdDu, false>(p, stream);
}

// Kernel B: xwin = feats9, grow = g9 [n,9f], dser [t,f]; writes du [n,f],
// dd [n,k] (the x-derivative) and dcw [n,k]; image [tmd_blocked_q_dq_
// image_floats(f, t, 0)] scratch.  f a multiple of 4, at most 128.
int tmd_blocked_q_dq(const float* d, const float* cw, const uint8_t* mask,
                     const long long* idx, const float* urow,
                     const float* ucol, const float* xwin, const float* grow,
                     const float* coeffs, const float* dser, const float* w2,
                     const float* b2, const float* w3, const float* b3,
                     float* du, float* dd, float* dcw, float* image,
                     long long n, int k, int f, int t, float lo, float span,
                     void* stream) {
  DqParams p = make_dq_params(cw, mask, idx, urow, ucol, xwin, grow, b2, b3,
                              du, dcw, n, k, f, t);
  p.d = d; p.dd = dd; p.lo = lo; p.span = span;
  return launch_dq<false>(p, coeffs, dser, w2, w3, image, stream);
}

// The exact-rbf forms: rbf [n,k,r] in place of d, W1a [r,f] in place of
// coeffs; r any width.
int tmd_blocked_q_fwd_rbf(const float* rbf, const float* cw,
                          const uint8_t* mask, const long long* idx,
                          const float* urow, const float* ucol,
                          const float* xwin, const float* w1a, const float* w2,
                          const float* b2, const float* w3, const float* b3,
                          float* out, long long n, int k, int f, int r,
                          void* stream) {
  QParams p = make_params(true, rbf, cw, mask, idx, urow, ucol, xwin, w1a, w2,
                          b2, w3, b3, n, k, f, r, 0.0f, 1.0f);
  p.out = out;
  return launch<kFwd, true>(p, stream);
}

int tmd_blocked_q_fwd_du_rbf(const float* rbf, const float* cw,
                             const uint8_t* mask, const long long* idx,
                             const float* urow, const float* ucol,
                             const float* xwin, const float* grow,
                             const float* w1a, const float* w2,
                             const float* b2, const float* w3, const float* b3,
                             const float* w2t, const float* w3t, float* out,
                             float* du, long long n, int k, int f, int r,
                             void* stream) {
  QParams p = make_params(true, rbf, cw, mask, idx, urow, ucol, xwin, w1a, w2,
                          b2, w3, b3, n, k, f, r, 0.0f, 1.0f);
  p.grow = grow; p.w2t = w2t; p.w3t = w3t; p.out = out; p.du = du;
  return launch<kFwdDu, true>(p, stream);
}

// Kernel B, exact rbf: writes du [n,f], drbf [n,k,r] and dcw [n,k]; image
// [tmd_blocked_q_dq_image_floats(f, r, 1)] scratch.  r at most 128.
int tmd_blocked_q_dq_rbf(const float* rbf, const float* cw,
                         const uint8_t* mask, const long long* idx,
                         const float* urow, const float* ucol,
                         const float* xwin, const float* grow,
                         const float* w1a, const float* w2, const float* b2,
                         const float* w3, const float* b3, float* du,
                         float* drbf, float* dcw, float* image, long long n,
                         int k, int f, int r, void* stream) {
  DqParams p = make_dq_params(cw, mask, idx, urow, ucol, xwin, grow, b2, b3,
                              du, dcw, n, k, f, r);
  p.rbf = rbf; p.drbf = drbf;
  return launch_dq<true>(p, w1a, w1a, w2, w3, image, stream);
}

// Floats of kernel B's image scratch at (f, t) (rbf: t is the rbf width).
int tmd_blocked_q_dq_image_floats(int f, int t, int rbf) {
  return dq_image_floats(f, t, rbf != 0);
}

// What the compiler and the launch give kernel B (rbf: its exact form) at
// (f, k): out = registers a thread, local (spill) bytes a thread, static
// and dynamic shared memory bytes a block, resident blocks an SM.
int tmd_blocked_q_dq_attributes(int rbf, int f, int k, int* out) {
  const void* kern = rbf ? (const void*)dq_tc_kernel<true>
                         : (const void*)dq_tc_kernel<false>;
  const size_t smem = dq_smem(f, k);
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
