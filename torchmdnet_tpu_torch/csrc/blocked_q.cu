// TensorNet2 fused charge-fold message passing (the q-tier) for Hopper
// (sm_90a), fp32 FMA throughout (the JAX package's precise tier).
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
// Kernel B:   the same fold without cw, then dcw[e] = Σ_c fold·h3,
//   du[n] = Σ_k ∂/∂pre1 of fold·cw, and dd[e] = Σ_f ∂/∂pre1·Σ_t cos(t·θ)·dser[t]
//   (the derivative in x; the caller applies dx/dd = 2/(hi−lo)) or, with
//   RBF, the rbf cotangent drbf[e, r] = Σ_f ∂/∂pre1·W1a[r, f] (exact zeros
//   on invalid slots).
//
// The grouped (column-partitioned, K′ = Σ col_slots) and the ungrouped
// layouts differ only in which slots of a row are valid: every gather here
// is a plain load by the sorted-space index, so one kernel serves both,
// and a K′ list's empty group slots cost their mask read.  What the TPU
// kernels do that this one does not: one-hot MXU gathers from DMA'd
// cell-block windows, column-major grouped edge layouts, hi/lo bf16
// splits, θ computed outside the kernel.
//
// Bound (north star, per call: 25,088 atoms in 27,024 sorted rows, K = 96
// or K′ ≈ 320, F = 128, T = 64, R = 32): ~140 k FMA per slot (base 8,192 or
// 4,096, W2 32,768, W3 98,304, gather 1,152) over ~1 M slots with cw ≠ 0
// (kernel A) is ~0.28 TFLOP, so fp32 operations bound it (~4 ms at the
// H100 SXM data-sheet 67 TFLOP/s, 700 W); kernel A with du and kernel B add
// the W3ᵀ/W2ᵀ backprop.  The exact base reads the [N, K, R] rbf (332 MB at
// K = 96; B writes its cotangent, as much): ~0.1 ms of bytes each.
//
// Design against it: a block owns kRows consecutive sorted rows and
// compacts their live slots (in chunks of kListCap slots, so that a long
// K′ row fits shared memory); each tile of TM slots keeps the whole chain
// on chip (basis or rbf tile, silu(pre1), h2, the 128-column h3 block, and
// for the backward forms dsilu planes and dz3), streaming weight k-tiles
// through shared memory as kernel 3 (csrc/edge_mlp.cu) does.  Each row's 9F
// sum completes inside its block: one thread owns one output column of the
// block's rows and adds the tile's slots in slot order, so the sums need
// no atomics and their order is fixed.  Kernel A skips slots with cw = 0
// (their terms are exactly zero); kernel B runs the backprop only on them
// and the forward chain (for dcw) on the others.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 product threads
constexpr int kRows = 16;      // sorted rows per block
constexpr int kTileN = 128;    // output columns per product pass
constexpr int kTileK = 32;     // weight rows per shared-memory tile
constexpr int kPad = 4;
// slots compacted at a time: a 16-bit id each, 16 KB of shared memory
// (every slot of a block up to K = 512 in one pass)
constexpr int kListCap = kRows * 512;

enum Mode { kFwd = 0, kFwdDu = 1, kDq = 2 };

struct QParams {
  const float* d;       // [n, k] (series base)
  const float* rbf;     // [n, k, t] (rbf base)
  const float* cw;      // [n, k]
  const uint8_t* mask;  // [n, k]
  const long long* idx; // [n, k]
  const float* urow;    // [n, f]
  const float* ucol;    // [n, f]
  const float* xwin;    // [n, 9f]
  const float* grow;    // [n, 9f] (du and dq forms)
  const float* coeffs;  // [t, f] (series terms, or W1a for the rbf base)
  const float* dser;    // [t, f] (dq, series base)
  const float* w1at;    // [f, t4] (dq, rbf base: W1aᵀ, columns padded to 4)
  const float* w2;      // [f, 2f]
  const float* b2;      // [2f]
  const float* w3;      // [2f, 3f]
  const float* b3;      // [3f]
  const float* w2t;     // [2f, f] (du and dq)
  const float* w3t;     // [3f, 2f] (du and dq)
  float* out;           // [n, 9f] (fwd forms)
  float* du;            // [n, f] (du and dq)
  float* dd;            // [n, k] (dq, series base)
  float* drbf;          // [n, k, t] (dq, rbf base)
  float* dcw;           // [n, k] (dq)
  long long n;
  int k, f, t, t4;
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
  __shared__ float sCw[TM], sTheta[TM], sDcw[TM], sDd[TM];
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
  if (MODE != kDq)
    for (int v = tid; v < nrows * F9; v += kThreads) p.out[r0 * F9 + v] = 0.0f;
  if (kBwd)
    for (int v = tid; v < nrows * F; v += kThreads) p.du[r0 * F + v] = 0.0f;
  if (MODE == kDq) {
    for (int v = tid; v < total; v += kThreads) {
      if (!RBF) p.dd[g0 + v] = 0.0f;
      p.dcw[g0 + v] = 0.0f;
    }
    if (RBF)
      for (long long v = tid; v < (long long)total * T; v += kThreads)
        p.drbf[g0 * T + v] = 0.0f;
  }

  const uint8_t* mask = p.mask + g0;
  const float* cwb = p.cw + g0;
  for (int q0 = 0; q0 < total; q0 += kListCap) {
    const int cn = min(kListCap, total - q0);
    // live slots of the chunk: cw ≠ 0 first (in slot order), then, for
    // dq, cw = 0
    int n_live = compact(
        cn, [&](int s) { return mask[q0 + s] && cwb[q0 + s] != 0.0f; },
        sList, 0, sWarp);
    int n_all = n_live;
    if (MODE == kDq)
      n_all += compact(
          cn, [&](int s) { return mask[q0 + s] && cwb[q0 + s] == 0.0f; },
          sList, n_live, sWarp);

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
      sDcw[tid] = 0.0f;
      sDd[tid] = 0.0f;
    }
    __syncthreads();
    // the backprop is needed only if some slot of the tile has cw ≠ 0
    const bool bwd_tile = kBwd && __syncthreads_or(tid < TM && sCw[tid] != 0.0f);
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
          sT[e * ldt + cl] = MODE == kDq ? silu(z) : silu(z) * sCw[e];
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
          if (MODE != kDq && r != cur) {
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
            if (MODE != kDq) sum[q] = fmaf(h, x, sum[q]);
            if (kBwd) fold = fmaf(p.grow[(r0 + r) * F9 + (dlo + q) * F + f], x, fold);
          }
          if (MODE == kFwdDu) {
            sDZ[e * ldz + c] = fold * sCw[e] * sG[e * ldt + cl];
          } else if (MODE == kDq) {
            sT[e * ldt + cl] = fold * h;  // dcw term, reduced below
            sDZ[e * ldz + c] = fold * sCw[e] * sG[e * ldt + cl];
          }
        }
        if (MODE != kDq && cur >= 0)
          for (int q = 0; q < dn; ++q) p.out[(r0 + cur) * F9 + (dlo + q) * F + f] += sum[q];
      }
      if (MODE == kDq) {
        __syncthreads();
        // dcw[e] += Σ over this block's columns, one warp per slot
        const int lane = tid % 32, warp = tid / 32;
        const int ncl = min(kTileN, F3 - c0);
        for (int e = warp; e < TM; e += kThreads / 32) {
          float v = 0.0f;
          for (int cl = lane; cl < ncl; cl += 32) v += sT[e * ldt + cl];
#pragma unroll
          for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) sDcw[e] += v;
        }
      }
    }

    if (bwd_tile) {
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
      if (MODE == kDq && RBF) {
        // ---- drbf[e] = dpre·W1aᵀ, stored from the registers
        for (int c0 = 0; c0 < T; c0 += kTileN) {
          tile_product<RM>(sA, lda, p.w1at, F, p.t4, c0, sW, acc);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const long long g = sSlot[ty * RM + i];
            if (g < 0) continue;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = c0 + tx + 16 * j;
              if (col < T) p.drbf[g * T + col] = acc[i][j];
            }
          }
        }
      } else if (MODE == kDq) {
        // ---- dd[e] = Σ_f dpre·(basis·dser)
        for (int c0 = 0; c0 < F; c0 += kTileN) {
          tile_product<RM>(sBasis, ldb, p.dser, T, F, c0, sW, acc);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const int e = ty * RM + i;
            float v = 0.0f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = c0 + tx + 16 * j;
              if (col < F) v = fmaf(acc[i][j], sA[e * lda + col], v);
            }
#pragma unroll
            for (int off = 8; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off, 16);
            if (tx == 0) sDd[e] += v;
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
    if (MODE == kDq && tid < TM && sSlot[tid] >= 0) {
      p.dcw[sSlot[tid]] = sDcw[tid];
      if (!RBF) p.dd[sSlot[tid]] = sDd[tid];
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
// dd [n,k] (the x-derivative) and dcw [n,k].
int tmd_blocked_q_dq(const float* d, const float* cw, const uint8_t* mask,
                     const long long* idx, const float* urow,
                     const float* ucol, const float* xwin, const float* grow,
                     const float* coeffs, const float* dser, const float* w2,
                     const float* b2, const float* w3, const float* b3,
                     const float* w2t, const float* w3t, float* du, float* dd,
                     float* dcw, long long n, int k, int f, int t, float lo,
                     float span, void* stream) {
  QParams p = make_params(false, d, cw, mask, idx, urow, ucol, xwin, coeffs,
                          w2, b2, w3, b3, n, k, f, t, lo, span);
  p.grow = grow; p.dser = dser; p.w2t = w2t; p.w3t = w3t;
  p.du = du; p.dd = dd; p.dcw = dcw;
  return launch<kDq, false>(p, stream);
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

// Kernel B, exact rbf: w1at [f, r4] (W1aᵀ, zero columns up to r4, a multiple
// of 4); writes du [n,f], drbf [n,k,r] and dcw [n,k].
int tmd_blocked_q_dq_rbf(const float* rbf, const float* cw,
                         const uint8_t* mask, const long long* idx,
                         const float* urow, const float* ucol,
                         const float* xwin, const float* grow,
                         const float* w1a, const float* w1at, const float* w2,
                         const float* b2, const float* w3, const float* b3,
                         const float* w2t, const float* w3t, float* du,
                         float* drbf, float* dcw, long long n, int k, int f,
                         int r, int r4, void* stream) {
  QParams p = make_params(true, rbf, cw, mask, idx, urow, ucol, xwin, w1a, w2,
                          b2, w3, b3, n, k, f, r, 0.0f, 1.0f);
  p.grow = grow; p.w1at = w1at; p.t4 = r4; p.w2t = w2t; p.w3t = w3t;
  p.du = du; p.drbf = drbf; p.dcw = dcw;
  return launch<kDq, true>(p, stream);
}

}  // extern "C"
