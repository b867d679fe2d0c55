// TensorNet2 fused charge-fold message passing (the q-tier) for Hopper
// (sm_90a), float32-accurate: kernels A and B run their products on the
// tensor cores in 3xTF32 (csrc/tc_tile.cuh; never single-pass TF32).
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
// TFLOP/s fp32, 495 TFLOP/s TF32 on the tensor cores): kernel A's products
// over the ~0.92 M slots with cw ≠ 0 (base 8,192 or 4,096, W2 32,768, W3
// 98,304 FMA a slot) are ~0.26 TFLOP, ~1.6 ms as three TF32 products each
// on the tensor cores; with du the W3ᵀ/W2ᵀ backprop doubles W2 and W3
// (~0.50 TFLOP, ~3.0 ms).  Its neighbour sum and fold (9F FMA a slot each)
// run in fp32 beside them.  Kernel B runs the forward chain on all ~1.79 M
// valid slots and the backprop on the live ones, ~0.76 TFLOP of products:
// ~4.6 ms.  The exact base reads the [N, K, R] rbf (332 MB at K = 96; B
// writes its cotangent, as much): ~0.1 ms of bytes each.
//
// One chain serves both kernels (q_chain): a block owns 16 sorted rows
// (kQRows) and walks their valid slots, compacted per chunk of kQChunk
// slots in slot order, in tiles of 64: kernel A takes the slots with
// cw ≠ 0 only (the others' terms are exactly zero), kernel B those first
// (the live slots) and then cw = 0.  Per tile, in sX [64][3F + 4] and sZ
// [64][2F + 4]:
//   base   pre1 = base + urow + ucol; silu(pre1) into sX[:, 2F:3F]
//   W2     z2 = silu(pre1)·W2 + b2 into sZ (not for A without du),
//          silu(z2) into sX[:, 0:2F]
//   W3     z3 = silu(z2)·W3 + b3 per 128-column pass, put into the free
//          ring.  B: a warp a slot gathers its fold from g9 and xwin[j]
//          (float4 rows), adds fold·silu(z3) into dcw and, on a tile with
//          a live slot, puts dz3 = fold·cw·dsilu(z3) into the dz3 plane.
//          A with du: the same fold and dz3, and silu(z3)·cw back into
//          the ring; A puts silu(z3)·cw into the ring itself.  Then A's
//          neighbour sum: a thread a (column, irrep) of the pass adds
//          silu(z3)·cw·xwin[j] over the tile's slots, in slot order, into
//          its row's out[n, d·F + f] (a row that spans tiles adds in tile
//          order; the block owns its rows, so no atomics).
// and on a tile with a live slot, with du or in B:
//   W3ᵀ    dz2 = (dz3·W3ᵀ) ⊙ dsilu(z2), over z2 in sZ
//   base   pre1 again, into sX[:, 0:F] (dz3 is consumed)
//   W2ᵀ    dpre = (dz2·W2ᵀ) ⊙ dsilu(pre1), over pre1
//   du     the row sums of dpre, one thread a channel, slots in order
//   base′  B only: dd = Σ_f dpre·(B(θ)·dser), or drbf = dpre·W1aᵀ
// Every product is tc_product_from on the split images, one 128-column
// pass at a time.  dcw is summed per slot by one warp's shuffles, then
// over the passes in order; dd is folded from the accumulators: per
// thread, by shuffles within the quad that shares a slot, then over the
// two warpgroups in order.  No atomics: the same result on every run.
//
// Where the tiles live (kWide).  For F ≤ 128 sX and sZ sit in shared
// memory beside the 48 KB ring (221,216 B for B at F = 128, K = 96), and
// dz3 overwrites silu(z2), which every W3 pass reads: the passes whose
// columns start at 2F or beyond run first, the last below 2F stores after
// its product and the one before it (at most one for F ≤ 128) is held in
// registers until then.  Above F = 128 the tiles do not fit a block, and
// each resident block keeps them in its own region of a device-memory
// scratch (the wrapper allocates it; the grid is then one block an SM,
// each walking the row blocks b, b + grid, ...): the same fragment source
// reads them there, as the exact base reads its rbf rows, and dz3 gets a
// plane of its own, so no pass is held.  Its products, whose sums run
// over K = 3F past 384 terms, sum each stage apart and add it in fp32
// (tc_product_from's kStageSums, as rows 5 and 7 do).  Every width the
// JAX op computes launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

constexpr int kPad = 4;
constexpr int kQRows = 16;      // sorted rows a block owns
constexpr int kQChunk = 4096;   // slots it compacts at a time (16-bit ids)
constexpr int kWarps = kTcThreads / 32;

enum Mode { kA = 0, kADu = 1, kB = 2 };

struct QParams {
  const float* d;       // [n, k] (series base)
  const float* rbf;     // [n, k, r] (rbf base)
  const float* cw;      // [n, k]
  const uint8_t* mask;  // [n, k]
  const long long* idx; // [n, k]
  const float* urow;    // [n, f]
  const float* ucol;    // [n, f]
  const float* xwin;    // [n, 9f]
  const float* grow;    // [n, 9f] (A with du, B)
  const float* b2;      // [2f]
  const float* b3;      // [3f]
  // split images (tc_split): the base (coeffs [t, f] or W1a [r, f]), W2
  // [f, 2f], W3 [2f, 3f]; with du and in B W3ᵀ [3f, 2f] and W2ᵀ [2f, f];
  // in B the base's cotangent (dser [t, f] or W1aᵀ [f, r])
  const float* img_base;
  const float* img2;
  const float* img3;
  const float* img3t;
  const float* img2t;
  const float* img_cot;
  float* tiles;         // the wide form's per-block tiles (q_tile_floats)
  float* out;           // [n, 9f] (A)
  float* du;            // [n, f] (A with du, B)
  float* dd;            // [n, k] (B, series base)
  float* drbf;          // [n, k, r] (B, rbf base)
  float* dcw;           // [n, k] (B)
  long long n;
  int k, f, t;          // t: series terms, or the rbf width r
  float lo, span;       // span = hi − lo
};

__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float silu(float x) { return x * sigm(x); }
__device__ __forceinline__ float dsilu(float x) {
  const float s = sigm(x);
  return s * (1.0f + x * (1.0f - s));
}

// Slot ids a block compacts at a time.
__host__ __device__ __forceinline__ int q_list_cap(int k) {
  return kQRows * k < kQChunk ? kQRows * k : kQChunk;
}

// Floats of a block's activation tiles: sX [64][3F + 4]; with du and in B
// sZ [64][2F + 4], and in the wide form the dz3 plane [64][3F + 4].
__host__ __device__ __forceinline__ long long q_tile_floats(int mode, int f,
                                                            bool wide) {
  long long x = (long long)kTcM * (3 * f + kPad);
  if (mode != kA) x += (long long)kTcM * (2 * f + kPad);
  if (mode != kA && wide) x += (long long)kTcM * (3 * f + kPad);
  return x;
}

__host__ __device__ __forceinline__ bool q_wide(int f) { return f > kTcN; }

// Dynamic shared memory of a launch (ops/blocked_q.py::q_smem keeps the
// same sum): 1 KB to align the ring, the ring, the tiles (narrow form
// only), the [2][64] warpgroup sums, dcw, cw and θ, the tile's rows,
// neighbours and slot offsets, the warp counts, the slot ids.
size_t q_smem(int mode, int f, int k) {
  const size_t tiles = q_wide(f) ? 0 : (size_t)q_tile_floats(mode, f, false);
  return 1024 + sizeof(float) * ((size_t)kTcRegion + tiles + 5 * kTcM) +
         sizeof(int) * (3 * kTcM + kWarps) +
         sizeof(unsigned short) * q_list_cap(k);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
// First irrep of weight block w: I = 0, A = 1..3, S = 4..8.
__device__ __forceinline__ int first_irrep(int w) { return w == 0 ? 0 : (w == 1 ? 1 : 4); }

// The chain of kernel A (MODE kA), A with du (kADu) and B (kB), above.
template <int MODE, bool RBF, bool kWide>
__device__ __forceinline__ void q_chain(const QParams& p) {
  constexpr bool kDu = MODE != kA;  // z2 kept, the backprop runs
  extern __shared__ __align__(16) float smem[];
  const int F = p.f, F2 = 2 * F, F3 = 3 * F, F9 = 9 * F, T = p.t, K = p.k;
  const int ldx = F3 + kPad, ldz = F2 + kPad;
  float* sR = smem + tc_region_offset(smem);  // the ring
  float* sX;                                  // [64][3F + pad]
  float* sZ;                                  // [64][2F + pad]  z2, then dz2
  float* sD;                                  // [64][3F + pad]  dz3
  float* sRed;
  if constexpr (kWide) {
    sX = p.tiles + (long long)blockIdx.x * q_tile_floats(MODE, F, true);
    sZ = sX + kTcM * ldx;
    sD = sZ + kTcM * ldz;
    sRed = sR + kTcRegion;
  } else {
    sX = sR + kTcRegion;
    sZ = sX + kTcM * ldx;
    sD = sX;  // dz3 overwrites silu(z2)
    sRed = sZ + (kDu ? kTcM * ldz : 0);
  }
  float* sDcw = sRed + 2 * kTcM;              // [64]
  float* sCw = sDcw + kTcM;                   // [64]
  float* sTheta = sCw + kTcM;                 // [64]
  int* sRow = reinterpret_cast<int*>(sTheta + kTcM);  // [64] block row, −1 past the tile
  int* sJ = sRow + kTcM;                      // [64] neighbour row
  int* sOff = sJ + kTcM;                      // [64] slot offset in the block
  int* sCount = sOff + kTcM;                  // [kWarps]
  unsigned short* sList = reinterpret_cast<unsigned short*>(sCount + kWarps);

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int cap = q_list_cap(K);
  const int np1 = (F + kTcN - 1) / kTcN, np2 = (F2 + kTcN - 1) / kTcN,
            np3 = (F3 + kTcN - 1) / kTcN;
  const int fr0 = tc_row(0), fr1 = tc_row(1);  // this thread's fragment rows
  const long long nrb = (p.n + kQRows - 1) / kQRows;

  for (long long rb = blockIdx.x; rb < nrb; rb += gridDim.x) {
  const long long r0 = rb * kQRows;
  const int nrows = (int)min((long long)kQRows, p.n - r0);
  const long long g0 = r0 * K;  // first slot of the block
  const int total = nrows * K;

  // A: out (and du) start at 0, so rows without a live slot stay 0; B:
  // du starts at 0, invalid slots get exact zeros
  if constexpr (MODE != kB) {
    float4* o = reinterpret_cast<float4*>(p.out + r0 * F9);
    for (int v = tid; v < nrows * F9 / 4; v += kTcThreads)
      o[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if constexpr (kDu)
    for (int v = tid; v < nrows * F; v += kTcThreads) p.du[r0 * F + v] = 0.0f;
  if constexpr (MODE == kB) {
    for (int s = tid; s < total; s += kTcThreads) {
      if (p.mask[g0 + s]) continue;
      p.dcw[g0 + s] = 0.0f;
      if (!RBF) p.dd[g0 + s] = 0.0f;
    }
    if (RBF)
      for (long long v = tid; v < (long long)total * T; v += kTcThreads)
        if (!p.mask[g0 + v / T]) p.drbf[g0 * T + v] = 0.0f;
  }

  // the tile's base product, pass pz: B(θ)·coeffs or rbf·W1a
  auto base = [&](float (&acc)[8][4], int pz) {
    if constexpr (RBF) {
      const float* a0 = p.rbf + (g0 + sOff[sRow[fr0] >= 0 ? fr0 : 0]) * T;
      const float* a1 = p.rbf + (g0 + sOff[sRow[fr1] >= 0 ? fr1 : 0]) * T;
      tc_product_from<kWide>(TcActivation{a0, a1, T}, p.img_base, T, pz, sR, acc);
    } else {
      tc_product_from<kWide>(TcCosBasis{sTheta[fr0], sTheta[fr1], T}, p.img_base, T,
                      pz, sR, acc);
    }
  };
  // pre1 = acc + urow[row] + ucol[j] (0 on rows past the tile) of pass pz
  // through op, stored at column col0 + c of sX
  auto store_pre1 = [&](const float (&acc)[8][4], int pz, int col0, auto op) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tc_row(h), row = sRow[r];
      const float* ur = p.urow + (r0 + max(row, 0)) * F;
      const float* uc = p.ucol + (long long)sJ[r] * F;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = pz * kTcN + tc_col(i);  // even; F is a multiple of 4
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
  // A's neighbour sum of W3 pass pz over the tile's nt slots, from
  // silu(z3)·cw in the ring: thread (column, irrep) adds its rows' slots in
  // slot order into out[row, d·F + f]
  auto out_sums = [&](int pz, int nt) {
    const int cl = tid & (kTcN - 1), c = pz * kTcN + cl;
    if (c >= F3) return;
    const int w = c / F, f = c - w * F, d0 = first_irrep(w);
    for (int q = wg; q <= 2 * w; q += 2) {
      const float* xq = p.xwin + (d0 + q) * F + f;
      float* oq = p.out + r0 * F9 + (d0 + q) * F + f;
      int cur = sRow[0];
      float sum = 0.0f;
      for (int e0 = 0; e0 < nt; e0 += 8) {
        float x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          x[u] = e0 + u < nt ? __ldg(xq + (long long)sJ[e0 + u] * F9) : 0.0f;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = e0 + u;
          if (e >= nt) break;
          const int r = sRow[e];
          if (r != cur) {
            oq[(long long)cur * F9] += sum;
            sum = 0.0f;
            cur = r;
          }
          sum = fmaf(sR[e * kTcLdW + cl], x[u], sum);
        }
      }
      oq[(long long)cur * F9] += sum;
    }
  };
  float acc[8][4];
  float4 held[kTcM / kWarps];  // a pass's dz3 kept past the next product
  for (int q0 = 0; q0 < total; q0 += cap) {
    const int cn = min(cap, total - q0);
    const uint8_t* mk = p.mask + g0 + q0;
    const float* cwq = p.cw + g0 + q0;
    const int n_live = tc_compact(
        cn, [&](int s) { return mk[s] && cwq[s] != 0.0f; }, sList, 0, sCount);
    int n_all = n_live;
    if constexpr (MODE == kB)
      n_all += tc_compact(
          cn, [&](int s) { return mk[s] && cwq[s] == 0.0f; }, sList, n_live,
          sCount);

    for (int t0 = 0; t0 < n_all; t0 += kTcM) {
      const int nt = min(kTcM, n_all - t0);
      const bool bwd = kDu && t0 < n_live;  // the tile has a slot with cw ≠ 0
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
      for (int pz = 0; pz < np1; ++pz) {
        base(acc, pz);
        store_pre1(acc, pz, F2, [](float x) { return silu(x); });
      }
      for (int pz = 0; pz < np2; ++pz) {
        __syncthreads();  // silu(pre1) is written
        tc_product_from<kWide>(TcActivation{sX + fr0 * ldx + F2, sX + fr1 * ldx + F2, F},
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
            if (kDu) st2(sZ + r * ldz + col, x, y);
            st2(sX + r * ldx + col, silu(x), silu(y));
          }
        }
      }

      // ---- z3 per pass: dcw and dz3 (B, A with du), A's neighbour sum
      if (MODE == kB && tid < kTcM) sDcw[tid] = 0.0f;
      for (int step = 0; step < np3; ++step) {
        const int pz = (step + np2) % np3;  // passes np2.., then 0..np2 − 1
        __syncthreads();  // silu(z2) is written; sR's z3 tile is read
        tc_product_from<kWide>(TcActivation{sX + fr0 * ldx, sX + fr1 * ldx, F2},
                        p.img3, F2, pz, sR, acc);
        // the pass's z3 − b3 [64][kTcLdW] over the free ring (A: silu(z3)·cw)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = acc[i][2 * h], y = acc[i][2 * h + 1];
            if constexpr (MODE == kA) {
              const int col = pz * kTcN + tc_col(i);
              if (col >= F3) continue;
              const float2 b = ld2(p.b3 + col);
              const float c = sCw[tc_row(h)];
              x = silu(x + b.x) * c;
              y = silu(y + b.y) * c;
            }
            st2(sR + tc_row(h) * kTcLdW + tc_col(i), x, y);
          }
        __syncthreads();
        if constexpr (MODE != kA) {
          // a warp takes one slot's 128 columns, 4 a lane, 8 slots a pass:
          // the fold from coalesced g9 and xwin[j] rows, Σ fold·silu(z3)
          // into dcw (B: the warp's shuffles, then slot order by pass), and
          // dz3; A with du puts silu(z3)·cw back into the ring
          const bool hold = !kWide && bwd && pz < np2 - 1;  // it would overwrite
                                                            // what pass pz + 1 reads
          const bool last = !kWide && bwd && pz == np2 - 1 && np2 > 1;
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
              float4* zp = reinterpret_cast<float4*>(sR + e * kTcLdW + 4 * q);
              const float4 z0 = *zp;
              const float4 bb = *reinterpret_cast<const float4*>(p.b3 + col);
              const float c = sCw[e];
              const float z[4] = {z0.x + bb.x, z0.y + bb.y, z0.z + bb.z, z0.w + bb.w};
              const float fv[4] = {fo.x, fo.y, fo.z, fo.w};
              float d[4], hc[4];
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const float sg = sigm(z[u]);
                if (MODE == kB) part = fmaf(fv[u], z[u] * sg, part);
                d[u] = fv[u] * c * (sg * (1.0f + z[u] * (1.0f - sg)));
                hc[u] = z[u] * sg * c;
              }
              dz = make_float4(d[0], d[1], d[2], d[3]);
              if (MODE == kADu) *zp = make_float4(hc[0], hc[1], hc[2], hc[3]);
            }
            if constexpr (MODE == kB) {
#pragma unroll
              for (int off = 16; off > 0; off >>= 1)
                part += __shfl_xor_sync(0xffffffffu, part, off);
              if (lane == 0) sDcw[e] += part;
            }
            if (hold) {
              held[m] = dz;
            } else if (bwd) {
              if (col < F3) *reinterpret_cast<float4*>(sD + e * ldx + col) = dz;
              if (last)  // the held pass's columns, below F3 where np2 = 2
                *reinterpret_cast<float4*>(sD + e * ldx + col - kTcN) = held[m];
            }
          }
        }
        if constexpr (MODE != kB) {
          if (MODE == kADu) __syncthreads();  // silu(z3)·cw is in the ring
          out_sums(pz, nt);
        }
      }
      __syncthreads();
      if constexpr (MODE == kB) {
        if (tid < nt) p.dcw[g0 + sOff[tid]] = sDcw[tid];
      }
      if (!bwd) {  // A; or B with every slot at cw = 0: its base cotangent is 0
        if constexpr (MODE == kB) {
          if (RBF) {
            for (int v = tid; v < nt * T; v += kTcThreads)
              p.drbf[(g0 + sOff[v / T]) * T + v % T] = 0.0f;
          } else if (tid < nt) {
            p.dd[g0 + sOff[tid]] = 0.0f;
          }
          __syncthreads();  // the tile's metadata is read
        }
        continue;
      }

      // ---- backward: dz2 over z2
      for (int pz = 0; pz < np2; ++pz) {
        __syncthreads();  // dz3 is written
        tc_product_from<kWide>(TcActivation{sD + fr0 * ldx, sD + fr1 * ldx, F3},
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
      for (int pz = 0; pz < np1; ++pz) {
        base(acc, pz);
        store_pre1(acc, pz, 0, [](float x) { return x; });
      }
      __syncthreads();  // dz2 is written
      for (int pz = 0; pz < np1; ++pz) {
        tc_product_from<kWide>(TcActivation{sZ + fr0 * ldz, sZ + fr1 * ldz, F2},
                        p.img2t, F2, pz, sR, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = pz * kTcN + tc_col(i);
          if (col >= F) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* x = sX + tc_row(h) * ldx + col;
            const float2 v = ld2(x);
            st2(x, acc[i][2 * h] * dsilu(v.x), acc[i][2 * h + 1] * dsilu(v.y));
          }
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
      // B: the base's cotangent
      if constexpr (MODE == kB) {
        if (RBF) {
          for (int pz = 0; pz * kTcN < T; ++pz) {
            tc_product_from<kWide>(TcActivation{sX + fr0 * ldx, sX + fr1 * ldx, F},
                            p.img_cot, F, pz, sR, acc);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = tc_row(h);
              if (r >= nt) continue;
              float* out = p.drbf + (g0 + sOff[r]) * T;
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int col = pz * kTcN + tc_col(i);
                if (col < T) out[col] = acc[i][2 * h];
                if (col + 1 < T) out[col + 1] = acc[i][2 * h + 1];
              }
            }
          }
        } else {
          float dpart[2] = {0.0f, 0.0f};
          for (int pz = 0; pz < np1; ++pz) {
            tc_product_from<kWide>(TcCosBasis{sTheta[fr0], sTheta[fr1], T}, p.img_cot,
                            T, pz, sR, acc);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int col = pz * kTcN + tc_col(i);
              if (col >= F) continue;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 v = ld2(sX + tc_row(h) * ldx + col);
                dpart[h] = fmaf(acc[i][2 * h], v.x, dpart[h]);
                dpart[h] = fmaf(acc[i][2 * h + 1], v.y, dpart[h]);
              }
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
      }
      __syncthreads();  // the tile's metadata and sRed are read
    }
  }
  __syncthreads();  // the row block's slot ids are read
  }
}

// Kernel A (kDu: with du).
template <bool kDu, bool RBF, bool kWide>
__global__ void __launch_bounds__(kTcThreads, 1) q_tc_kernel(QParams p) {
  q_chain<kDu ? kADu : kA, RBF, kWide>(p);
}

// Kernel B.
template <bool RBF, bool kWide>
__global__ void __launch_bounds__(kTcThreads, 1) dq_tc_kernel(QParams p) {
  q_chain<kB, RBF, kWide>(p);
}

template <bool RBF, bool kWide>
const void* kernel_of(int mode) {
  if (mode == kA) return (const void*)q_tc_kernel<false, RBF, kWide>;
  if (mode == kADu) return (const void*)q_tc_kernel<true, RBF, kWide>;
  return (const void*)dq_tc_kernel<RBF, kWide>;
}

const void* kernel_of(int mode, bool rbf, bool wide) {
  return rbf ? (wide ? kernel_of<true, true>(mode) : kernel_of<true, false>(mode))
             : (wide ? kernel_of<false, true>(mode) : kernel_of<false, false>(mode));
}

// Floats of the image scratch of mode at (f, t): the base's, W2's and
// W3's split images; with du and in B W3ᵀ's and W2ᵀ's; in B the
// cotangent's.
int q_image_floats(int mode, int f, int t, bool rbf) {
  int x = tc_image_floats(t, f) + tc_image_floats(f, 2 * f) +
          tc_image_floats(2 * f, 3 * f);
  if (mode != kA) x += tc_image_floats(3 * f, 2 * f) + tc_image_floats(2 * f, f);
  if (mode == kB) x += rbf ? tc_image_floats(f, t) : tc_image_floats(t, f);
  return x;
}

// Splits the weights of mode into image (q_image_floats), fills in the
// image pointers of p and launches grid blocks: the row blocks' count, or
// fewer in the wide form, whose tiles p.tiles holds (grid ×
// q_tile_floats).  base and cot are the base's weight [t, f] and its
// cotangent's: dser [t, f], or with rbf W1a again, split as W1aᵀ [f, t].
int q_launch(int mode, bool rbf, QParams p, const float* base, const float* cot,
             const float* w2, const float* w3, float* image, int grid,
             void* stream) {
  const int f = p.f, t = p.t;
  if (f < 4 || f % 4 || t < 1 || grid < 1) return cudaErrorInvalidValue;
  const bool wide = q_wide(f);
  if (wide && p.tiles == nullptr) return cudaErrorInvalidValue;
  struct Piece { const float* w; int kdim, ncols; bool trans; const float** img; };
  const Piece pieces[] = {{base, t, f, false, &p.img_base},
                          {w2, f, 2 * f, false, &p.img2},
                          {w3, 2 * f, 3 * f, false, &p.img3},
                          {w3, 3 * f, 2 * f, true, &p.img3t},
                          {w2, 2 * f, f, true, &p.img2t},
                          {cot, rbf ? f : t, rbf ? t : f, rbf, &p.img_cot}};
  const int npieces = mode == kA ? 3 : (mode == kADu ? 5 : 6);
  float* at = image;
  for (int i = 0; i < npieces; ++i) {
    const Piece& q = pieces[i];
    const int rc = tc_split(q.w, q.kdim, q.ncols, at, stream, q.trans);
    if (rc != cudaSuccess) return rc;
    *q.img = at;
    at += tc_image_floats(q.kdim, q.ncols);
  }
  const void* kern = kernel_of(mode, rbf, wide);
  const size_t smem = q_smem(mode, f, p.k);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (p.n == 0) return cudaSuccess;
  void* args[] = {&p};
  err = cudaLaunchKernel(kern, dim3((unsigned)grid), dim3(kTcThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

QParams make_params(const float* cw, const uint8_t* mask, const long long* idx,
                    const float* urow, const float* ucol, const float* xwin,
                    const float* grow, const float* b2, const float* b3,
                    float* tiles, long long n, int k, int f, int t) {
  QParams p{};
  p.cw = cw; p.mask = mask; p.idx = idx; p.urow = urow; p.ucol = ucol;
  p.xwin = xwin; p.grow = grow; p.b2 = b2; p.b3 = b3; p.tiles = tiles;
  p.n = n; p.k = k; p.f = f; p.t = t; p.lo = 0.0f; p.span = 1.0f;
  return p;
}

}  // namespace

extern "C" {

const char* tmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Every entry point: image [tmd_blocked_q_image_floats(mode, f, t, rbf)]
// scratch; tiles [grid · tmd_blocked_q_tile_floats(mode, f)] scratch
// (null for f ≤ 128); grid the row blocks' count ⌈n/16⌉, or for f > 128
// at most that; f a multiple of 4.

// Kernel A.  d, cw [n,k]; mask [n,k] bytes; idx [n,k] int64; urow, ucol
// [n,f]; xwin [n,9f]; coeffs [t,f]; w2 [f,2f]; b2 [2f]; w3 [2f,3f]; b3 [3f];
// out [n,9f].
int tmd_blocked_q_fwd(const float* d, const float* cw, const uint8_t* mask,
                      const long long* idx, const float* urow,
                      const float* ucol, const float* xwin, const float* coeffs,
                      const float* w2, const float* b2, const float* w3,
                      const float* b3, float* out, float* image, float* tiles,
                      long long n, int k, int f, int t, float lo, float span,
                      int grid, void* stream) {
  QParams p = make_params(cw, mask, idx, urow, ucol, xwin, nullptr, b2, b3,
                          tiles, n, k, f, t);
  p.d = d; p.out = out; p.lo = lo; p.span = span;
  return q_launch(kA, false, p, coeffs, nullptr, w2, w3, image, grid, stream);
}

// Kernel A with du: as above plus grow [n,9f] and du [n,f].
int tmd_blocked_q_fwd_du(const float* d, const float* cw, const uint8_t* mask,
                         const long long* idx, const float* urow,
                         const float* ucol, const float* xwin,
                         const float* grow, const float* coeffs,
                         const float* w2, const float* b2, const float* w3,
                         const float* b3, float* out, float* du, float* image,
                         float* tiles, long long n, int k, int f, int t,
                         float lo, float span, int grid, void* stream) {
  QParams p = make_params(cw, mask, idx, urow, ucol, xwin, grow, b2, b3,
                          tiles, n, k, f, t);
  p.d = d; p.out = out; p.du = du; p.lo = lo; p.span = span;
  return q_launch(kADu, false, p, coeffs, nullptr, w2, w3, image, grid, stream);
}

// Kernel B: xwin = feats9, grow = g9 [n,9f], dser [t,f]; writes du [n,f],
// dd [n,k] (the x-derivative) and dcw [n,k].
int tmd_blocked_q_dq(const float* d, const float* cw, const uint8_t* mask,
                     const long long* idx, const float* urow,
                     const float* ucol, const float* xwin, const float* grow,
                     const float* coeffs, const float* dser, const float* w2,
                     const float* b2, const float* w3, const float* b3,
                     float* du, float* dd, float* dcw, float* image,
                     float* tiles, long long n, int k, int f, int t, float lo,
                     float span, int grid, void* stream) {
  QParams p = make_params(cw, mask, idx, urow, ucol, xwin, grow, b2, b3,
                          tiles, n, k, f, t);
  p.d = d; p.du = du; p.dd = dd; p.dcw = dcw; p.lo = lo; p.span = span;
  return q_launch(kB, false, p, coeffs, dser, w2, w3, image, grid, stream);
}

// The exact-rbf forms: rbf [n,k,r] in place of d, W1a [r,f] in place of
// coeffs; r any width.
int tmd_blocked_q_fwd_rbf(const float* rbf, const float* cw,
                          const uint8_t* mask, const long long* idx,
                          const float* urow, const float* ucol,
                          const float* xwin, const float* w1a, const float* w2,
                          const float* b2, const float* w3, const float* b3,
                          float* out, float* image, float* tiles, long long n,
                          int k, int f, int r, int grid, void* stream) {
  QParams p = make_params(cw, mask, idx, urow, ucol, xwin, nullptr, b2, b3,
                          tiles, n, k, f, r);
  p.rbf = rbf; p.out = out;
  return q_launch(kA, true, p, w1a, nullptr, w2, w3, image, grid, stream);
}

int tmd_blocked_q_fwd_du_rbf(const float* rbf, const float* cw,
                             const uint8_t* mask, const long long* idx,
                             const float* urow, const float* ucol,
                             const float* xwin, const float* grow,
                             const float* w1a, const float* w2,
                             const float* b2, const float* w3, const float* b3,
                             float* out, float* du, float* image, float* tiles,
                             long long n, int k, int f, int r, int grid,
                             void* stream) {
  QParams p = make_params(cw, mask, idx, urow, ucol, xwin, grow, b2, b3,
                          tiles, n, k, f, r);
  p.rbf = rbf; p.out = out; p.du = du;
  return q_launch(kADu, true, p, w1a, nullptr, w2, w3, image, grid, stream);
}

// Kernel B, exact rbf: writes du [n,f], drbf [n,k,r] and dcw [n,k].
int tmd_blocked_q_dq_rbf(const float* rbf, const float* cw,
                         const uint8_t* mask, const long long* idx,
                         const float* urow, const float* ucol,
                         const float* xwin, const float* grow,
                         const float* w1a, const float* w2, const float* b2,
                         const float* w3, const float* b3, float* du,
                         float* drbf, float* dcw, float* image, float* tiles,
                         long long n, int k, int f, int r, int grid,
                         void* stream) {
  QParams p = make_params(cw, mask, idx, urow, ucol, xwin, grow, b2, b3,
                          tiles, n, k, f, r);
  p.rbf = rbf; p.du = du; p.drbf = drbf; p.dcw = dcw;
  return q_launch(kB, true, p, w1a, w1a, w2, w3, image, grid, stream);
}

// Floats of the image scratch of mode (0 = A, 1 = A with du, 2 = B) at
// (f, t) (rbf: t is the rbf width).
int tmd_blocked_q_image_floats(int mode, int f, int t, int rbf) {
  return q_image_floats(mode, f, t, rbf != 0);
}

// Floats of one resident block's tiles in device memory (0 for f ≤ 128).
long long tmd_blocked_q_tile_floats(int mode, int f) {
  return q_wide(f) ? q_tile_floats(mode, f, true) : 0;
}

// What the compiler and the launch give mode (rbf: its exact form) at
// (f, k): out = registers a thread, local (spill) bytes a thread, static
// and dynamic shared memory bytes a block, resident blocks an SM.
int tmd_blocked_q_attributes(int mode, int rbf, int f, int k, int* out) {
  const void* kern = kernel_of(mode, rbf != 0, q_wide(f));
  const size_t smem = q_smem(mode, f, k);
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
