// Windowed direct-pair reaction-field Coulomb for Hopper (sm_90a): kernel C
// (the forward) and kernel D (its backward), float32-accurate, their
// channel contractions on the tensor cores in 3xTF32 (never single-pass
// TF32).
//
// Replaces the Pallas TPU kernels of torchmdnet_tpu/ops/pallas_coulomb.py:
//   kernel C  _wc_fwd_kernel (:280, pallas_call :407)
//     Φ[i, c] = Σ_j G(d_ij)·b[j, c]
//   kernel D  _wc_bwd_kernel (:297, pallas_call :446)
//     S2[i, c] = Σ_j G(d_ij)·ct[j]·b[j, c]
//     dpos[i]  = Σ_j G'(d_ij)·pd_ij·(ct[i] + ct[j])/d_ij·Δ_ij,
//     pd_ij    = Σ_c qw[c]·b[i, c]·b[j, c]
// for the rows i of each cell block, over the partner rows j of the
// block's exact stencil-window pieces (ops/cell_blocks.py), with 0 < d²
// (> 1e-12) and d < rc, Δ_ij the minimum-image delta (one rint per axis,
// rounded as ops/windowed_coulomb.py::_pair_blocks rounds it) and G(d) =
// factor·(1 − f_exp(d))·(1/d + k_rf·d² − c_rf) (ops/coulomb.py::
// g_and_grad).  Rows that are not real atoms hold NaN in their staged
// geometry: every pair with one fails the distance test, so a ghost row's
// outputs are exactly 0 and a ghost partner adds 0.
//
// Bound (north star: 27,024 rows in 1,689 blocks of 16, C = 48, S = 2,
// ~61 M candidate pairs, ~14 M inside 11 Å; H100 SXM data sheet at 700 W):
// the pair geometry (~20 FLOP a candidate pair) and G (~40, D ~70 with G′
// and dpos, a pair inside) on the fp32 lanes, ~0.027 / ~0.033 ms; the
// channel products of the pairs inside (2C FLOP each for Φ; S2 and pd in
// D) in 3xTF32 take less; reading each input once far less.  This kernel
// stages every window row of a block (~2,340 rows of 52 floats at the
// north star, ~0.82 GB a call from L2) and runs the products over every
// candidate pair of a warp step that holds one pair inside.
//
// Design.  One block of 256 threads (8 warps) owns one cell block.  It
// builds its piece table with a block-wide prefix sum, then walks the
// window's rows in piece order, 128 a stage, through a ring of three
// stages.  A pass before it (pack_rows_kernel) lays every row out as a
// stage holds it, (x, y, z, ct, b[c0 .. c0 + 8·NT)) for each channel
// chunk, NaN geometry on the rows that are no atom, so a piece's rows
// are one contiguous run: thread 0 fills a stage with one bulk copy (the
// TMA unit) a run, counted on the stage's mbarrier, two stages ahead of
// the one the block computes; no thread spends instructions on the copy.
// A
// warp takes 8 window rows of a stage (one k8 step) against 16 block rows
// (one m16 tile): each thread computes the geometry of its 4 pairs (rows
// g, g + 8; window rows 2t, 2t + 1, g = lane/4, t = lane%4), which are
// exactly its places in the A fragment of mma.sync m16n8k8 (k = t ↔ row
// 2t, k = t + 4 ↔ row 2t + 1) and in the accumulator of the pd product,
// so G and pd stay in registers.  A step whose 128 pairs all lie outside
// rc is skipped by the whole warp; in the others the pairs inside are
// compacted in lane order, so G's exp and divisions run on them alone, 32
// a round.  Φ (S2) = G (G⊙ct_j) · B_win: NT n8 tiles of channels; pd =
// (qw⊙b_i) · B_winᵀ: K = the chunk's channels, (qw⊙b_i) split once a
// chunk into shared memory.  Every product is 3xTF32: each factor x is cut
// into hi = tf32(x) and lo = tf32(x − hi), acc += lo·hi + hi·lo + hi·hi
// in fp32.  Warps sum apart; the block adds them in warp order, and dpos
// over a quad's lanes by two shuffles: a fixed order, no atomics.
//
// Every width.  Channels come in chunks of ≤ 64 (NT ≤ 8 n8 tiles, a
// template argument); C > 64 re-walks the window once a chunk, so no tile
// leaves shared memory (kernel D adds each chunk's part of pd into dpos).
// Block rows come in passes of 16 (cap ≤ 16) or 32 (two m16 tiles, warps
// split between them).  The piece table is sized at launch: 2·(2S+1)²
// pieces.  ops/windowed_coulomb.py::wc_plan mirrors wc_plan below.
//
// Why mma.sync and not wgmma: the pair geometry produces G in registers in
// mma.sync's fragment layout, so no [cap × 64] plane goes through shared
// memory, no split planes are built, and no barrier separates the
// geometry from the product; the warp step of 16 × 8 pairs is the unit
// that skips pairs outside rc; wgmma's 64-row tile would pad C = 48 to 64.
// Phase cuts of this kernel (tools/torch_wc_phases.py, PERF.md §6) put
// its products at ~0.1 ms of C's and D's time, the bound of what a faster
// product could save.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kP = 128;       // window rows a stage: 16 k8 steps
constexpr int kRing = 3;      // stages in the ring
constexpr int kMaxNt = 8;     // n8 channel tiles a chunk: ≤ 64 channels
constexpr int kStepPairs = 128;  // pairs of a warp step: 16 rows x 8
constexpr float kDampRc = 4.6f;
constexpr float kInvE = 0.36787944117144233f;

struct WParams {
  // [chunks][n_pad + kP][4 + 8·nt]: a row's x, y, z, ct (0 in C; NaN: no
  // atom) and its channels of the chunk, zero past c; kP rows of NaN
  // geometry and zero channels after the n_pad rows of each chunk
  // (pack_rows_kernel lays them out)
  const float* rows;
  const long long* a1;       // [n_blocks, nsc] piece bounds
  const long long* e1;
  const long long* a2;
  const long long* e2;
  const float* qw;           // [c] (D)
  float* out;                // [n_pad, c]: Φ (C) or S2 (D)
  float* dpos;               // [n_pad, 3] (D)
  long long n_pad;
  int cap, nsc, c;
  float bx, by, bz, rc2, k_rf, c_rf, factor;
};

// The launch plan (ops/windowed_coulomb.py::wc_plan keeps the same):
// m16 tiles a pass (1, or 2 past 16 rows), passes over the block's rows,
// n8 tiles a channel chunk, chunks, and the dynamic shared memory: the
// ring [kRing][kP][4 + 8·nt], in D (qw⊙b_i) hi and lo [16·mt][8·nt + 4],
// each warp's compacted pairs ([kStepPairs], in D two), the piece starts
// and offsets (2·nsc and 2·nsc + 1 ints), the warp sums.
struct Plan {
  int mt, passes, nt, chunks;
  size_t smem;
};

__host__ __device__ Plan wc_plan(int cap, int c, int nsc, bool bwd) {
  Plan pl;
  pl.mt = cap > 16 ? 2 : 1;
  pl.passes = (cap + 16 * pl.mt - 1) / (16 * pl.mt);
  pl.chunks = (c + 8 * kMaxNt - 1) / (8 * kMaxNt);
  const int per = (c + pl.chunks - 1) / pl.chunks;
  pl.nt = (per + 7) / 8;
  const size_t ldp = 4 + 8 * pl.nt, ldw = 8 * pl.nt + 4;
  const size_t floats = kRing * kP * ldp + (bwd ? 2 * 16 * pl.mt * ldw : 0) +
                        (bwd ? 2 : 1) * kStepPairs * kWarps;
  const size_t ints = 2 * (size_t)(2 * nsc) + 1 + kWarps;
  pl.smem = sizeof(float) * floats + sizeof(int) * ints;
  return pl;
}

// x / e⁻¹ rounded as the division rounds it, without its slow-path
// check: the product with the rounded reciprocal e, corrected by one fma
// (Markstein's step).
__device__ __forceinline__ float div_inv_e(float x) {
  constexpr float kE = 2.71828182845904524f;
  const float q = x * kE;
  return fmaf(fmaf(-q, kInvE, x), kE, q);
}

// G(d) and G'(d) as ops/coulomb.py::g_and_grad computes them.  f_exp is
// rounded as the plain version rounds it (1/(1 − t²) correctly rounded,
// expf, the division by e⁻¹): where d ≪ 1 Å it is within ulps of 1, and
// 1 − f_exp would carry a last-bit difference as a ~1e-5 relative one
// into G and G′.  The other divisions are correctly rounded reciprocals
// (__frcp_rn: 1/x exactly as the division rounds it) times the dividend,
// within an ulp of the plain version's quotients.
__device__ __forceinline__ void g_and_grad(float d, const WParams& p, float& g,
                                           float& gp) {
  const float t_raw = d * (1.0f / kDampRc);
  const bool inside = t_raw > 0.0f && t_raw < 1.0f - 1e-6f;
  const float t = fminf(fmaxf(t_raw, 0.0f), 1.0f - 1e-6f);
  const float one_m = 1.0f - t * t;
  const float r_one_m = __frcp_rn(one_m);
  const float fexp = div_inv_e(expf(-r_one_m));
  const float dfexp = inside ? fexp * (-2.0f * t * r_one_m * r_one_m) * (1.0f / kDampRc) : 0.0f;
  const float h = __frcp_rn(d) + p.k_rf * d * d - p.c_rf;
  const float dh = -__frcp_rn(d * d) + 2.0f * p.k_rf * d;
  g = p.factor * (1.0f - fexp) * h;
  gp = p.factor * ((1.0f - fexp) * dh - dfexp * h);
}

// The minimum-image delta, rounded step by step as the plain version's
// tensor ops round it (no contraction into an fma), so both see the same
// pairs inside rc.
__device__ __forceinline__ float wrap(float dc, float b, float inv_b) {
  return __fsub_rn(dc, __fmul_rn(b, rintf(__fmul_rn(dc, inv_b))));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// The ring's stage barriers (mbarrier): one arrival, the producer's,
// with the stage's bytes as its transaction count.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// A bulk copy (the TMA unit) of bytes (a multiple of 16) from src to dst,
// both 16-byte aligned, counted against bar's transactions.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// d[16 x 8] += a[16 x 8] · b[8 x 8], TF32 in, fp32 sums (mma.sync).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a · b in 3xTF32: a split into ah/al, b = (b0, b1) split here.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  tf32_split(b0, h0, l0);
  tf32_split(b1, h1, l1);
  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, l0, l1);
  mma_tf32(d, ah, h0, h1);
}

// The block's piece table: sStart[q] the first row of piece q (the nsc
// pieces of a1/e1, then those of a2/e2), sOff[q] its first window slot,
// sOff[2·nsc] the window's length.  A block-wide exclusive prefix sum of
// the piece lengths, each thread a run of pieces.
__device__ void piece_table(const WParams& p, long long blk, int* sStart, int* sOff,
                            int* sWarp) {
  const int np = 2 * p.nsc, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (np + kThreads - 1) / kThreads;
  const int q0 = min(np, tid * per), q1 = min(np, q0 + per);
  int cnt = 0;
  for (int q = q0; q < q1; ++q) {
    const bool first = q < p.nsc;
    const long long at = blk * p.nsc + (first ? q : q - p.nsc);
    const long long lo = (first ? p.a1 : p.a2)[at], hi = (first ? p.e1 : p.e2)[at];
    const int len = hi > lo ? (int)(hi - lo) : 0;
    sStart[q] = (int)lo;
    sOff[q] = len;
    cnt += len;
  }
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) sWarp[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += sWarp[w];
    all += sWarp[w];
  }
  int run = before + incl - cnt;
  for (int q = q0; q < q1; ++q) {
    const int len = sOff[q];
    sOff[q] = run;
    run += len;
  }
  if (tid == 0) sOff[np] = all;
  __syncthreads();
}

template <bool BWD, int NT>
__global__ void __launch_bounds__(kThreads, 2) wc_tc_kernel(WParams p) {
  constexpr int kCc = 8 * NT;       // channels a chunk
  constexpr int kLdp = 4 + kCc;     // stage row: ≡ 4 (mod 8), conflict-free
  constexpr int kLdw = kCc + 4;     // (qw⊙b_i) row and warp-sum row
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t sBar[kRing];
  const Plan pl = wc_plan(p.cap, p.c, p.nsc, BWD);
  float* sRing = smem;                          // [kRing][kP][kLdp]
  float* sWb = sRing + kRing * kP * kLdp;       // D: [16·mt][kLdw] (hi, lo)
  // each warp's compacted pairs: [kStepPairs] d² then G, in D then
  // [kStepPairs] G′/d
  float* sG = sWb + (BWD ? 2 * 16 * pl.mt * kLdw : 0) +
              (BWD ? 2 : 1) * kStepPairs * (threadIdx.x >> 5);
  int* sStart = reinterpret_cast<int*>(sWb + (BWD ? 2 * 16 * pl.mt * kLdw : 0) +
                                       (BWD ? 2 : 1) * kStepPairs * kWarps);
  int* sOff = sStart + 2 * p.nsc;
  int* sWarp = sOff + 2 * p.nsc + 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long blk = blockIdx.x;
  const int np = 2 * p.nsc;
  piece_table(p, blk, sStart, sOff, sWarp);
  const int total = sOff[np];
  const int ntiles = (total + kP - 1) / kP;
  const float inv_bx = 1.0f / p.bx, inv_by = 1.0f / p.by, inv_bz = 1.0f / p.bz;
  const float nan = __int_as_float(0x7fc00000);
  const long long chunk_rows = p.n_pad + kP;
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(&sBar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int seq = 0;  // stages this block has walked: its ring slot and phase

  // this warp's m16 tile and its k8 steps of a stage: ks, ks + 8/mt, …
  const int mt = pl.mt, mtile = warp % mt, ks = warp / mt, kstep = kWarps / mt;

  for (int pass = 0; pass < pl.passes; ++pass) {
    const int r0 = pass * 16 * mt;  // the pass's first row in the block
    const int nr = min(16 * mt, p.cap - r0);
    // this thread's two block rows: geometry (NaN past the block)
    float4 ri[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mtile + g + 8 * h;
      ri[h] = r < nr ? *reinterpret_cast<const float4*>(p.rows + (blk * p.cap + r0 + r) * kLdp)
                     : make_float4(nan, nan, nan, nan);
    }
    float dp[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};

    for (int chunk = 0; chunk < pl.chunks; ++chunk) {
      const int c0 = chunk * kCc;
      const float* rows = p.rows + chunk * chunk_rows * kLdp;
      if (BWD) {  // (qw⊙b_i), split: 0 for rows past the block or no atom
        for (int v = tid; v < 16 * mt * kCc; v += kThreads) {
          const int r = v / kCc, c = v - r * kCc;
          const float* row = rows + (blk * p.cap + r0 + r) * kLdp;
          float x = 0.0f;
          if (r < nr && c0 + c < p.c && !isnan(row[0])) x = p.qw[c0 + c] * row[4 + c];
          uint32_t hi, lo;
          tf32_split(x, hi, lo);
          *reinterpret_cast<float2*>(sWb + 2 * (r * kLdw + c)) =
              make_float2(__uint_as_float(hi), __uint_as_float(lo));
        }
      }
      float acc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

      // stage tt of the walk into ring slot (seq + tt) % kRing: one bulk
      // copy a run of contiguous window rows (a piece, or the part of one
      // in the stage), and past the window's end the chunk's kP rows of
      // NaN geometry; thread 0 issues them
      int pc = 0;  // thread 0's cursor into the piece table
      auto stage = [&](int tt) {
        const int slot = (seq + tt) % kRing;
        uint64_t* bar = &sBar[slot];
        float* dst = sRing + slot * kP * kLdp;
        mbar_expect(bar, kP * kLdp * 4);
        const int q0 = tt * kP, q1 = min(total, q0 + kP);
        for (int q = q0; q < q1;) {
          while (sOff[pc + 1] <= q) ++pc;
          const int n = min(q1, sOff[pc + 1]) - q;
          bulk_copy(dst + (q - q0) * kLdp, rows + (sStart[pc] + (long long)(q - sOff[pc])) * kLdp,
                    n * kLdp * 4, bar);
          q += n;
        }
        if (q1 - q0 < kP)
          bulk_copy(dst + (q1 - q0) * kLdp, rows + p.n_pad * kLdp, (kP - (q1 - q0)) * kLdp * 4,
                    bar);
      };
      if (tid == 0)
        for (int tt = 0; tt < min(kRing - 1, ntiles); ++tt) stage(tt);

      for (int tt = 0; tt < ntiles; ++tt) {
        // every warp is done with stage tt − 1, whose slot takes stage
        // tt + kRing − 1 (the fence orders the generic reads of the slot
        // before the bulk copy's writes)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (tid == 0 && tt + kRing - 1 < ntiles) stage(tt + kRing - 1);
        mbar_wait(&sBar[(seq + tt) % kRing], ((seq + tt) / kRing) & 1);
        const float* st = sRing + ((seq + tt) % kRing) * kP * kLdp;
        for (int kk = ks; kk < kP / 8; kk += kstep) {
          const float* w0 = st + (8 * kk + 2 * t) * kLdp;  // window row 2t
          float4 wj[2] = {*reinterpret_cast<const float4*>(w0),
                          *reinterpret_cast<const float4*>(w0 + kLdp)};
          // pair (row g + 8h, window row 2t + u) at fragment place h + 2u
          float dx[4], dy[4], dz[4], d2[4];
          bool in[4];
          bool any = false;
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e = h + 2 * u;
              dx[e] = wrap(__fsub_rn(ri[h].x, wj[u].x), p.bx, inv_bx);
              dy[e] = wrap(__fsub_rn(ri[h].y, wj[u].y), p.by, inv_by);
              dz[e] = wrap(__fsub_rn(ri[h].z, wj[u].z), p.bz, inv_bz);
              d2[e] = __fadd_rn(__fadd_rn(__fmul_rn(dx[e], dx[e]), __fmul_rn(dy[e], dy[e])),
                                __fmul_rn(dz[e], dz[e]));
              in[e] = d2[e] > 1e-12f && d2[e] < p.rc2;
              any |= in[e];
            }
          if (!__any_sync(0xffffffffu, any)) continue;
          // the warp's pairs inside rc, compacted in lane and place order
          // into sG: d² in, then G (and G′/d in D), so that G's divisions
          // and exp run on those pairs only, 32 a round
          const int mask = in[0] | in[1] << 1 | in[2] << 2 | in[3] << 3;
          const int cnt = __popc(mask);
          int incl = cnt;
#pragma unroll
          for (int off = 1; off < 32; off *= 2) {
            const int v = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += v;
          }
          const int n_in = __shfl_sync(0xffffffffu, incl, 31);
          int at = incl - cnt;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (in[e]) sG[at++] = d2[e];
          __syncwarp();
          for (int k = lane; k < n_in; k += 32) {
            const float d = sqrtf(sG[k]);
            float gv, gp;
            g_and_grad(d, p, gv, gp);
            sG[k] = gv;
            if (BWD) sG[kStepPairs + k] = gp * __frcp_rn(d);
          }
          __syncwarp();

          float pd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (BWD) {  // pd[16 x 8] = (qw⊙b_i) · B_winᵀ over the chunk
            const float* wr = st + (8 * kk + g) * kLdp + 4;  // window row g
            // rows g and g + 8 of this m16 tile, (hi, lo) a channel:
            // 8-byte loads, row stride ≡ 8 (mod 16): conflict-free
            const float2* a0 = reinterpret_cast<const float2*>(sWb) + (16 * mtile + g) * kLdw;
            const float2* a1 = a0 + 8 * kLdw;
#pragma unroll 2
            for (int kc = 0; kc < NT; ++kc) {
              const int k = 8 * kc + t;
              const float2 x0 = a0[k], x1 = a1[k], x2 = a0[k + 4], x3 = a1[k + 4];
              const uint32_t ah[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x),
                                      __float_as_uint(x2.x), __float_as_uint(x3.x)};
              const uint32_t al[4] = {__float_as_uint(x0.y), __float_as_uint(x1.y),
                                      __float_as_uint(x2.y), __float_as_uint(x3.y)};
              mma3(pd, ah, al, wr[k], wr[k + 4]);
            }
          }
          // pd's accumulator places: (g, 2t), (g, 2t + 1), (g + 8, 2t),
          // (g + 8, 2t + 1); pair place e = h + 2u is pd[2h + u]
          uint32_t ah[4], al[4];
          at = incl - cnt;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e & 1, u = e >> 1;
            float a = 0.0f;
            if (in[e]) {
              a = sG[at];
              if (BWD) {
                const float ctj = wj[u].w;
                const float sc = sG[kStepPairs + at] * pd[2 * h + u] * (ri[h].w + ctj);
                a *= ctj;
                dp[h][0] += sc * dx[e];
                dp[h][1] += sc * dy[e];
                dp[h][2] += sc * dz[e];
              }
              ++at;
            }
            tf32_split(a, ah[e], al[e]);
          }
          __syncwarp();  // sG is read: the next step may write it
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int c = 8 * n + g + 4;
            mma3(acc[n], ah, al, w0[c], w0[kLdp + c]);
          }
        }
      }
      seq += ntiles;
      __syncthreads();  // the ring is free: the warps' sums go there
      float* sRed = sRing;  // [kWarps][16][kLdw]
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sRed[(warp * 16 + g + 8 * (e >> 1)) * kLdw + 8 * n + 2 * t + (e & 1)] = acc[n][e];
      __syncthreads();
      for (int v = tid; v < nr * kCc; v += kThreads) {
        const int r = v / kCc, c = v - r * kCc;
        if (c0 + c >= p.c) continue;
        const int m = r / 16;
        float sum = 0.0f;
        for (int w = m; w < kWarps; w += mt) sum += sRed[(w * 16 + r % 16) * kLdw + c];
        p.out[(blk * p.cap + r0 + r) * p.c + c0 + c] = sum;
      }
      // the ring and sWb are free for the next chunk (the fence orders
      // these generic accesses before its bulk copies)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    if (BWD) {
      float* sDp = sRing;  // [kWarps][16][3]
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          float v = dp[h][x];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0) sDp[(warp * 16 + g + 8 * h) * 3 + x] = v;
        }
      __syncthreads();
      for (int v = tid; v < nr * 3; v += kThreads) {
        const int r = v / 3, x = v - r * 3;
        float sum = 0.0f;
        for (int w = r / 16; w < kWarps; w += mt) sum += sDp[(w * 16 + r % 16) * 3 + x];
        p.dpos[(blk * p.cap + r0 + r) * 3 + x] = sum;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
  }
}

// floats of the staged rows (WParams::rows) at n_pad rows
__host__ __device__ __forceinline__ long long rows_floats(long long n_pad, const Plan& pl) {
  return (long long)pl.chunks * (n_pad + kP) * (4 + 8 * pl.nt);
}

// Lays out the rows the kernels stage (WParams::rows) from pos [n_pad, 3],
// col3 [n_pad] (ct; null: 0), row_valid [n_pad] and b [n_pad, c]: the
// rows that are no atom, and the kP rows after each chunk's, get NaN
// geometry; channels past c are 0.
__global__ void __launch_bounds__(kThreads) pack_rows_kernel(
    const float* __restrict__ pos, const float* __restrict__ col3,
    const uint8_t* __restrict__ row_valid, const float* __restrict__ b,
    float* __restrict__ rows, long long n_pad, int c, int nt, long long total) {
  const int ldp = 4 + 8 * nt;
  const long long per_chunk = (n_pad + kP) * ldp;
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < total;
       v += (long long)gridDim.x * kThreads) {
    const long long chunk = v / per_chunk, e = v - chunk * per_chunk;
    const long long row = e / ldp;
    const int col = (int)(e - row * ldp);
    float x;
    if (col < 4) {
      x = __int_as_float(0x7fc00000);
      if (row < n_pad && row_valid[row])
        x = col < 3 ? pos[row * 3 + col] : (col3 ? col3[row] : 0.0f);
    } else {
      const long long ch = chunk * 8 * nt + col - 4;
      x = row < n_pad && ch < c ? b[row * c + ch] : 0.0f;
    }
    rows[v] = x;
  }
}

template <bool BWD>
const void* kernel_of(int nt) {
  switch (nt) {
    case 1: return (const void*)wc_tc_kernel<BWD, 1>;
    case 2: return (const void*)wc_tc_kernel<BWD, 2>;
    case 3: return (const void*)wc_tc_kernel<BWD, 3>;
    case 4: return (const void*)wc_tc_kernel<BWD, 4>;
    case 5: return (const void*)wc_tc_kernel<BWD, 5>;
    case 6: return (const void*)wc_tc_kernel<BWD, 6>;
    case 7: return (const void*)wc_tc_kernel<BWD, 7>;
    default: return (const void*)wc_tc_kernel<BWD, 8>;
  }
}

// Packs the rows into p.rows (the wrapper's scratch of rows_floats), then
// runs the kernel over the n_blocks cell blocks.
template <bool BWD>
int launch(WParams p, const float* pos, const float* col3, const uint8_t* row_valid,
           const float* b, float* rows, long long n_blocks, void* stream) {
  const Plan pl = wc_plan(p.cap, p.c, p.nsc, BWD);
  const void* kern = kernel_of<BWD>(pl.nt);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)pl.smem);
  if (err != cudaSuccess) return err;
  if (n_blocks == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = rows_floats(p.n_pad, pl);
  const long long want = (total + kThreads - 1) / kThreads;
  pack_rows_kernel<<<(unsigned)(want < 8192 ? want : 8192), kThreads, 0, st>>>(
      pos, col3, row_valid, b, rows, p.n_pad, p.c, pl.nt, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p.rows = rows;
  void* args[] = {&p};
  err = cudaLaunchKernel(kern, dim3((unsigned)n_blocks), dim3(kThreads), args, pl.smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

WParams make_params(const long long* a1, const long long* e1, const long long* a2,
                    const long long* e2, long long n_pad, int cap, int nsc, int c, float bx,
                    float by, float bz, float rc2, float k_rf, float c_rf, float factor) {
  WParams p{};
  p.a1 = a1; p.e1 = e1; p.a2 = a2; p.e2 = e2;
  p.n_pad = n_pad; p.cap = cap; p.nsc = nsc; p.c = c;
  p.bx = bx; p.by = by; p.bz = bz; p.rc2 = rc2; p.k_rf = k_rf; p.c_rf = c_rf;
  p.factor = factor;
  return p;
}

}  // namespace

extern "C" {

const char* tmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel C.  pos [n_blocks·cap, 3], row_valid [..] bytes, b [.., c];
// rows, a scratch of tmd_windowed_coulomb_rows_floats floats; a1, e1, a2,
// e2 [n_blocks, nsc] int64; phi [.., c].
int tmd_windowed_coulomb_fwd(const float* pos, const uint8_t* row_valid, const float* b,
                             float* rows, const long long* a1, const long long* e1,
                             const long long* a2, const long long* e2, float* phi,
                             long long n_blocks, int cap, int nsc, int c, float bx,
                             float by, float bz, float rc2, float k_rf, float c_rf,
                             float factor, void* stream) {
  WParams p = make_params(a1, e1, a2, e2, n_blocks * cap, cap, nsc, c, bx, by, bz, rc2,
                          k_rf, c_rf, factor);
  p.out = phi;
  return launch<false>(p, pos, nullptr, row_valid, b, rows, n_blocks, stream);
}

// Kernel D.  The same, and ct [..]; qw [c]; s2 [.., c]; dpos [.., 3].
int tmd_windowed_coulomb_bwd(const float* pos, const float* ct, const uint8_t* row_valid,
                             const float* b, float* rows, const long long* a1,
                             const long long* e1, const long long* a2, const long long* e2,
                             const float* qw, float* s2, float* dpos, long long n_blocks,
                             int cap, int nsc, int c, float bx, float by, float bz,
                             float rc2, float k_rf, float c_rf, float factor,
                             void* stream) {
  WParams p = make_params(a1, e1, a2, e2, n_blocks * cap, cap, nsc, c, bx, by, bz, rc2,
                          k_rf, c_rf, factor);
  p.qw = qw; p.out = s2; p.dpos = dpos;
  return launch<true>(p, pos, ct, row_valid, b, rows, n_blocks, stream);
}

// Floats of the rows scratch kernel C (bwd = 0) or D needs at n_pad rows.
long long tmd_windowed_coulomb_rows_floats(int bwd, long long n_pad, int cap, int c,
                                           int nsc) {
  return rows_floats(n_pad, wc_plan(cap, c, nsc, bwd != 0));
}

// The plan of kernel C (bwd = 0) or D at (cap, c, nsc) and the kernel it
// launches as compiled: out = m16 tiles a pass, passes, n8 tiles a chunk,
// chunks, dynamic shared memory, registers, local (spill) bytes a thread,
// static shared memory, resident blocks an SM.
int tmd_windowed_coulomb_attributes(int bwd, int cap, int c, int nsc, int* out) {
  const Plan pl = wc_plan(cap, c, nsc, bwd != 0);
  const void* kern = bwd ? kernel_of<true>(pl.nt) : kernel_of<false>(pl.nt);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)pl.smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, pl.smem);
  if (err != cudaSuccess) return err;
  out[0] = pl.mt;
  out[1] = pl.passes;
  out[2] = pl.nt;
  out[3] = pl.chunks;
  out[4] = (int)pl.smem;
  out[5] = attr.numRegs;
  out[6] = (int)attr.localSizeBytes;
  out[7] = (int)attr.sharedSizeBytes;
  out[8] = blocks;
  return cudaSuccess;
}

}  // extern "C"
