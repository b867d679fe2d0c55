// TensorNet radial tensor embedding for Hopper (sm_90a): kernel 1 (the
// forward) and kernel 2 (its backward), float32-accurate, their products
// on the tensor cores in 3xTF32 (csrc/tc_tile.cuh; never single-pass TF32).
//
// Replaces the Pallas TPU kernels torchmdnet_tpu/ops/pallas_embedding.py:
//   forward  _emb_kernel      (:80,  pallas_call :132, fused_radial_embedding)
//   backward _emb_bwd_kernel  (:178, pallas_call :269, via _bwd_op :305)
//
// Per atom row n and valid slot k (em[n,k] ≠ 0), over F channels f:
//   dp_j[k,f] = ball[jF+f] + Σ_r ea[n,k,r] kall[r, jF+f]        j = 0,1,2
//   z[k,f]    = zw1[n,f] + zw2g[n,k,f],   cz = C[n,k] em[n,k] z
//   w_j       = cz dp_j
//   out[n]    = (Σ_k w0, Σ_k w1 v_d (d=x,y,z), Σ_k w2 s5_c(v) (c<5))  [9F]
// with s5 = (vx²−tr3, vx vy, vx vz, vy²−tr3, vy vz), tr3 = |v|²/3.  The
// backward, for the cotangent g [N, 9F] of out:
//   gw0 = g_I, gw1 = Σ_d g_A,d v_d, gw2 = Σ_c g_S,c s5_c   (per slot, f)
//   dcz = Σ_j gw_j dp_j,  dd_j = gw_j cz,  dea = dd·kallᵀ
//   dC = em Σ_f dcz z,  dzw2g = dcz C em,  dzw1[n] = Σ_k dzw2g
//   dv from Σ_f w1 g_A,d and Σ_f w2 g_S,c,  dkall = eaᵀ·dd,  dball = Σ dd.
// A slot with em = 0 gives exact zeros in every output of the plain chain,
// so neither kernel computes it: kernel 2 writes zeros to its dea, dC, dv
// and dzw2g, and a row with no valid slot gets zeros in out and dzw1.
//
// Bound (N = 25,088, K = 96, R = 32, F = 128, ~1.81 M valid slots; H100 SXM
// data sheet at 700 W: 3.35 TB/s, 495 TFLOP/s TF32 on the tensor cores;
// the valid slots' ea, zw2g, C and v, the mask, zw1, kall, ball, g and the
// outputs whole, as chip_smoke.py::emb_bytes counts them): kernel 1's
// product ea·kall is 44 GFLOP, 0.27 ms as three TF32 products, against
// ~1.32 GB of traffic (the valid slots' zw2g alone ~0.92 GB): ~0.40 ms,
// bound by bytes.  Kernel 2's two products (ea·kall again and dd·kallᵀ)
// are 89 GFLOP, 0.54 ms, against ~1.67 GB without dzw1/dzw2g (0.50 ms):
// ~0.54 ms, bound by the products; with them ~2.92 GB (~0.87 ms, bytes);
// with dk eaᵀ·dd adds 45 GFLOP.  Both kernels run far above that, with
// one block (kernel 2) or two (kernel 1) an SM walking their tiles phase
// by phase between barriers.
//
// Design.  A block owns 16 atom rows (kRows) and compacts their valid
// slots in slot order (tc_compact, kChunk slots at a time) into tiles of
// 64.  Kernel 1 first forms the tile's [64, F] channel tile cz from zw1
// and zw2g (float4 rows, four pairs of loads in flight a thread: zw2g is
// read once); kernel 2 reads z in its elementwise pass.  Every product is a wgmma m64n64k8 3xTF32
// product (tc_tile.cuh's tc_mma) with the tile's 64 slots as the columns
// of B, split into hi/lo planes in shared memory by the block itself
// (planes, float4 groups, four 16-row stages at a time), and the weights
// as A, split in registers: nothing is streamed per tile.  (tc_product_from,
// with the slots as A and kall's split image as B, would stream the image
// through its ring for every tile: for dea at R = 32, 24 stages of 16 KB a
// tile, three quarters of them zero padding.)
//   D     Dᵀ = kallᵀ·eaᵀ per 128 channels (a warpgroup 64 of them): A =
//         kall's columns, B = the tile's ea rows (zero past the tile, so D
//         is 0 there), built once a tile where R ≤ 64.
//   out   Kernel 1: wᵀ = cz·(D + ball) per 128-column pass into a shared
//         tile, then a thread a (column, irrep parity) adds w·{1, v_d,
//         s5_c(v)} over each row segment of the tile (the segments' first
//         slots from two ballots), slots in order, into out[n, d·F + f]
//         (w(0) = 0, w(1..3) = 1, w(4..8) = 2, as kernel A's neighbour
//         sum).  The block zeroes its rows first and owns them: the tile's
//         first segment adds to its row (it may have begun in an earlier
//         tile, which then added first), the others store.  No atomics.
//   dd    Kernel 2: D for all of 3F into a [64, 3F + 4] tile; then four
//         threads a slot, each a quarter of F in float4 steps, read z and
//         the slot's g row, form gw, dcz and the cotangent dd over D in
//         place (and dzw2g, written out and kept in a [64, F + 4] tile for
//         dzw1), and sum the slot's nine scalars (dC/em and the eight dv
//         terms) over their quarter, then two shuffles: a fixed order.
//         dzw1 sums its channel's slots in slot order.  The masked slots'
//         zeros come first, a warp 32 slots' mask at a time (a ballot).
//   dea   deaᵀ = kall·ddᵀ per 64 rbf rows, A = kall's rows, B = dd's rows
//         split four stages at a time; the warpgroups take alternate
//         stages and warpgroup 0 adds 1's sums (at R = 32 a split by
//         columns would leave one warpgroup on zero padding).
//   dk    dkallᵀ = ddᵀ·[ea | 1] (the last column gives dball) per 64
//         columns of [ea | 1], A = dd's columns, B = the tile's ea rows
//         and a column of ones; each block adds its tiles in order into its
//         own partial row in device memory (one block an SM), and a second
//         kernel adds the rows in block order: the same result every run.
// kall, read at every stage, sits in kernel 2's shared memory where the
// plan leaves it room (F = 128, R = 32: ~216 KB, one block an SM); kernel 1
// reads it from device memory, sizes its plane buffer by R and asks for a
// carveout of two blocks' shared memory, so the rest of the SM is L1 for
// it (staged, kernel 1 would hold one block an SM, not two).
//
// Where the tiles live.  Kernel 1's cz tile sits in shared memory up to F
// = 512, kernel 2's D and dzw2g tiles up to F = 128.  Above, each resident
// block keeps them in its region of a device-memory scratch that the
// wrapper allocates, the grid is one block an SM walking the row blocks
// b, b + grid, ..., and dea's product sums each stage apart in fp32
// (kStageSums: kdim = 3F past 384).  The dk form takes that grid too, so
// its partial rows stay few.  ops/radial_embedding.py::launch_plan picks
// the form: an entry point given a tile scratch runs the wide one (at F =
// 128 it is 1.3-1.7x slower than the narrow one, PERF.md §6).  Every rbf
// width and every F that is a positive multiple of 4 launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_tile.cuh"

namespace {

constexpr int kPad = 4;
constexpr int kRows = 16;      // atom rows a block owns
constexpr int kChunk = 4096;   // slots it compacts at a time (16-bit ids)
constexpr int kWarps = kTcThreads / 32;
constexpr int kStages = 4;     // k stages of B planes held at a time
constexpr int kPlane = kTcM * kTcK;            // floats of one 64-column plane
constexpr int kPlanes = kStages * 2 * kPlane;  // the plane buffer: hi, lo a stage
constexpr int kLdW = kTcM + kPad;              // row stride of kernel 1's wᵀ tile
constexpr int kSmemLimit = 232448;             // shared memory of a Hopper block

enum Mode { kFwd = 0, kBwd = 1, kBwdDk = 2 };

struct EmbParams {
  const float* ea;     // [n, k, r]
  const float* C;      // [n, k]
  const float* vx;     // [n, k]
  const float* vy;
  const float* vz;
  const float* zw1;    // [n, f]
  const float* zw2g;   // [n, k, f]
  const float* em;     // [n, k]
  const float* g;      // [n, 9f] (kernel 2)
  const float* kall;   // [r, 3f]
  const float* ball;   // [3f]
  float* tiles;        // the wide form's per-block tiles (emb_tile_floats)
  float* out;          // [n, 9f] (kernel 1)
  float* dea;          // [n, k, r]
  float* dC;           // [n, k]
  float* dvx;
  float* dvy;
  float* dvz;
  float* dzw1;         // [n, f], null without dz
  float* dzw2g;        // [n, k, f], null without dz
  float* part;         // [grid, (r + 1)·3f] (dk)
  long long n;
  int k, r, f;
  int kall_smem;       // kall staged in shared memory (emb_kall_smem)
};

__device__ __forceinline__ void s5_of(float vx, float vy, float vz, float s[5]) {
  const float tr3 = (vx * vx + vy * vy + vz * vz) / 3.0f;
  s[0] = vx * vx - tr3;
  s[1] = vx * vy;
  s[2] = vx * vz;
  s[3] = vy * vy - tr3;
  s[4] = vy * vz;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4& at4(float* p) {
  return *reinterpret_cast<float4*>(p);
}
// Component u of v (u a constant once the loop over it is unrolled).
__device__ __forceinline__ float& el(float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}
__device__ __forceinline__ int eli(const int4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}
// First irrep of weight block w: I = 0, A = 1..3, S = 4..8.
__device__ __forceinline__ int first_irrep(int w) { return w == 0 ? 0 : (w == 1 ? 1 : 4); }
// Column of accumulator i within the warpgroup's 64 (tc_col less 64·wg).
__device__ __forceinline__ int tc_col64(int i) { return i * 8 + 2 * (threadIdx.x & 3); }

// Slot ids a block compacts at a time.
__host__ __device__ __forceinline__ int emb_list_cap(int k) {
  return kRows * k < kChunk ? kRows * k : kChunk;
}

// Floats of a block's tiles: the channel tile [64][F + 4] (kernel 1's cz,
// kernel 2's dzw2g), and in kernel 2 the D tile [64][3F + 4].
__host__ __device__ __forceinline__ long long emb_tile_floats(int mode, int f) {
  long long x = (long long)kTcM * (f + kPad);
  if (mode != kFwd) x += (long long)kTcM * (3 * f + kPad);
  return x;
}

// Stages of the plane buffer: kStages, or in kernel 1, whose only B
// operand is ea (k = R), as many as R needs up to kStages.
__host__ __device__ __forceinline__ int emb_plane_stages(int mode, int r) {
  return mode == kFwd && (r + kTcK - 1) / kTcK < kStages ? (r + kTcK - 1) / kTcK : kStages;
}

// Dynamic shared memory of a launch (ops/radial_embedding.py::emb_smem
// keeps the same sum): 1 KB to align the planes, the plane buffer, kall
// [R][3F + 4] where it is staged, kernel 1's wᵀ tile [128][64 + 4], the
// tiles (the narrow form only; the wide one keeps them in device memory),
// the per-slot floats (kernel 1: C·em and the nine irrep factors; kernel
// 2: C·em, em and v), the tile's rows and slot offsets, kernel 1's row
// segments and their two ballot masks, the warp counts, the slot ids.
size_t emb_smem(int mode, int f, int k, int r, bool kall_smem, bool wide) {
  const size_t tiles = wide ? 0 : (size_t)emb_tile_floats(mode, f);
  const size_t w = mode == kFwd ? (size_t)kTcN * kLdW : 0;
  const size_t kall = kall_smem ? (size_t)r * (3 * f + kPad) : 0;
  const int slot = mode == kFwd ? 10 : 5;
  const size_t planes = (size_t)emb_plane_stages(mode, r) * 2 * kPlane;
  return 1024 + sizeof(float) * (planes + kall + w + tiles + slot * kTcM) +
         sizeof(int) * (2 * kTcM + (mode == kFwd ? kTcM + 4 : 0) + kWarps) +
         sizeof(unsigned short) * emb_list_cap(k);
}

// A operand from the columns of a row-major weight W: A[row][k] = W[k·ld]
// at col0 (this thread's fragment row tc_row(0)) and col1 (tc_row(1)), k
// past kdim 0 (the transposed products below: kallᵀ, and ddᵀ in dk).
struct TcColumns {
  const float* col0;
  const float* col1;
  int kdim, ld;
  __device__ __forceinline__ void operator()(int kt, uint32_t (&a)[2][2][4]) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = kt * kTcK + 8 * s + t;
      tf32_split(k < kdim ? col0[k * ld] : 0.0f, a[s][0][0], a[s][1][0]);
      tf32_split(k < kdim ? col1[k * ld] : 0.0f, a[s][0][1], a[s][1][1]);
      tf32_split(k + 4 < kdim ? col0[(k + 4) * ld] : 0.0f, a[s][0][2], a[s][1][2]);
      tf32_split(k + 4 < kdim ? col1[(k + 4) * ld] : 0.0f, a[s][0][3], a[s][1][3]);
    }
  }
};

// The B operand of the products, built in shared memory from the slot
// tile: ns ≤ kStages stages of split planes at sB (stage s: its hi plane,
// then its lo plane), each 64 columns n by 16 k, K-major with the 64-byte
// swizzle that wgmma reads (tc_tile.cuh's image layout).  Elements (n, k ..
// k + 3) are get4(n, k0 + k) for k a multiple of 4 (0 outside the
// operand): a thread splits four and stores them as one 16-byte chunk of
// each plane (the swizzle moves whole chunks).  Every thread calls it; the
// caller synchronises before (sB is free) and after.
template <class Get4>
__device__ __forceinline__ void planes(Get4 get4, int k0, int ns, float* sB) {
  const int groups = kTcK * ns / 4;  // float4 groups of a column
  for (int v = threadIdx.x; v < kTcM * groups; v += kTcThreads) {
    const int n = v / groups, k = 4 * (v - n * groups), s = k / kTcK;
    float4 x = get4(n, k0 + k), hi, lo;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t h, l;
      tf32_split(el(x, u), h, l);
      el(hi, u) = __uint_as_float(h);
      el(lo, u) = __uint_as_float(l);
    }
    int o = n * 64 + 4 * (k - s * kTcK);
    o ^= ((o >> 7) & 3) << 4;
    float* dst = sB + s * 2 * kPlane + o / 4;
    at4(dst) = hi;
    at4(dst + kPlane) = lo;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// acc += A · the planes of stages s0, s0 + step, … < ns at sB (k tiles kt0
// + s), A's fragments from frag: 6 wgmma a stage (tc_mma), with
// kStageSums each stage summed apart and added in fp32.
template <bool kStageSums, class Frag>
__device__ __forceinline__ void planes_mma(const Frag& frag, int kt0, int s0, int ns,
                                           int step, const float* sB, float (&acc)[8][4]) {
  for (int s = s0; s < ns; s += step) {
    uint32_t a[2][2][4];
    frag(kt0 + s, a);
    const float* pl = sB + s * 2 * kPlane;
    if constexpr (kStageSums) {
      float part[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][e] = 0.0f;
      tc_mma(part, a, tc_desc(pl), tc_desc(pl + kPlane));
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += part[i][e];
    } else {
      tc_mma(acc, a, tc_desc(pl), tc_desc(pl + kPlane));
    }
  }
}

// acc = A[64 rows x kdim] · B[kdim x 64 slots], B's planes from get4,
// kStages stages at a time; with built, kdim ≤ 16·kStages and the planes
// are already in sB.  Each warpgroup takes the stages s0, s0 + step, …
// of every round (step 2, s0 = its index: the two split k and the caller
// adds their sums).  Every thread calls it; it synchronises around each
// build.
template <bool kStageSums, class Frag, class Get4>
__device__ __forceinline__ void emb_product(const Frag& frag, Get4 get4, int kdim, bool built,
                                            int s0, int step, float* sB,
                                            float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  const int nk = (kdim + kTcK - 1) / kTcK;
  for (int kt0 = 0; kt0 < nk; kt0 += kStages) {
    const int ns = min(kStages, nk - kt0);
    if (!built) {
      __syncthreads();  // sB's last planes are read
      planes(get4, kt0 * kTcK, ns, sB);
      __syncthreads();
    }
    planes_mma<kStageSums>(frag, kt0, s0, ns, step, sB, acc);
  }
}

// Kernel 1's channel tile, float4: sZ[e][f] = cz = sCem[e]·(zw1[row, f] +
// zw2g[slot, f]).  Each thread keeps four pairs of loads in flight: zw2g,
// the kernel's largest input, is read once, here.
__device__ __forceinline__ void channel_tile(const EmbParams& p, float* sZ, int ldz,
                                             const int* sRow, const int* sOff,
                                             const float* sCem, int nt, long long r0,
                                             long long g0) {
  const int F = p.f, f4 = F / 4, count = nt * f4;
  for (int v0 = threadIdx.x; v0 < count; v0 += 4 * kTcThreads) {
    float4 a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int v = v0 + u * kTcThreads;
      if (v >= count) break;
      const int e = v / f4, c = 4 * (v - e * f4);
      a[u] = ldg4(p.zw1 + (r0 + sRow[e]) * F + c);
      b[u] = ldg4(p.zw2g + (g0 + sOff[e]) * F + c);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int v = v0 + u * kTcThreads;
      if (v >= count) break;
      const int e = v / f4, c = 4 * (v - e * f4);
      const float m = sCem[e];
      at4(sZ + e * ldz + c) = make_float4(m * (a[u].x + b[u].x), m * (a[u].y + b[u].y),
                                          m * (a[u].z + b[u].z), m * (a[u].w + b[u].w));
    }
  }
}

// D = ea·kall of pass pz (channels [128 pz, 128 pz + 128), warpgroup wg
// the 64 from 128 pz + 64 wg) for the tile's slots, transposed:
// acc[i][2h + e] is channel 128 pz + 64 wg + tc_row(h), slot tc_col64(i) +
// e.  A = kall's columns (kallᵀ's rows; kw is kall with row stride ldk, in
// shared or device memory), B = the tile's ea rows (0 past nt, so D is 0
// there); the ea planes are built at the first pass and kept where R ≤
// 16·kStages.
__device__ __forceinline__ void d_product(const EmbParams& p, const float* kw, int ldk,
                                          const int* sOff, int nt, long long g0, int pz,
                                          float* sB, float (&acc)[8][4]) {
  const int F3 = 3 * p.f, R = p.r;
  const int c0 = pz * kTcN + (threadIdx.x >> 7) * 64;
  const TcColumns a{kw + min(c0 + tc_row(0), F3 - 1), kw + min(c0 + tc_row(1), F3 - 1), R,
                    ldk};
  const float* ea = p.ea + g0 * R;
  emb_product<false>(
      a,
      [&](int n, int k) {
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (n < nt) {
          const float* row = ea + (long long)sOff[n] * R;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (k + u < R) el(x, u) = __ldg(row + k + u);
        }
        return x;
      },
      R, pz > 0 && R <= kStages * kTcK, 0, 1, sB, acc);
}

// kall [R][3F] into shared memory at row stride 3F + 4 (kernel 2's A
// operand, read every stage) where emb_kall_smem gives it room; returns
// where the products read it and the stride.
__device__ __forceinline__ const float* stage_kall(const EmbParams& p, float* sK, int& ldk) {
  const int F3 = 3 * p.f, c4 = F3 / 4;
  if (!p.kall_smem) {
    ldk = F3;
    return p.kall;
  }
  ldk = F3 + kPad;
  for (int v = threadIdx.x; v < p.r * c4; v += kTcThreads) {
    const int r = v / c4, c = 4 * (v - r * c4);
    at4(sK + r * ldk + c) = ldg4(p.kall + (long long)r * F3 + c);
  }
  return sK;  // read after the block's next barrier
}

// Kernel 1.
template <bool kWide>
__global__ void __launch_bounds__(kTcThreads, 2) emb_fwd_tc_kernel(EmbParams p) {
  extern __shared__ __align__(16) float smem[];
  const int F = p.f, F3 = 3 * F, F9 = 9 * F, K = p.k;
  const int ldz = F + kPad;
  float* sB = smem + tc_region_offset(smem);  // the planes
  float* sW = sB + emb_plane_stages(kFwd, p.r) * 2 * kPlane;  // [128][64 + pad]  wᵀ of a pass
  float* sZ;                                  // [64][F + pad]  cz
  float* sCem;                                // [64]  C·em
  if constexpr (kWide) {
    sZ = p.tiles + (long long)blockIdx.x * emb_tile_floats(kFwd, F);
    sCem = sW + kTcN * kLdW;
  } else {
    sZ = sW + kTcN * kLdW;
    sCem = sZ + kTcM * ldz;
  }
  float* sFac = sCem + kTcM;                  // [9][64]  1, v_d, s5_c(v)
  int* sRow = reinterpret_cast<int*>(sFac + 9 * kTcM);  // [64] block row, −1 past the tile
  int* sOff = sRow + kTcM;                    // [64] slot offset in the block
  int* sSeg = sOff + kTcM;                    // [64 + 2] row segments' first slots, nt; count
  unsigned* sMask = reinterpret_cast<unsigned*>(sSeg + kTcM + 2);  // [2]
  int* sCount = reinterpret_cast<int*>(sMask + 2);  // [kWarps]
  unsigned short* sList = reinterpret_cast<unsigned short*>(sCount + kWarps);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int cap = emb_list_cap(K);
  const int np3 = (F3 + kTcN - 1) / kTcN;
  const long long nrb = (p.n + kRows - 1) / kRows;
  float acc[8][4];

  for (long long rb = blockIdx.x; rb < nrb; rb += gridDim.x) {
    const long long r0 = rb * kRows;
    const int nrows = (int)min((long long)kRows, p.n - r0);
    const long long g0 = r0 * K;  // first slot of the block
    const int total = nrows * K;
    // out starts at 0, so a row without a valid slot stays 0
    float4* o = reinterpret_cast<float4*>(p.out + r0 * F9);
    for (int v = tid; v < nrows * F9 / 4; v += kTcThreads)
      o[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

    for (int q0 = 0; q0 < total; q0 += cap) {
      const float* emq = p.em + g0 + q0;
      const int nv = tc_compact(
          min(cap, total - q0), [&](int s) { return emq[s] != 0.0f; }, sList, 0,
          sCount);
      for (int t0 = 0; t0 < nv; t0 += kTcM) {
        const int nt = min(kTcM, nv - t0);
        if (tid < kTcM) {
          int s = 0, row = -1;
          float cem = 0.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f;
          if (tid < nt) {
            s = q0 + sList[t0 + tid];
            const long long gi = g0 + s;
            row = s / K;
            cem = p.C[gi] * p.em[gi];
            ux = p.vx[gi];
            uy = p.vy[gi];
            uz = p.vz[gi];
          }
          float s5[5];
          s5_of(ux, uy, uz, s5);
          // slots that begin a row's segment of the tile
          const bool first =
              tid < nt && (tid == 0 || row != (q0 + sList[t0 + tid - 1]) / K);
          const unsigned m = __ballot_sync(0xffffffffu, first);
          if ((tid & 31) == 0) sMask[tid >> 5] = m;
          sRow[tid] = row;
          sOff[tid] = s;
          sCem[tid] = cem;
          sFac[tid] = 1.0f;
          sFac[kTcM + tid] = ux;
          sFac[2 * kTcM + tid] = uy;
          sFac[3 * kTcM + tid] = uz;
#pragma unroll
          for (int c = 0; c < 5; ++c) sFac[(4 + c) * kTcM + tid] = s5[c];
        }
        __syncthreads();
        if (tid < nt && (sMask[tid >> 5] >> (tid & 31) & 1))
          sSeg[(tid >> 5 ? __popc(sMask[0]) : 0) +
               __popc(sMask[tid >> 5] & ((1u << (tid & 31)) - 1))] = tid;
        if (tid == 0) {
          const int ns = __popc(sMask[0]) + __popc(sMask[1]);
          sSeg[ns] = nt;
          sSeg[kTcM + 1] = ns;
        }
        // cz = C·em·(zw1 + zw2g) of the tile's slots
        channel_tile(p, sZ, ldz, sRow, sOff, sCem, nt, r0, g0);
        for (int pz = 0; pz < np3; ++pz) {
          d_product(p, p.kall, F3, sOff, nt, g0, pz, sB, acc);
          __syncthreads();  // cz is written; the last pass's wᵀ is read
          // wᵀ[column][slot] = cz·(D + ball) of the pass
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cl = wg * 64 + tc_row(h), c = pz * kTcN + cl;
            if (c >= F3) continue;
            const int f = c % F;
            const float b = __ldg(p.ball + c);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int n = tc_col64(i);
              *reinterpret_cast<float2*>(sW + cl * kLdW + n) =
                  make_float2(sZ[n * ldz + f] * (acc[i][2 * h] + b),
                              sZ[(n + 1) * ldz + f] * (acc[i][2 * h + 1] + b));
            }
          }
          __syncthreads();
          // thread (column, parity of the irrep) adds each row segment's
          // slots in slot order: irreps d0, d0 + 2, ... of the column's
          // block.  The tile's first row may have begun in an earlier tile
          // and is added to; the others begin here and are stored over the
          // zeros the block wrote first.
          const int cl = tid & (kTcN - 1), c = pz * kTcN + cl;
          if (c < F3) {
            const int w = c / F, f = c - w * F, d0 = first_irrep(w) + wg;
            const int nq = wg <= 2 * w ? (2 * w - wg) / 2 + 1 : 0;
            float* oq = p.out + r0 * F9 + d0 * F + f;  // irrep d0 + 2q at + 2qF
            const float* wc = sW + cl * kLdW;
            const int nseg = nq ? sSeg[kTcM + 1] : 0;
            for (int j = 0; j < nseg; ++j) {
              const int a = sSeg[j], b = sSeg[j + 1];
              float sum[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
              for (int e = a; e < b; ++e) {
                const float x = wc[e];
#pragma unroll
                for (int q = 0; q < 3; ++q)
                  if (q < nq) sum[q] = fmaf(x, sFac[(d0 + 2 * q) * kTcM + e], sum[q]);
              }
              float* o = oq + (long long)sRow[a] * F9;
#pragma unroll
              for (int q = 0; q < 3; ++q)
                if (q < nq) o[2 * q * F] = j ? sum[q] : o[2 * q * F] + sum[q];
            }
          }
        }
        __syncthreads();  // the tile's metadata and wᵀ are read
      }
    }
  }
}

// Kernel 2 (kDk: with dkall and dball).
template <bool kWide, bool kDk>
__global__ void __launch_bounds__(kTcThreads, 1) emb_bwd_tc_kernel(EmbParams p) {
  constexpr int kMode = kDk ? kBwdDk : kBwd;
  extern __shared__ __align__(16) float smem[];
  const int F = p.f, F3 = 3 * F, F9 = 9 * F, K = p.k, R = p.r;
  const int ldd = F3 + kPad, ldz = F + kPad;
  float* sB = smem + tc_region_offset(smem);  // the planes
  int ldk;
  const float* kw = stage_kall(p, sB + kPlanes, ldk);  // kall
  float* sFree = sB + kPlanes + (p.kall_smem ? R * ldk : 0);
  float* sD;                                  // [64][3F + pad]  D, then dd
  float* sZ;                                  // [64][F + pad]   dzw2g (for dzw1)
  float* sCem;                                // [64]  C·em
  if constexpr (kWide) {
    sD = p.tiles + (long long)blockIdx.x * emb_tile_floats(kMode, F);
    sZ = sD + kTcM * ldd;
    sCem = sFree;
  } else {
    sD = sFree;
    sZ = sD + kTcM * ldd;
    sCem = sZ + kTcM * ldz;
  }
  float* sEm = sCem + kTcM;                   // [64]
  float* sV = sEm + kTcM;                     // [3][64]
  int* sRow = reinterpret_cast<int*>(sV + 3 * kTcM);  // [64] block row, −1 past the tile
  int* sOff = sRow + kTcM;                    // [64] slot offset in the block
  int* sCount = sOff + kTcM;                  // [kWarps]
  unsigned short* sList = reinterpret_cast<unsigned short*>(sCount + kWarps);

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int cap = emb_list_cap(K), f4 = F / 4;
  const int np3 = (F3 + kTcN - 1) / kTcN;
  const long long nrb = (p.n + kRows - 1) / kRows;
  const bool dz = p.dzw2g != nullptr;
  // dk: this block's partial row of dkall ([R][3F]) then dball ([3F])
  float* prow = kDk ? p.part + (long long)blockIdx.x * (R + 1) * F3 : nullptr;
  if constexpr (kDk)
    for (int v = tid; v < (R + 1) * F3 / 4; v += kTcThreads)
      at4(prow + 4 * v) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float acc[8][4];

  for (long long rb = blockIdx.x; rb < nrb; rb += gridDim.x) {
    const long long r0 = rb * kRows;
    const int nrows = (int)min((long long)kRows, p.n - r0);
    const long long g0 = r0 * K;
    const int total = nrows * K;
    const float* emb = p.em + g0;
    const float* ea = p.ea + g0 * R;
    // dzw1 starts at 0; a masked slot's outputs are exact zeros
    if (dz)
      for (int v = tid; v < nrows * f4; v += kTcThreads)
        at4(p.dzw1 + r0 * F + 4 * v) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    // a warp reads 32 slots' mask at once and zeroes the masked ones
    for (int s0 = (tid >> 5) * 32; s0 < total; s0 += kTcThreads) {
      const int s = s0 + lane;
      const bool masked = s < total && emb[s] == 0.0f;
      if (masked) {
        p.dC[g0 + s] = 0.0f;
        p.dvx[g0 + s] = 0.0f;
        p.dvy[g0 + s] = 0.0f;
        p.dvz[g0 + s] = 0.0f;
      }
      for (unsigned m = __ballot_sync(0xffffffffu, masked); m; m &= m - 1) {
        const long long gs = g0 + s0 + __ffs(m) - 1;
        for (int r = lane; r < R; r += 32) p.dea[gs * R + r] = 0.0f;
        if (dz)
          for (int c = lane; c < f4; c += 32)
            at4(p.dzw2g + gs * F + 4 * c) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }

    for (int q0 = 0; q0 < total; q0 += cap) {
      const float* emq = emb + q0;
      const int nv = tc_compact(
          min(cap, total - q0), [&](int s) { return emq[s] != 0.0f; }, sList, 0,
          sCount);
      for (int t0 = 0; t0 < nv; t0 += kTcM) {
        const int nt = min(kTcM, nv - t0);
        if (tid < kTcM) {
          int s = 0, row = -1;
          float cem = 0.0f, m = 0.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f;
          if (tid < nt) {
            s = q0 + sList[t0 + tid];
            const long long gi = g0 + s;
            row = s / K;
            m = p.em[gi];
            cem = p.C[gi] * m;
            ux = p.vx[gi];
            uy = p.vy[gi];
            uz = p.vz[gi];
          }
          sRow[tid] = row;
          sOff[tid] = s;
          sCem[tid] = cem;
          sEm[tid] = m;
          sV[tid] = ux;
          sV[kTcM + tid] = uy;
          sV[2 * kTcM + tid] = uz;
        }
        __syncthreads();
        // D = ea·kall, all of 3F, into its tile (exact zeros past nt)
        for (int pz = 0; pz < np3; ++pz) {
          d_product(p, kw, ldk, sOff, nt, g0, pz, sB, acc);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = pz * kTcN + wg * 64 + tc_row(h);
            if (c >= F3) continue;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int n = tc_col64(i);
              sD[n * ldd + c] = acc[i][2 * h];
              sD[(n + 1) * ldd + c] = acc[i][2 * h + 1];
            }
          }
        }
        __syncthreads();  // D is written

        // four threads a slot, each a quarter of F in float4 steps, z =
        // zw1 + zw2g read beside the slot's g row: dd over D, dzw2g into
        // its tile (for dzw1) and out, and the slot's nine scalars
        {
          const int e = tid >> 2, qt = tid & 3;
          float t[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) t[i] = 0.0f;
          if (e < nt) {
            const float* gr = p.g + (r0 + sRow[e]) * F9;
            const float* z1 = p.zw1 + (r0 + sRow[e]) * F;
            const float* z2 = p.zw2g + (g0 + sOff[e]) * F;
            const float ux = sV[e], uy = sV[kTcM + e], uz = sV[2 * kTcM + e];
            float s5[5];
            s5_of(ux, uy, uz, s5);
            const float cem = sCem[e];
            float* dzo = dz ? p.dzw2g + (g0 + sOff[e]) * F : nullptr;
#pragma unroll 2
            for (int c = 4 * qt; c < F; c += 16) {
              float4 G[9], D[3], B[3];
#pragma unroll
              for (int d = 0; d < 9; ++d) G[d] = ldg4(gr + d * F + c);
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                D[j] = at4(sD + e * ldd + j * F + c);
                B[j] = ldg4(p.ball + j * F + c);
              }
              float4 Z = ldg4(z1 + c);
              const float4 Z2 = ldg4(z2 + c);
              Z.x += Z2.x;
              Z.y += Z2.y;
              Z.z += Z2.z;
              Z.w += Z2.w;
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const float dp0 = el(D[0], u) + el(B[0], u),
                            dp1 = el(D[1], u) + el(B[1], u),
                            dp2 = el(D[2], u) + el(B[2], u);
                const float gw0 = el(G[0], u);
                const float gw1 = el(G[1], u) * ux + el(G[2], u) * uy + el(G[3], u) * uz;
                float gw2 = 0.0f;
#pragma unroll
                for (int q = 0; q < 5; ++q) gw2 = fmaf(el(G[4 + q], u), s5[q], gw2);
                const float z = el(Z, u), cz = cem * z;
                const float dcz = gw0 * dp0 + gw1 * dp1 + gw2 * dp2;
                const float w1 = cz * dp1, w2 = cz * dp2;
                el(D[0], u) = gw0 * cz;
                el(D[1], u) = gw1 * cz;
                el(D[2], u) = gw2 * cz;
                t[0] = fmaf(dcz, z, t[0]);
#pragma unroll
                for (int d = 1; d < 4; ++d) t[d] = fmaf(w1, el(G[d], u), t[d]);
#pragma unroll
                for (int q = 4; q < 9; ++q) t[q] = fmaf(w2, el(G[q], u), t[q]);
                el(Z, u) = dcz * cem;
              }
#pragma unroll
              for (int j = 0; j < 3; ++j) at4(sD + e * ldd + j * F + c) = D[j];
              if (dz) {
                at4(sZ + e * ldz + c) = Z;
                at4(dzo + c) = Z;
              }
            }
          }
          // the quad's four quarters, in a fixed order
#pragma unroll
          for (int i = 0; i < 9; ++i) {
            t[i] += __shfl_xor_sync(0xffffffffu, t[i], 1);
            t[i] += __shfl_xor_sync(0xffffffffu, t[i], 2);
          }
          if (e < nt && (lane & 3) == 0) {
            const long long gi = g0 + sOff[e];
            const float ux = sV[e], uy = sV[kTcM + e], uz = sV[2 * kTcM + e];
            const float c43 = 4.0f / 3.0f, c23 = 2.0f / 3.0f;
            p.dC[gi] = t[0] * sEm[e];
            p.dvx[gi] = t[1] + t[4] * (c43 * ux) + t[5] * uy + t[6] * uz - t[7] * (c23 * ux);
            p.dvy[gi] = t[2] - t[4] * (c23 * uy) + t[5] * ux + t[7] * (c43 * uy) + t[8] * uz;
            p.dvz[gi] = t[3] - (t[4] + t[7]) * (c23 * uz) + t[6] * ux + t[8] * uy;
          }
        }
        __syncthreads();  // dd and dzw2g are written

        // dzw1[row] += Σ dzw2g over the tile's slots, in slot order
        if (dz)
          for (int f = tid; f < F; f += kTcThreads) {
            float sum = 0.0f;
            int cur = sRow[0];
            for (int e = 0; e < nt; ++e) {
              const int r = sRow[e];
              if (r != cur) {
                p.dzw1[(r0 + cur) * F + f] += sum;
                sum = 0.0f;
                cur = r;
              }
              sum += sZ[e * ldz + f];
            }
            p.dzw1[(r0 + cur) * F + f] += sum;
          }
        // dea = dd·kallᵀ, as deaᵀ = kall·ddᵀ per 64 rbf rows: the
        // warpgroups take alternate k stages; warpgroup 0 adds 1's sums
        for (int ra = 0; ra < R; ra += kTcM) {
          const TcActivation a{kw + (long long)min(ra + tc_row(0), R - 1) * ldk,
                               kw + (long long)min(ra + tc_row(1), R - 1) * ldk, F3};
          emb_product<kWide>(
              a,
              [&](int n, int k) {
                return k < F3 ? at4(sD + n * ldd + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              },
              F3, false, wg, 2, sB, acc);
          __syncthreads();  // both products are done: sB takes warpgroup 1's sums
          if (wg == 1)
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) sB[(i * 4 + e) * 128 + tid - 128] = acc[i][e];
          __syncthreads();
          if (wg == 0)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = ra + tc_row(h);
              if (r >= R) continue;
#pragma unroll
              for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int n = tc_col64(i) + e;
                  if (n < nt)
                    p.dea[(g0 + sOff[n]) * R + r] =
                        acc[i][2 * h + e] + sB[(i * 4 + 2 * h + e) * 128 + tid];
                }
            }
        }
        // dk: dkallᵀ and dballᵀ = ddᵀ·[ea | 1] over the tile's slots, per 64
        // columns of [ea | 1], into the block's partial row
        if constexpr (kDk) {
          for (int ra = 0; ra <= R; ra += kTcM) {
            __syncthreads();  // sB is free
            planes(
                [&](int n, int k) {
                  const int r = ra + n;
                  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                  if (r <= R)
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                      if (k + u < nt)
                        el(x, u) = r < R ? __ldg(ea + (long long)sOff[k + u] * R + r) : 1.0f;
                  return x;
                },
                0, kStages, sB);
            __syncthreads();
            for (int mt = wg; mt * kTcM < F3; mt += 2) {
              const TcColumns a{sD + min(mt * kTcM + tc_row(0), F3 - 1),
                                sD + min(mt * kTcM + tc_row(1), F3 - 1), kTcM, ldd};
#pragma unroll
              for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
              planes_mma<false>(a, 0, 0, kStages, 1, sB, acc);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int c = mt * kTcM + tc_row(h);
                if (c >= F3) continue;
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    const int r = ra + tc_col64(i) + e;
                    if (r <= R) prow[(long long)r * F3 + c] += acc[i][2 * h + e];
                  }
              }
            }
          }
        }
        __syncthreads();  // the tile's metadata, dd and dzw2g are read
      }
    }
  }
}

// out[c] = sum over blocks b (in order) of part[b][c]; the first R·3F
// columns are dkall, the last 3F dball.
__global__ void emb_dk_sum_kernel(const float* __restrict__ part, int nblocks,
                                  int width, int kall_width,
                                  float* __restrict__ dkall,
                                  float* __restrict__ dball) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  float acc = 0.0f;
  for (int b = 0; b < nblocks; ++b) acc += part[(long long)b * width + c];
  if (c < kall_width) dkall[c] = acc;
  else dball[c - kall_width] = acc;
}

// Lets kern take smem bytes of dynamic shared memory; kernel 1 also asks
// for a carveout of just two blocks' shared memory, so that the rest of
// the SM's 256 KB is L1 for kall, which it reads from device memory.
cudaError_t emb_set_smem(const void* kern, int mode, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess || mode != kFwd) return err;
  const int pct = (int)((2 * (smem + 1024) * 100 + 233471) / 233472);
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              pct < 100 ? pct : 100);
}

// Whether kall is staged in shared memory: in kernel 2, where the plan
// leaves it room.  Kernel 1 reads it from device memory: staged, its
// shared memory would leave one block an SM, not two.
bool emb_kall_smem(int mode, int f, int k, int r, bool wide) {
  return mode != kFwd && emb_smem(mode, f, k, r, true, wide) <= kSmemLimit;
}

const void* kernel_of(int mode, bool wide) {
  if (mode == kFwd)
    return wide ? (const void*)emb_fwd_tc_kernel<true> : (const void*)emb_fwd_tc_kernel<false>;
  if (mode == kBwd)
    return wide ? (const void*)emb_bwd_tc_kernel<true, false>
                : (const void*)emb_bwd_tc_kernel<false, false>;
  return wide ? (const void*)emb_bwd_tc_kernel<true, true>
              : (const void*)emb_bwd_tc_kernel<false, true>;
}

// Launches grid blocks of mode and, with dk, the sum of the partial rows
// into dkall and dball: the wide form where the caller gives a tile
// scratch, else the narrow one, whose tiles must fit shared memory.
int emb_launch(int mode, EmbParams p, float* dkall, float* dball, int grid,
               void* stream) {
  const int f = p.f, r = p.r;
  const bool wide = p.tiles != nullptr;
  if (f < 4 || f % 4 || r < 1 || p.k < 0 || grid < 1) return cudaErrorInvalidValue;
  if (mode == kBwdDk && (p.part == nullptr || dkall == nullptr || dball == nullptr))
    return cudaErrorInvalidValue;
  p.kall_smem = emb_kall_smem(mode, f, p.k, r, wide);
  const void* kern = kernel_of(mode, wide);
  const size_t smem = emb_smem(mode, f, p.k, r, p.kall_smem != 0, wide);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = emb_set_smem(kern, mode, smem);
  if (err != cudaSuccess) return err;
  if (p.n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* args[] = {&p};
  err = cudaLaunchKernel(kern, dim3((unsigned)grid), dim3(kTcThreads), args, smem, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || mode != kBwdDk) return err;
  const int width = (r + 1) * 3 * f;
  emb_dk_sum_kernel<<<(width + 255) / 256, 256, 0, st>>>(p.part, grid, width, r * 3 * f,
                                                         dkall, dball);
  return cudaGetLastError();
}

EmbParams make_params(const float* ea, const float* C, const float* vx,
                      const float* vy, const float* vz, const float* zw1,
                      const float* zw2g, const float* em, const float* kall,
                      const float* ball, float* tiles, long long n, int k, int r,
                      int f) {
  EmbParams p{};
  p.ea = ea; p.C = C; p.vx = vx; p.vy = vy; p.vz = vz; p.zw1 = zw1;
  p.zw2g = zw2g; p.em = em; p.kall = kall; p.ball = ball; p.tiles = tiles;
  p.n = n; p.k = k; p.r = r; p.f = f;
  return p;
}

}  // namespace

extern "C" {

const char* tmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Both entry points: tiles null (the narrow form: the tiles sit in shared
// memory) or a [grid · tmd_radial_embedding_tile_floats(mode, f)] scratch
// (the wide form); grid the row blocks' count ⌈n/16⌉, or at most that in
// the wide and the dk forms; f a multiple of 4, any r ≥ 1 and k.

// Kernel 1.  ea [n,k,r]; C, vx, vy, vz, em [n,k]; zw1 [n,f]; zw2g [n,k,f];
// kall [r,3f]; ball [3f]; out [n,9f].
int tmd_radial_embedding_fwd(const float* ea, const float* C, const float* vx,
                             const float* vy, const float* vz, const float* zw1,
                             const float* zw2g, const float* em,
                             const float* kall, const float* ball, float* out,
                             float* tiles, long long n, int k, int r, int f,
                             int grid, void* stream) {
  EmbParams p = make_params(ea, C, vx, vy, vz, zw1, zw2g, em, kall, ball, tiles, n, k, r, f);
  p.out = out;
  return emb_launch(kFwd, p, nullptr, nullptr, grid, stream);
}

// Kernel 2: the cotangents of kernel 1's inputs for g [n,9f].  dzw1 and
// dzw2g may both be null (not written); dkall [r,3f] and dball [3f] are
// written when part [grid, (r+1)·3f] is non-null (the dk form).
int tmd_radial_embedding_bwd(const float* ea, const float* C, const float* vx,
                             const float* vy, const float* vz, const float* zw1,
                             const float* zw2g, const float* em, const float* g,
                             const float* kall, const float* ball, float* dea,
                             float* dC, float* dvx, float* dvy, float* dvz,
                             float* dzw1, float* dzw2g, float* dkall,
                             float* dball, float* part, float* tiles,
                             long long n, int k, int r, int f, int grid,
                             void* stream) {
  if ((dzw1 == nullptr) != (dzw2g == nullptr)) return cudaErrorInvalidValue;
  EmbParams p = make_params(ea, C, vx, vy, vz, zw1, zw2g, em, kall, ball, tiles, n, k, r, f);
  p.g = g; p.dea = dea; p.dC = dC; p.dvx = dvx; p.dvy = dvy; p.dvz = dvz;
  p.dzw1 = dzw1; p.dzw2g = dzw2g; p.part = part;
  return emb_launch(part ? kBwdDk : kBwd, p, dkall, dball, grid, stream);
}

// Floats of one resident block's tiles in device memory (the wide form)
// for mode (0 = kernel 1, 1 = kernel 2, 2 = kernel 2 with dk) at f.
long long tmd_radial_embedding_tile_floats(int mode, int f) {
  return emb_tile_floats(mode, f);
}

// What the compiler and the launch give mode in its wide or narrow form at
// (f, k, r): out = registers a thread, local (spill) bytes a thread, static
// and dynamic shared memory bytes a block, resident blocks an SM, kall
// staged in shared memory.
int tmd_radial_embedding_attributes(int mode, int wide, int f, int k, int r,
                                    int* out) {
  const void* kern = kernel_of(mode, wide != 0);
  const bool kall_smem = emb_kall_smem(mode, f, k, r, wide != 0);
  const size_t smem = emb_smem(mode, f, k, r, kall_smem, wide != 0);
  cudaError_t err = emb_set_smem(kern, mode, smem);
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
  out[5] = kall_smem;
  return cudaSuccess;
}

}  // extern "C"
