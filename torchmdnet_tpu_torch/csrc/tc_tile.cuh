// The tensor-core tile product of csrc/cheb_filter.cu (Pallas rows 5 and
// 7), csrc/blocked_mp.cu (rows 10 and 11), csrc/edge_mlp.cu (kernel 3)
// and csrc/blocked_q.cu (kernels A and B, rows 12 and 13); its split,
// wgmma step (tc_mma) and block-wide compaction (tc_compact) also serve
// csrc/radial_embedding.cu (kernels 1 and 2, rows 1 and 2), which builds
// its B operand in shared memory, and its split csrc/windowed_coulomb.cu
// (kernels C and D, rows 14 and 15, on mma.sync):
// an A operand [64 x kdim] times a [kdim x ncols] row-major series or
// weight W, one 128-column block (pass) at a time, on Hopper's warpgroup
// MMA (wgmma) in TF32 with the 3xTF32 split.  Each factor x is cut into
// hi = tf32(x) and lo = tf32(x − hi), and acc += a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi in fp32 (the lo·lo term is below fp32's last bit), so the
// product keeps the port's float32 contract (~1e-6 relative); single-pass
// TF32 (~1e-3) would not.
//
// W is split once per launch (tc_split) into an image of shared-memory
// stages: per pass and per kTcK = 16 rows, a hi and a lo plane, K-major
// with the 64-byte swizzle that wgmma reads (one 64-byte row a column).
// A block streams a pass's stages through a ring of three with cp.async,
// two ahead of the one being multiplied, so the product needs no
// registers, conversions or shared stores for W.  A goes to wgmma from
// registers: each thread builds and splits its fragment (two rows, four k
// a stage) where it is needed, from one of two sources (tc_step's Frag):
// the cos basis B(θ)[r][k] = cos(k·θ_r), computed from the rows' θ, so the
// basis takes no shared memory and no pass over it (tc_product; rows 5, 7,
// 10, 11), or fp32 rows in memory: an activation tile in shared memory,
// or in device memory where it does not fit a block (tc_product_from:
// kernel 3 and kernels A and B of csrc/blocked_q.cu, whose exact base
// also reads its rbf rows from device memory this way).  Block: kTcThreads = 256 threads, two warpgroups; warpgroup
// q owns the columns [64q, 64q + 64) for all 64 rows (wgmma m64n64k8, 32
// fp32 accumulators a thread) and issues 6 wgmma a stage (2 k-steps x 3
// terms), then waits for them: one fragment set, ~80 registers, so three
// blocks share an SM and hide each other's waits (rows 10-11; rows 5 and 7
// also hold a stage's sums, below: ~115 registers, two blocks).  Kernels
// 3, A and B fill an SM with one block; a second fragment set (a wait for
// the stage before only, over a ring of four) gained kernel 3 under 1% on
// its main list (3% with every slot live) on an H100 and spills in A and
// B, so every product keeps one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTcM = 64;          // operand rows (live slots) per tile
constexpr int kTcN = 128;         // output columns per pass
constexpr int kTcK = 16;          // series rows per stage: one 64-byte row
constexpr int kTcThreads = 256;   // two warpgroups
constexpr int kTcPlane = kTcN * kTcK;     // floats of one K-major plane
constexpr int kTcStage = 2 * kTcPlane;    // floats of a stage: hi, lo
constexpr int kTcStages = 3;              // the ring
constexpr int kTcLdW = kTcN + 8;  // row stride of the caller's epilogue tile
// floats of the shared region that holds the ring during the product and
// the caller's [64][kTcLdW] tile after it
constexpr int kTcRegion = kTcStages * kTcStage;
static_assert(kTcRegion >= kTcM * kTcLdW, "the epilogue tile fits the region");

// Floats of the split image of a [kdim x ncols] series.
__host__ __device__ __forceinline__ int tc_image_floats(int kdim, int ncols) {
  return (ncols + kTcN - 1) / kTcN * ((kdim + kTcK - 1) / kTcK) * kTcStage;
}

// The region's offset in floats from the dynamic shared memory's start:
// the planes' swizzle needs an aligned base (the launch adds 1 KB for it).
__device__ __forceinline__ int tc_region_offset(const float* smem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  return (int)(((1024u - (a & 1023u)) & 1023u) / 4u);
}

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value in an fp32 register.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// Appends, in slot order, the local slot ids s < total with pred(s) to
// list[base..]; returns how many.  Deterministic block-wide compaction of
// kTcThreads threads; sWarp holds kTcThreads / 32 ints (kernels A and B,
// kernels 1 and 2).
template <class Pred>
__device__ int tc_compact(int total, Pred pred, unsigned short* list, int base,
                          int* sWarp) {
  constexpr int kWarps = kTcThreads / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = (total + kTcThreads - 1) / kTcThreads;
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
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += sWarp[w];
    all += sWarp[w];
  }
  int pos = base + before + incl - cnt;
  for (int s = s0; s < s1; ++s)
    if (pred(s)) list[pos++] = (unsigned short)s;
  __syncthreads();
  return all;
}

// Shared-memory matrix descriptor of a K-major plane with the 64-byte
// swizzle: start address >> 4, leading offset 1 (unused for this layout),
// stride 512 bytes between 8-column groups, layout type 2 (64B swizzle).
__device__ __forceinline__ uint64_t tc_desc(const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFFu) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// d[64 x 64] += a[64 x 8] (registers, this warp's 16 rows) · b[8 x 64].
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving, reusing or reading a register that an
// issued wgmma still reads or writes: each call site follows a wait.
__device__ __forceinline__ void tc_hold(float (&d)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
__device__ __forceinline__ void tc_hold(uint32_t (&a)[2][2][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[s][h][e])::"memory");
}

// Fragment coordinates of this thread's accumulators: acc[i][2h + e] is
// output (tc_row(h), tc_col(i) + e).
__device__ __forceinline__ int tc_row(int h) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int tc_col(int i) {
  return (threadIdx.x >> 7) * 64 + i * 8 + 2 * (threadIdx.x & 3);
}

// The split image: stage (pass p, rows [16s, 16s + 16)) at floats
// (p·nstages + s)·kTcStage, its hi plane then its lo plane; element (n, k)
// of a plane at byte n·64 + 4k with the 16-byte chunk index (bits 4-5)
// XORed with bits 7-8 of that offset (the 64-byte swizzle).  Rows past
// kdim and columns past ncols are zeros.  With kT the series is the
// transpose of W [ncols x kdim] (row-major): element (row, col) is
// W[col·kdim + row].
template <bool kT>
__global__ void __launch_bounds__(kTcThreads)
tc_split_kernel(const float* __restrict__ W, int kdim, int ncols,
                float* __restrict__ image) {
  const int nstages = (kdim + kTcK - 1) / kTcK;
  const int total = (ncols + kTcN - 1) / kTcN * nstages * kTcPlane;
  for (int v = blockIdx.x * kTcThreads + threadIdx.x; v < total;
       v += gridDim.x * kTcThreads) {
    const int stage = v / kTcPlane, e = v - stage * kTcPlane;
    const int p = stage / nstages, s = stage - p * nstages;
    const int n = e / kTcK, k = e - n * kTcK;
    const int row = s * kTcK + k, col = p * kTcN + n;
    const long long at = kT ? (long long)col * kdim + row : (long long)row * ncols + col;
    const float x = row < kdim && col < ncols ? W[at] : 0.0f;
    uint32_t hi, lo;
    tf32_split(x, hi, lo);
    int o = n * 64 + 4 * k;
    o ^= ((o >> 7) & 3) << 4;
    float* dst = image + (long long)stage * kTcStage + o / 4;
    dst[0] = __uint_as_float(hi);
    dst[kTcPlane] = __uint_as_float(lo);
  }
}

// Splits series [kdim x ncols] (with transposed, the transpose of a
// row-major [ncols x kdim]) into image [tc_image_floats(kdim, ncols)] on
// stream: the first launch of every entry point that multiplies by it.
inline int tc_split(const float* series, int kdim, int ncols, float* image,
                    void* stream, bool transposed = false) {
  const int total = tc_image_floats(kdim, ncols) / 2;
  if (total == 0) return cudaSuccess;
  const int blocks = (total + kTcThreads - 1) / kTcThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (transposed)
    tc_split_kernel<true><<<blocks, kTcThreads, 0, st>>>(series, kdim, ncols, image);
  else
    tc_split_kernel<false><<<blocks, kTcThreads, 0, st>>>(series, kdim, ncols, image);
  return cudaGetLastError();
}

// Copies one stage (kTcStage floats, contiguous) of the image into sR.
__device__ __forceinline__ void tc_copy(const float* __restrict__ src, float* dst) {
#pragma unroll
  for (int q = 0; q < kTcStage / 4 / kTcThreads; ++q) {
    const int v = 4 * (threadIdx.x + kTcThreads * q);
    cp_async16(dst + v, src + v);
  }
}

// Copies this warpgroup's half of one stage (its 64 columns of the hi and
// of the lo plane: 4 KB of each) of the image into sR.
__device__ __forceinline__ void tc_copy_half(const float* __restrict__ src, float* dst) {
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int v = 4 * (t + 128 * q);  // [0, 2048): the two half planes
    const int o = (v >> 10) * kTcPlane + wg * 64 * kTcK + (v & 1023);
    cp_async16(dst + o, src + o);
  }
}

// cos(x) for x = j·θ ∈ [0, (T − 1)π], the fp32 product the plain version
// takes the cosine of: x less k·2π in two fp32 parts (Cody-Waite; the fma
// keeps each step to one rounding, |y| ≤ π + 1e-6), then __cosf, whose
// error on [−π, π] is at most 2^-21.41 absolute.  Without the reduction
// __cosf would be wrong for large x.
__device__ __forceinline__ float tc_cos(float x) {
  const float k = rintf(x * 0.159154943f);
  float y = fmaf(-k, 6.28318548f, x);
  y = fmaf(-k, -1.74845553e-7f, y);
  return __cosf(y);
}

// d += a · the stage at dHi/dLo: 6 wgmma (2 k-steps x 3 terms) and their
// wait.
__device__ __forceinline__ void tc_mma(float (&d)[8][4], uint32_t (&a)[2][2][4],
                                       uint64_t dHi, uint64_t dLo) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) {  // + 32 bytes of K a step
    wgmma_tf32(d, a[s][1], dHi + 2 * s);
    wgmma_tf32(d, a[s][0], dLo + 2 * s);
    wgmma_tf32(d, a[s][0], dHi + 2 * s);
  }
  wgmma_commit();
  wgmma_wait<0>();
  tc_hold(d);
  tc_hold(a);
}

// Where a stage's A fragment comes from.  Each source fills a[s][0] (hi)
// and a[s][1] (lo) with this thread's operand at rows tc_row(0) and
// tc_row(1), k = 16kt + 8s + t and k + 4 (t = lane % 4), as wgmma's
// m64nNk8 register layout wants; k past kdim gives 0.
//
// The cos basis cos(k·θ_r), computed from the rows' θ (rows 5, 7, 10, 11).
struct TcCosBasis {
  float th0, th1;
  int kdim;
  __device__ __forceinline__ void operator()(int kt, uint32_t (&a)[2][2][4]) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = kt * kTcK + 8 * s + t;
      tf32_split(k < kdim ? tc_cos((float)k * th0) : 0.0f, a[s][0][0], a[s][1][0]);
      tf32_split(k < kdim ? tc_cos((float)k * th1) : 0.0f, a[s][0][1], a[s][1][1]);
      tf32_split(k + 4 < kdim ? tc_cos((float)(k + 4) * th0) : 0.0f, a[s][0][2], a[s][1][2]);
      tf32_split(k + 4 < kdim ? tc_cos((float)(k + 4) * th1) : 0.0f, a[s][0][3], a[s][1][3]);
    }
  }
};

// An fp32 activation tile [64][lda] in shared memory (kernel 3, kernels
// A and B), or any rows in device memory (their wide forms' tiles, the
// exact base's rbf rows): row0 and row1 point
// at rows tc_row(0) and tc_row(1).  With lda ≡ 4 (mod 32) the eight row
// groups of a warp and its four k hit 32 distinct shared-memory banks.
struct TcActivation {
  const float* row0;
  const float* row1;
  int kdim;
  __device__ __forceinline__ void operator()(int kt, uint32_t (&a)[2][2][4]) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int k = kt * kTcK + 8 * s + t;
      tf32_split(k < kdim ? row0[k] : 0.0f, a[s][0][0], a[s][1][0]);
      tf32_split(k < kdim ? row1[k] : 0.0f, a[s][0][1], a[s][1][1]);
      tf32_split(k + 4 < kdim ? row0[k + 4] : 0.0f, a[s][0][2], a[s][1][2]);
      tf32_split(k + 4 < kdim ? row1[k + 4] : 0.0f, a[s][0][3], a[s][1][3]);
    }
  }
};

// One stage kt of a product: the copy of this warpgroup's half of stage
// kt + 2 into the buffer stage kt − 1 read, this thread's A fragment of
// stage kt into a, and their products; with kStageSums into a zeroed set,
// added to acc in fp32 after the wait.  The warpgroups synchronise apart
// (named barriers 1 and 2), so one builds its fragments while the other's
// wgmma run.
template <bool kStageSums, typename Frag>
__device__ __forceinline__ void tc_step(const Frag& frag,
                                        const float* __restrict__ src, int nk,
                                        int kt, float* sR, float (&acc)[8][4],
                                        uint32_t (&a)[2][2][4]) {
  cp_async_wait<1>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // This warpgroup's half of stage kt has landed for all its threads'
  // copies, and all of them have waited for their stage kt − 1 products:
  // that half of the buffer takes kt + 2.  Each warpgroup copies and
  // reads only its own 64 columns, so the two meet at no barrier here.
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + (int)(threadIdx.x >> 7)) : "memory");
  if (kt + 2 < nk)
    tc_copy_half(src + (kt + 2) * kTcStage, sR + ((kt + 2) % kTcStages) * kTcStage);
  cp_async_commit();
  const float* buf = sR + (kt % kTcStages) * kTcStage + (threadIdx.x >> 7) * 64 * kTcK;
  frag(kt, a);
  const uint64_t dHi = tc_desc(buf), dLo = tc_desc(buf + kTcPlane);
  if constexpr (kStageSums) {
    float stage[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) stage[i][e] = 0.0f;
    tc_mma(stage, a, dHi, dLo);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] += stage[i][e];
  } else {
    tc_mma(acc, a, dHi, dLo);
  }
}

// acc = A[0:64, 0:kdim] · W[0:kdim, 128p : 128p + 128] from the split
// image of W, the A fragments from frag (either source above), through
// the three-stage ring in sR, the region of kTcRegion floats, 1024-byte
// aligned.  Every thread calls it.  The caller synchronises first (sR is
// free, and what frag reads is written); it synchronises last (sR is free
// on return).  kStageSums: see tc_product.
template <bool kStageSums = false, typename Frag>
__device__ __forceinline__ void tc_product_from(const Frag& frag,
                                                const float* __restrict__ image,
                                                int kdim, int p, float* sR,
                                                float (&acc)[8][4]) {
  const int nk = (kdim + kTcK - 1) / kTcK;
  const float* src = image + (long long)p * nk * kTcStage;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  uint32_t a[2][2][4];
  tc_copy_half(src, sR);
  cp_async_commit();
  if (nk > 1) tc_copy_half(src + kTcStage, sR + kTcStage);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt)
    tc_step<kStageSums>(frag, src, nk, kt, sR, acc, a);
  __syncthreads();
}

// acc = B(θ)[0:64, 0:kdim] · W[0:kdim, 128p : 128p + 128] from the split
// image of W; sTheta holds the 64 rows' θ.  It synchronises first (sR may
// still be read by the caller, sTheta is written) and last (sR is free on
// return).  The tensor cores round each accumulation of a wgmma
// less exactly than an fp32 add, and acc takes 48 of them a pass: ~2e-6
// of max |acc| where the series' terms cancel.  kStageSums sums each stage
// apart and adds it to acc in fp32 (8 adds a pass, ~1e-6) for 32 more
// registers, which leave room for two blocks an SM, not three.  Rows 5
// and 7, whose output is the filter itself, take it; rows 10-11 keep the
// tensor cores' sums (~1.5e-6), as with stage sums they ran 10-19% slower
// on an H100.
template <bool kStageSums = false>
__device__ __forceinline__ void tc_product(const float* __restrict__ sTheta,
                                           const float* __restrict__ image, int kdim,
                                           int p, float* sR, float (&acc)[8][4]) {
  __syncthreads();  // the caller no longer reads sR; sTheta is written
  const int row = tc_row(0);
  tc_product_from<kStageSums>(TcCosBasis{sTheta[row], sTheta[row + 8], kdim},
                              image, kdim, p, sR, acc);
}

}  // namespace
