// TensorNet radial tensor embedding: forward and backward kernels for Hopper
// (sm_90a), fp32 FMA throughout (no TF32, parity with "highest").
//
// Replaces the Pallas TPU kernels torchmdnet_tpu/ops/pallas_embedding.py:
//   forward  _emb_kernel      (:80,  pallas_call :132, fused_radial_embedding)
//   backward _emb_bwd_kernel  (:178, pallas_call :269, via _bwd_op :305)
//
// Per atom row n, over its K neighbor slots k and F channels f:
//   dp_j[k,f] = ball[jF+f] + sum_r ea[n,k,r] kall[r, jF+f]        j = 0,1,2
//   cz[k,f]   = C[n,k] (zw1[n,f] + zw2g[n,k,f]) em[n,k]
//   w_j       = cz dp_j
//   out[n]    = (sum_k w0, sum_k w1 v_d (d=x,y,z), sum_k w2 s5_c(v) (c<5))  [9F]
// with s5 = (vx^2-tr3, vx vy, vx vz, vy^2-tr3, vy vz), tr3 = |v|^2/3.
//
// Bound (N=25,088, K=96, R=32, F=128, about 75% of the slots valid): the
// forward is ~50 GFLOP of dp products over ~1.7 GB of traffic (zw2g is
// 1.23 GB), so fp32 operations bound it: ~0.74 ms at the NVIDIA H100 SXM
// data-sheet 67 TFLOP/s (700 W).  The backward recomputes dp and reduces dea
// over the 3F channels: ~100 GFLOP (~145 GFLOP with dkall) over ~3.3 GB,
// ~1.5 ms at the same rate, also operation-bound.
//
// Design against that bound: one block per atom row, one thread per
// channel.  Each thread keeps its three kall columns (3R floats) in
// registers: a thread needs only its own columns, so the [R, 3F] table is
// never staged in shared memory, and the dp product needs one
// shared-memory broadcast load of ea[k, r..r+3] (float4) per 12 FMAs and
// nothing else.  dp, cz and the w_j never leave registers; only [N, 9F]
// is written.  The backward
// forms dea[k, :] as per-thread partials p_r = sum_j ddp_j kall[r, jF+f]
// (register FMAs again) and sums them over the channels with a warp
// reduce-scatter (31 shuffles per k for R = 32) plus a cross-warp pass
// through shared memory.  dkall/dball sum over all rows: each block walks
// a grid-strided set of rows, keeps its partial sums in registers, writes
// them to a scratch row, and a second kernel adds the rows in a fixed
// order (deterministic, no atomics).  They are computed only on request.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // k slots per cross-warp reduction pass

__device__ __forceinline__ void s5_of(float vx, float vy, float vz, float s[5]) {
  const float tr3 = (vx * vx + vy * vy + vz * vz) / 3.0f;
  s[0] = vx * vx - tr3;
  s[1] = vx * vy;
  s[2] = vx * vz;
  s[3] = vy * vy - tr3;
  s[4] = vy * vz;
}

// After the call, lane l holds the warp-wide sum of v[l % M] (M a power of
// two <= 32).  Butterfly reduce-scatter: M-1 shuffles, then log2(32/M).
template <int M>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[M], int lane) {
#pragma unroll
  for (int w = M / 2; w >= 1; w /= 2) {
    const bool up = (lane & w) != 0;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float send = up ? v[i] : v[i + w];
      const float keep = up ? v[i + w] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
    }
  }
  float s = v[0];
#pragma unroll
  for (int w = M; w < 32; w *= 2) s += __shfl_xor_sync(0xffffffffu, s, w);
  return s;
}

template <int R>
__global__ void __launch_bounds__(256)
emb_fwd_kernel(const float* __restrict__ ea, const float* __restrict__ C,
               const float* __restrict__ vx, const float* __restrict__ vy,
               const float* __restrict__ vz, const float* __restrict__ zw1,
               const float* __restrict__ zw2g, const float* __restrict__ em,
               const float* __restrict__ kall, const float* __restrict__ ball,
               float* __restrict__ out, int K, int F) {
  extern __shared__ __align__(16) float smem[];
  float* sEa = smem;          // [K * R]
  float* sC = sEa + K * R;    // [K]
  float* sEm = sC + K;        // [K]
  float* sV = sEm + K;        // [3][K]

  const int n = blockIdx.x;
  const long long nk = (long long)n * K;
  for (int i = threadIdx.x; i < K * R; i += blockDim.x) sEa[i] = ea[nk * R + i];
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    sC[i] = C[nk + i];
    sEm[i] = em[nk + i];
    sV[i] = vx[nk + i];
    sV[K + i] = vy[nk + i];
    sV[2 * K + i] = vz[nk + i];
  }
  __syncthreads();

  const int F3 = 3 * F;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float k0[R], k1[R], k2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      k0[r] = kall[r * F3 + f];
      k1[r] = kall[r * F3 + F + f];
      k2[r] = kall[r * F3 + 2 * F + f];
    }
    const float b0 = ball[f], b1 = ball[F + f], b2 = ball[2 * F + f];
    const float z1 = zw1[(long long)n * F + f];
    float acc[9];
#pragma unroll
    for (int b = 0; b < 9; ++b) acc[b] = 0.0f;
    const float* zrow = zw2g + nk * F + f;
    for (int k = 0; k < K; ++k) {
      float d0 = b0, d1 = b1, d2 = b2;
      const float4* e4 = reinterpret_cast<const float4*>(sEa + k * R);
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 e = e4[q];
        d0 = fmaf(e.x, k0[4 * q], d0);
        d1 = fmaf(e.x, k1[4 * q], d1);
        d2 = fmaf(e.x, k2[4 * q], d2);
        d0 = fmaf(e.y, k0[4 * q + 1], d0);
        d1 = fmaf(e.y, k1[4 * q + 1], d1);
        d2 = fmaf(e.y, k2[4 * q + 1], d2);
        d0 = fmaf(e.z, k0[4 * q + 2], d0);
        d1 = fmaf(e.z, k1[4 * q + 2], d1);
        d2 = fmaf(e.z, k2[4 * q + 2], d2);
        d0 = fmaf(e.w, k0[4 * q + 3], d0);
        d1 = fmaf(e.w, k1[4 * q + 3], d1);
        d2 = fmaf(e.w, k2[4 * q + 3], d2);
      }
      const float cz = sC[k] * (z1 + zrow[(long long)k * F]) * sEm[k];
      const float w0 = cz * d0, w1 = cz * d1, w2 = cz * d2;
      const float ux = sV[k], uy = sV[K + k], uz = sV[2 * K + k];
      float s[5];
      s5_of(ux, uy, uz, s);
      acc[0] += w0;
      acc[1] = fmaf(w1, ux, acc[1]);
      acc[2] = fmaf(w1, uy, acc[2]);
      acc[3] = fmaf(w1, uz, acc[3]);
#pragma unroll
      for (int c = 0; c < 5; ++c) acc[4 + c] = fmaf(w2, s[c], acc[4 + c]);
    }
    float* orow = out + (long long)n * 9 * F + f;
#pragma unroll
    for (int b = 0; b < 9; ++b) orow[b * F] = acc[b];
  }
}

// One thread per channel (blockDim.x == F, a multiple of 32).  Rows are
// grid-strided so that, with DK, each block's dkall/dball partial covers a
// fixed set of rows.
template <int R, bool DK>
__global__ void __launch_bounds__(256)
emb_bwd_kernel(const float* __restrict__ ea, const float* __restrict__ C,
               const float* __restrict__ vx, const float* __restrict__ vy,
               const float* __restrict__ vz, const float* __restrict__ zw1,
               const float* __restrict__ zw2g, const float* __restrict__ em,
               const float* __restrict__ g, const float* __restrict__ kall,
               const float* __restrict__ ball, float* __restrict__ dea,
               float* __restrict__ dC, float* __restrict__ dvx,
               float* __restrict__ dvy, float* __restrict__ dvz,
               float* __restrict__ dzw1, float* __restrict__ dzw2g,
               float* __restrict__ part, int N, int K, int F) {
  extern __shared__ __align__(16) float smem[];
  const int NW = F / 32;
  float* sEa = smem;                 // [K * R]
  float* sC = sEa + K * R;           // [K]
  float* sEm = sC + K;               // [K]
  float* sV = sEm + K;               // [3][K]
  float* sP = sV + 3 * K;            // [kChunk][NW][R]   dea partials
  float* sS = sP + kChunk * NW * R;  // [kChunk][NW][16]  scalar partials

  const int f = threadIdx.x;
  const int lane = f & 31, warp = f >> 5;
  const int F3 = 3 * F;

  float k0[R], k1[R], k2[R];
  if constexpr (!DK) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      k0[r] = kall[r * F3 + f];
      k1[r] = kall[r * F3 + F + f];
      k2[r] = kall[r * F3 + 2 * F + f];
    }
  }
  float dk0[R], dk1[R], dk2[R];
  float db0 = 0.0f, db1 = 0.0f, db2 = 0.0f;
  if constexpr (DK) {
#pragma unroll
    for (int r = 0; r < R; ++r) dk0[r] = dk1[r] = dk2[r] = 0.0f;
  }
  const float b0 = ball[f], b1 = ball[F + f], b2 = ball[2 * F + f];

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const long long nk = (long long)n * K;
    __syncthreads();  // the previous row is done with shared memory
    for (int i = f; i < K * R; i += F) sEa[i] = ea[nk * R + i];
    for (int i = f; i < K; i += F) {
      sC[i] = C[nk + i];
      sEm[i] = em[nk + i];
      sV[i] = vx[nk + i];
      sV[K + i] = vy[nk + i];
      sV[2 * K + i] = vz[nk + i];
    }
    float gr[9];
#pragma unroll
    for (int b = 0; b < 9; ++b) gr[b] = g[(long long)n * 9 * F + b * F + f];
    const float z1 = zw1[(long long)n * F + f];
    float dz1 = 0.0f;
    __syncthreads();

    for (int k0i = 0; k0i < K; k0i += kChunk) {
      const int kc = min(kChunk, K - k0i);
      for (int kk = 0; kk < kc; ++kk) {
        const int k = k0i + kk;
        float d0 = b0, d1 = b1, d2 = b2;
        const float4* e4 = reinterpret_cast<const float4*>(sEa + k * R);
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
          const float4 e = e4[q];
          const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int r = 4 * q + t;
            float c0, c1, c2;
            if constexpr (DK) {
              c0 = __ldg(kall + r * F3 + f);
              c1 = __ldg(kall + r * F3 + F + f);
              c2 = __ldg(kall + r * F3 + 2 * F + f);
            } else {
              c0 = k0[r];
              c1 = k1[r];
              c2 = k2[r];
            }
            d0 = fmaf(ev[t], c0, d0);
            d1 = fmaf(ev[t], c1, d1);
            d2 = fmaf(ev[t], c2, d2);
          }
        }
        const float ux = sV[k], uy = sV[K + k], uz = sV[2 * K + k];
        float s[5];
        s5_of(ux, uy, uz, s);
        const float z = z1 + zw2g[(nk + k) * F + f];
        const float cz = sC[k] * z * sEm[k];
        const float w1 = cz * d1, w2 = cz * d2;
        const float gw0 = gr[0];
        const float gw1 = gr[1] * ux + gr[2] * uy + gr[3] * uz;
        float gw2 = 0.0f;
#pragma unroll
        for (int c = 0; c < 5; ++c) gw2 = fmaf(gr[4 + c], s[c], gw2);
        const float dcz = gw0 * d0 + gw1 * d1 + gw2 * d2;
        const float dd0 = gw0 * cz, dd1 = gw1 * cz, dd2 = gw2 * cz;
        const float dzg = dcz * sEm[k] * sC[k];
        if (dzw2g) dzw2g[(nk + k) * F + f] = dzg;
        dz1 += dzg;

        float p[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float c0, c1, c2;
          if constexpr (DK) {
            c0 = __ldg(kall + r * F3 + f);
            c1 = __ldg(kall + r * F3 + F + f);
            c2 = __ldg(kall + r * F3 + 2 * F + f);
          } else {
            c0 = k0[r];
            c1 = k1[r];
            c2 = k2[r];
          }
          p[r] = fmaf(dd0, c0, fmaf(dd1, c1, dd2 * c2));
        }
        const float pr = warp_reduce_scatter<R>(p, lane);
        if (lane < R) sP[(kk * NW + warp) * R + lane] = pr;

        // per-slot scalars: dC/em, then w1 g_{1+d} (d<3), then w2 g_{4+c}
        float sc[16];
        sc[0] = dcz * z;
        sc[1] = w1 * gr[1];
        sc[2] = w1 * gr[2];
        sc[3] = w1 * gr[3];
#pragma unroll
        for (int c = 0; c < 5; ++c) sc[4 + c] = w2 * gr[4 + c];
#pragma unroll
        for (int c = 9; c < 16; ++c) sc[c] = 0.0f;
        const float sr = warp_reduce_scatter<16>(sc, lane);
        if (lane < 9) sS[(kk * NW + warp) * 16 + lane] = sr;

        if constexpr (DK) {
#pragma unroll
          for (int q = 0; q < R / 4; ++q) {
            const float4 e = e4[q];
            const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              dk0[4 * q + t] = fmaf(ev[t], dd0, dk0[4 * q + t]);
              dk1[4 * q + t] = fmaf(ev[t], dd1, dk1[4 * q + t]);
              dk2[4 * q + t] = fmaf(ev[t], dd2, dk2[4 * q + t]);
            }
          }
          db0 += dd0;
          db1 += dd1;
          db2 += dd2;
        }
      }
      __syncthreads();
      for (int o = f; o < kc * R; o += F) {
        const int kk = o / R, r = o - kk * R;
        float acc = 0.0f;
        for (int w = 0; w < NW; ++w) acc += sP[(kk * NW + w) * R + r];
        dea[(nk + k0i + kk) * R + r] = acc;
      }
      if (f < kc) {
        const int kk = f, k = k0i + kk;
        float t[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) t[i] = 0.0f;
        for (int w = 0; w < NW; ++w) {
#pragma unroll
          for (int i = 0; i < 9; ++i) t[i] += sS[(kk * NW + w) * 16 + i];
        }
        const float ux = sV[k], uy = sV[K + k], uz = sV[2 * K + k];
        const float c43 = 4.0f / 3.0f, c23 = 2.0f / 3.0f;
        dC[nk + k] = t[0] * sEm[k];
        dvx[nk + k] = t[1] + t[4] * (c43 * ux) + t[5] * uy + t[6] * uz
                      - t[7] * (c23 * ux);
        dvy[nk + k] = t[2] - t[4] * (c23 * uy) + t[5] * ux + t[7] * (c43 * uy)
                      + t[8] * uz;
        dvz[nk + k] = t[3] - (t[4] + t[7]) * (c23 * uz) + t[6] * ux + t[8] * uy;
      }
      __syncthreads();  // sP/sS are rewritten by the next chunk
    }
    if (dzw1) dzw1[(long long)n * F + f] = dz1;
  }

  if constexpr (DK) {
    float* prow = part + (long long)blockIdx.x * (R + 1) * F3;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      prow[r * F3 + f] = dk0[r];
      prow[r * F3 + F + f] = dk1[r];
      prow[r * F3 + 2 * F + f] = dk2[r];
    }
    prow[R * F3 + f] = db0;
    prow[R * F3 + F + f] = db1;
    prow[R * F3 + 2 * F + f] = db2;
  }
}

// out[c] = sum over blocks b (in order) of part[b][c]; the first R*3F
// columns are dkall, the last 3F dball.
__global__ void sum_partials_kernel(const float* __restrict__ part, int nblocks,
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

size_t fwd_smem(int K, int R) { return sizeof(float) * ((size_t)K * R + 5 * K); }

size_t bwd_smem(int K, int R, int F) {
  const int NW = F / 32;
  return sizeof(float) *
         ((size_t)K * R + 5 * K + (size_t)kChunk * NW * R + (size_t)kChunk * NW * 16);
}

template <int R>
cudaError_t launch_fwd(const float* ea, const float* C, const float* vx,
                       const float* vy, const float* vz, const float* zw1,
                       const float* zw2g, const float* em, const float* kall,
                       const float* ball, float* out, int n, int k, int f,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem(k, R);
  cudaError_t err = cudaFuncSetAttribute(
      emb_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = f < 256 ? f : 256;
  emb_fwd_kernel<R><<<n, threads, smem, stream>>>(ea, C, vx, vy, vz, zw1, zw2g,
                                                  em, kall, ball, out, k, f);
  return cudaGetLastError();
}

template <int R, bool DK>
cudaError_t launch_bwd(const float* ea, const float* C, const float* vx,
                       const float* vy, const float* vz, const float* zw1,
                       const float* zw2g, const float* em, const float* g,
                       const float* kall, const float* ball, float* dea,
                       float* dC, float* dvx, float* dvy, float* dvz,
                       float* dzw1, float* dzw2g, float* dkall, float* dball,
                       float* part, int n, int k, int f, int nblocks,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem(k, R, f);
  cudaError_t err = cudaFuncSetAttribute(emb_bwd_kernel<R, DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  emb_bwd_kernel<R, DK><<<nblocks, f, smem, stream>>>(
      ea, C, vx, vy, vz, zw1, zw2g, em, g, kall, ball, dea, dC, dvx, dvy, dvz,
      dzw1, dzw2g, part, n, k, f);
  err = cudaGetLastError();
  if (err != cudaSuccess || !DK) return err;
  const int width = (R + 1) * 3 * f;
  sum_partials_kernel<<<(width + 255) / 256, 256, 0, stream>>>(
      part, nblocks, width, R * 3 * f, dkall, dball);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tmd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shapes: ea [n,k,r]; C, vx, vy, vz, em [n,k]; zw1 [n,f]; zw2g [n,k,f];
// kall [r,3f]; ball [3f]; out [n,9f].  r in {8,16,32}; f a multiple of 32.
int tmd_radial_embedding_fwd(const float* ea, const float* C, const float* vx,
                             const float* vy, const float* vz, const float* zw1,
                             const float* zw2g, const float* em,
                             const float* kall, const float* ball, float* out,
                             int n, int k, int r, int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 8:
      return launch_fwd<8>(ea, C, vx, vy, vz, zw1, zw2g, em, kall, ball, out, n, k, f, s);
    case 16:
      return launch_fwd<16>(ea, C, vx, vy, vz, zw1, zw2g, em, kall, ball, out, n, k, f, s);
    case 32:
      return launch_fwd<32>(ea, C, vx, vy, vz, zw1, zw2g, em, kall, ball, out, n, k, f, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Cotangents of the forward for g [n,9f].  dzw1/dzw2g may be null (not
// written).  dkall [r,3f] and dball [3f] are written when part is non-null
// (scratch [nblocks, (r+1)*3f]); blockDim is f, so f <= 256.
int tmd_radial_embedding_bwd(const float* ea, const float* C, const float* vx,
                             const float* vy, const float* vz, const float* zw1,
                             const float* zw2g, const float* em, const float* g,
                             const float* kall, const float* ball, float* dea,
                             float* dC, float* dvx, float* dvy, float* dvz,
                             float* dzw1, float* dzw2g, float* dkall,
                             float* dball, float* part, int n, int k, int r,
                             int f, int nblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dk = part != nullptr;
#define TMD_BWD_ARGS                                                      \
  ea, C, vx, vy, vz, zw1, zw2g, em, g, kall, ball, dea, dC, dvx, dvy, dvz, \
      dzw1, dzw2g, dkall, dball, part, n, k, f, nblocks, s
  switch (r) {
    case 8:
      return dk ? launch_bwd<8, true>(TMD_BWD_ARGS) : launch_bwd<8, false>(TMD_BWD_ARGS);
    case 16:
      return dk ? launch_bwd<16, true>(TMD_BWD_ARGS) : launch_bwd<16, false>(TMD_BWD_ARGS);
    case 32:
      return dk ? launch_bwd<32, true>(TMD_BWD_ARGS) : launch_bwd<32, false>(TMD_BWD_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef TMD_BWD_ARGS
}

}  // extern "C"
