// Grouped matmul of the MoE expert FFN: (E, C, D) x (E, D, F) -> (E, C, F).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py (_gmm_kernel,
// launched by gmm).  Same arithmetic: inputs are converted to fp32, the
// products are summed in an fp32 accumulator over the whole contraction
// (the TPU carries it in VMEM scratch across its sequential d-block grid
// axis), and the result is rounded once to the input dtype.
//
// Design.  One thread block owns one (expert, BM-row C tile, BN-column F
// tile) output tile and loops over D in BK steps itself (the TPU grid's
// sequential d axis becomes this loop).  Per step the block stages the x
// tile (transposed, rows padded to 16 bytes) and the w tile in shared
// memory as fp32, then each thread accumulates a TM x TN register tile
// with scalar fp32 FMAs on the CUDA cores (no tensor cores, no TF32).
// A thread's rows and columns are interleaved in 4-wide groups so its
// shared-memory reads are 16-byte vectors without bank conflicts.  x and w
// are read through their element strides; any C, D and F are taken, with
// the ragged edges masked (zeros in, nothing out).  The TPU's block
// arguments and divisibility assert are TPU tiling and are gone.
//
// Two tile shapes, chosen by the launcher from C:
//  - C <= 8 (decode: capacity_for floors at 4): BM = 8, one row per warp;
//    warps whose row is past C skip the FMAs but still help stage tiles.
//    The whole C fits one tile, so every weight element is read from
//    device memory exactly once per call.
//  - otherwise (prefill): BM = BN = 128 with 8 x 8 register tiles; each
//    weight tile is read once per 128-row C tile.
//
// Bound on this card.  Decode (C = 4, E = 8, D = 6144, F = 16384, bf16)
// moves 1.61 GB of weights for 6.4 GFLOP: bytes bound it (0.48 ms at
// 3.35 TB/s), and the design reads each weight once.  Prefill (C = 640)
// is 1.03 TFLOP per call: operations bound it (1.04 ms at the bf16
// tensor-core rate).  Scalar fp32 FMAs peak at 67 TFLOP/s, so this
// version sits well above that bound; wgmma/TMA tiles are later work.
#include "common.cuh"

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ o, int C, int D, int F, int xse, int xsc, int xsd,
           int wse, int wsd, int wsf) {
  constexpr int NTX = BN / TN, NTY = BM / TM;
  constexpr int THREADS = NTX * NTY;
  constexpr int RV = TM < 4 ? TM : 4;  // rows per 4-wide group
  constexpr int CV = TN < 4 ? TN : 4;  // columns per 4-wide group
  constexpr int LDA = BM + 4;          // 16-byte rows
  static_assert(TM % RV == 0 && TN % CV == 0, "tile shape");
  static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0,
                "tile loads must divide among the threads");
  __shared__ __align__(16) float As[BK][LDA];  // x tile, (k, row)
  __shared__ __align__(16) float Bs[BK][BN];   // w tile, (k, col)

  const int e = blockIdx.z, c0 = blockIdx.y * BM, f0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const T* xe = x + (long long)e * xse;
  const T* we = w + (long long)e * wse;
  // every row of this thread is >= its first one
  const bool idle = c0 + ty * RV >= C;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    // x tile: consecutive threads walk k (contiguous for a row-major x)
#pragma unroll
    for (int s = 0; s < BM * BK / THREADS; ++s) {
      const int i = tid + s * THREADS;
      const int r = i / BK, kk = i % BK, c = c0 + r, k = k0 + kk;
      As[kk][r] = (c < C && k < D)
                      ? to_float(xe[(long long)c * xsc + (long long)k * xsd])
                      : 0.f;
    }
    // w tile: consecutive threads walk f (contiguous for a row-major w)
#pragma unroll
    for (int s = 0; s < BK * BN / THREADS; ++s) {
      const int i = tid + s * THREADS;
      const int kk = i / BN, n = i % BN, f = f0 + n, k = k0 + kk;
      Bs[kk][n] = (f < F && k < D)
                      ? to_float(we[(long long)k * wsd + (long long)f * wsf])
                      : 0.f;
    }
    __syncthreads();
    if (!idle) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM / RV; ++i) {
          const float* src = &As[kk][i * RV * NTY + ty * RV];
          if constexpr (RV == 4) {
            const float4 v = *reinterpret_cast<const float4*>(src);
            a[i * 4 + 0] = v.x;
            a[i * 4 + 1] = v.y;
            a[i * 4 + 2] = v.z;
            a[i * 4 + 3] = v.w;
          } else {
#pragma unroll
            for (int q = 0; q < RV; ++q) a[i * RV + q] = src[q];
          }
        }
#pragma unroll
        for (int j = 0; j < TN / CV; ++j) {
          const float* src = &Bs[kk][j * CV * NTX + tx * CV];
          if constexpr (CV == 4) {
            const float4 v = *reinterpret_cast<const float4*>(src);
            b[j * 4 + 0] = v.x;
            b[j * 4 + 1] = v.y;
            b[j * 4 + 2] = v.z;
            b[j * 4 + 3] = v.w;
          } else {
#pragma unroll
            for (int q = 0; q < CV; ++q) b[j * CV + q] = src[q];
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();  // readers done before the next step's stores
  }

  T* oe = o + (long long)e * C * F;
#pragma unroll
  for (int i = 0; i < TM / RV; ++i)
#pragma unroll
    for (int q = 0; q < RV; ++q) {
      const int c = c0 + i * RV * NTY + ty * RV + q;
      if (c >= C) continue;
#pragma unroll
      for (int j = 0; j < TN / CV; ++j)
#pragma unroll
        for (int p = 0; p < CV; ++p) {
          const int f = f0 + j * CV * NTX + tx * CV + p;
          if (f < F)
            oe[(long long)c * F + f] = from_float<T>(acc[i * RV + q][j * CV + p]);
        }
    }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch_tile(const void* x, const void* w, void* o, int E, int C, int D,
                int F, const int* st, cudaStream_t stream) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  gmm_kernel<T, BM, BN, BK, TM, TN><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(o),
      C, D, F, st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, void* o, int E, int C, int D, int F,
           const int* st, cudaStream_t stream) {
  if (C <= 8)
    return launch_tile<T, 8, 128, 32, 1, 4>(x, w, o, E, C, D, F, st, stream);
  return launch_tile<T, 128, 128, 16, 8, 8>(x, w, o, E, C, D, F, st, stream);
}

}  // namespace

// x (E,C,D) read through element strides (e, c, d); w (E,D,F) through
// (e, d, f); o contiguous (E,C,F) of the same dtype.  dtype: 0 = fp32,
// 1 = bf16.
extern "C" int repro_moe_gmm_fwd(const void* x, const void* w, void* o,
                                 int dtype, int E, int C, int D, int F,
                                 int xse, int xsc, int xsd, int wse, int wsd,
                                 int wsf, void* stream) {
  if (E < 1 || C < 1 || D < 0 || F < 1) return (int)cudaErrorInvalidValue;
  const int st[6] = {xse, xsc, xsd, wse, wsd, wsf};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, o, E, C, D, F, st, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, o, E, C, D, F, st, s);
  return (int)cudaErrorInvalidValue;
}
