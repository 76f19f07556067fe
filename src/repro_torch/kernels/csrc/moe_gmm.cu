// Grouped matmul of the MoE expert FFN: (E, C, D) x (E, D, F) -> (E, C, F).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm/kernel.py (_gmm_kernel,
// launched by gmm).  Same arithmetic: the products are summed in fp32 over
// the whole contraction (the TPU carries the sum in VMEM scratch across its
// sequential d-block grid axis) and the result is rounded once to the input
// dtype.  The TPU's block arguments and divisibility assert are TPU tiling
// and are gone: any C, D and F are taken.
//
// Two variants; the Python launcher picks one from the operands before the
// launch (kernels/moe_gmm/kernel.py select_variant) and passes it here:
//
// "tc" (variant 1): bf16 on the tensor cores, for operands TMA can read
// (innermost stride 1, other strides multiples of 16 bytes, 16-byte
// aligned bases).  Tiles of x and w are loaded by TMA (128-byte swizzle)
// into a ring of shared-memory stages guarded by full / empty mbarriers;
// one producer thread issues the loads, consumer warpgroups run wgmma with
// fp32 accumulators in registers.  TMA's zero fill past each tensor's
// edge masks the ragged C, D and F; the epilogue writes only rows < C and
// columns < F (a TMA-readable w may still have an odd F, e.g. a slice of
// a wider tensor: then the prefill tile stores its column pairs one
// element at a time).
//  - C > 8 (prefill): a 128 x 256 output tile per block, 64-deep stages, 4
//    stages (192 KB).  Two consumer warpgroups own 64 rows each and issue
//    wgmma m64n256k16 with x as the K-major A operand and the w tile as the
//    MN-major B operand (transpose bit); the producer warpgroup gives its
//    registers to them (setmaxnreg 40 / 232: the 64 x 256 fp32 accumulator
//    is 128 registers a thread).  Blocks walk C tiles fastest, so the
//    blocks that share a w tile run together and w leaves device memory
//    about once.  Operations bound this shape (1.03 TFLOP per zoo call:
//    1.04 ms at 989 TFLOP/s).
//  - C <= 8 (decode): bytes bound it (1.61 GB of weights for 6.4 GFLOP at
//    the zoo shape: 0.48 ms at 3.35 TB/s), so the operands are swapped to
//    read each weight once: a block computes the (128-row F tile x C) block
//    of w^T x^T, with the w tile as the MN-major A operand of two wgmma
//    m64n8k16 and x (C padded to 8 by the zero fill) as the K-major B.  A
//    block streams the whole of D through four 17 KB stages, three blocks
//    an SM (204 KB of weights in flight per SM).  Three shallower rings
//    rather than two deeper ones (six stages) give 396 block slots: the
//    down projection's 384 tiles then run in one wave instead of 1.45, and
//    reach torch.bmm's time without splitting D across blocks (two blocks
//    an SM left it 5% slower; the up projection, 1024 tiles, is alike).
//
// "simt" (variant 0): every other case (fp32, whose wgmma would be TF32;
// bf16 that TMA cannot read, e.g. a row of 777 bf16 is not a multiple of 16
// bytes).  One thread block owns one (expert, BM-row C tile, BN-column F
// tile) output tile and loops over D in BK steps; per step it stages the x
// tile (transposed, rows padded to 16 bytes) and the w tile in shared
// memory as fp32 and each thread accumulates a TM x TN register tile with
// scalar fp32 FMAs on the CUDA cores.  A thread's rows and columns are
// interleaved in 4-wide groups so its shared-memory reads are 16-byte
// vectors without bank conflicts; x and w are read through their element
// strides.  C <= 8 takes BM = 8 (one row per warp, each weight read once),
// otherwise BM = BN = 128 with 8 x 8 register tiles.  The fp32 peak outside
// the tensor cores is 67 TFLOP/s, so this variant stays far from the
// tensor-core bound.
#include "common.cuh"
#include "sm90.cuh"

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

// ---------------------------------------------------------------------------
// "tc": bf16 wgmma fed by TMA
// ---------------------------------------------------------------------------
constexpr int TC_BK = 64;         // contraction per stage (128 bytes of bf16)
constexpr int BOX_BYTES = 64 * 64 * 2;  // one 64 x 64 bf16 TMA box

// prefill tile: 128 x 256 outputs, 2 consumer warpgroups + 1 producer
constexpr int PM = 128, PN = 256, P_STAGES = 4, P_THREADS = 384;
constexpr int PA_BYTES = PM * TC_BK * 2;         // x: 128 rows x 128 B
constexpr int PB_BYTES = TC_BK * PN * 2;         // w: 4 boxes of 64 N
constexpr int P_STAGE_BYTES = PA_BYTES + PB_BYTES;
constexpr size_t P_SMEM = size_t(P_STAGES) * P_STAGE_BYTES + 1024 +
                          2 * P_STAGES * sizeof(uint64_t);

__global__ void __launch_bounds__(P_THREADS, 1)
gmm_tc_prefill(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw,
               __nv_bfloat16* __restrict__ o, int C, int D, int F) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P_STAGES * P_STAGE_BYTES);
  uint64_t* empty = full + P_STAGES;
  const int m0 = blockIdx.x * PM, n0 = blockIdx.y * PN, e = blockIdx.z;
  const int nk = (D + TC_BK - 1) / TC_BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup: one thread issues every load
    sm90::reg_dealloc<40>();
    if (threadIdx.x == 2 * 128) {
      sm90::prefetch_tensormap(&tx);
      sm90::prefetch_tensormap(&tw);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % P_STAGES;
        sm90::mbar_wait(&empty[s], ((kt / P_STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * P_STAGE_BYTES;
        sm90::mbar_arrive_expect_tx(&full[s], P_STAGE_BYTES);
        sm90::tma_load_3d(st, &tx, &full[s], kt * TC_BK, m0, e);
#pragma unroll
        for (int j = 0; j < PN / 64; ++j)
          sm90::tma_load_3d(st + PA_BYTES + j * BOX_BYTES, &tw, &full[s],
                            n0 + 64 * j, kt * TC_BK, e);
      }
    }
  } else {  // consumer warpgroups 0 and 1: rows wg * 64 .. + 63
    sm90::reg_alloc<232>();
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % P_STAGES;
      sm90::mbar_wait(&full[s], (kt / P_STAGES) & 1);
      const uint8_t* a = smem + s * P_STAGE_BYTES + wg * 64 * 128;
      const uint8_t* b = smem + s * P_STAGE_BYTES + PA_BYTES;
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < TC_BK / 16; ++k)
        sm90::wgmma_m64n256k16_ss<0, 1>(
            acc, sm90::desc_sw128(a + 32 * k, 16, 1024),
            sm90::desc_sw128(b + 2048 * k, BOX_BYTES, 1024), 1);
      sm90::wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      sm90::wgmma_wait<1>();
      if (kt > 0 && threadIdx.x % 128 == 0)
        sm90::mbar_arrive(&empty[(kt - 1) % P_STAGES]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
    const int c0 = n0 + 2 * (lane % 4);
    __nv_bfloat16* oe = o + (long long)e * C * F;
#pragma unroll
    for (int p = 0; p < 64; ++p) {  // accumulator pairs (i = 2p, 2p + 1)
      const int row = r0 + 8 * (p % 2), col = c0 + 8 * (p / 2);
      if (row >= C || col >= F) continue;
      __nv_bfloat16* dst = oe + (long long)row * F + col;
      if (F % 2 == 0) {  // the pair is 4-byte aligned and inside the row
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[2 * p], acc[2 * p + 1]);
      } else {
        dst[0] = __float2bfloat16(acc[2 * p]);
        if (col + 1 < F) dst[1] = __float2bfloat16(acc[2 * p + 1]);
      }
    }
  }
}

// decode tile: 128 F rows x 8 (C padded) per block, 1 consumer warpgroup +
// 1 producer warp; operands swapped (out^T = w^T x^T); 3 blocks an SM
constexpr int DM = 128, DN = 8, D_STAGES = 4, D_THREADS = 160;
constexpr int DA_BYTES = DM * TC_BK * 2;         // w: 2 boxes of 64 F
constexpr int DB_BYTES = DN * TC_BK * 2;         // x: 8 rows x 128 B
constexpr int D_STAGE_BYTES = DA_BYTES + DB_BYTES;  // 17 KB, 1024-aligned
constexpr size_t D_SMEM = size_t(D_STAGES) * D_STAGE_BYTES + 1024 +
                          2 * D_STAGES * sizeof(uint64_t);

__global__ void __launch_bounds__(D_THREADS, 3)
gmm_tc_decode(const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tx,
              __nv_bfloat16* __restrict__ o, int C, int D, int F) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + D_STAGES * D_STAGE_BYTES);
  uint64_t* empty = full + D_STAGES;
  const int f0 = blockIdx.x * DM, e = blockIdx.y;
  const int nk = (D + TC_BK - 1) / TC_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < D_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp
    if (threadIdx.x == 128) {
      sm90::prefetch_tensormap(&tw);
      sm90::prefetch_tensormap(&tx);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % D_STAGES;
        sm90::mbar_wait(&empty[s], ((kt / D_STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * D_STAGE_BYTES;
        sm90::mbar_arrive_expect_tx(&full[s], D_STAGE_BYTES);
        sm90::tma_load_3d(st, &tw, &full[s], f0, kt * TC_BK, e);
        sm90::tma_load_3d(st + BOX_BYTES, &tw, &full[s], f0 + 64, kt * TC_BK,
                          e);
        sm90::tma_load_3d(st + DA_BYTES, &tx, &full[s], kt * TC_BK, 0, e);
      }
    }
  } else {  // consumer warpgroup
    float acc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[h][i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % D_STAGES;
      sm90::mbar_wait(&full[s], (kt / D_STAGES) & 1);
      const uint8_t* st = smem + s * D_STAGE_BYTES;
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < TC_BK / 16; ++k) {
        const uint64_t db = sm90::desc_sw128(st + DA_BYTES + 32 * k, 16, 1024);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sm90::wgmma_m64n8k16_ss<1, 0>(
              acc[h],
              sm90::desc_sw128(st + h * BOX_BYTES + 2048 * k, BOX_BYTES, 1024),
              db, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (kt > 0 && threadIdx.x == 0)
        sm90::mbar_arrive(&empty[(kt - 1) % D_STAGES]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc[0]);
    sm90::fence_regs(acc[1]);
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = f0 + 64 * h + warp * 16 + lane / 4 + 8 * (i / 2);
        const int c = 2 * (lane % 4) + i % 2;
        if (c < C && f < F)
          o[((long long)e * C + c) * F + f] = __float2bfloat16(acc[h][i]);
      }
  }
}

int launch_tc(const void* x, const void* w, void* o, int E, int C, int D,
              int F, const int* st, cudaStream_t stream) {
  // x (E, C, D) and w (E, D, F) as 3-d maps, innermost first
  const uint64_t xdims[3] = {(uint64_t)D, (uint64_t)C, (uint64_t)E};
  const uint64_t xstr[2] = {(uint64_t)st[1] * 2, (uint64_t)st[0] * 2};
  const uint64_t wdims[3] = {(uint64_t)F, (uint64_t)D, (uint64_t)E};
  const uint64_t wstr[2] = {(uint64_t)st[4] * 2, (uint64_t)st[3] * 2};
  const uint32_t wbox[3] = {64, TC_BK, 1};
  CUtensorMap tx, tw;
  if (!sm90::make_map_bf16(&tw, w, 3, wdims, wstr, wbox))
    return (int)cudaErrorInvalidValue;
  auto* out = static_cast<__nv_bfloat16*>(o);
  if (C > DN) {
    const uint32_t xbox[3] = {TC_BK, PM, 1};
    if (!sm90::make_map_bf16(&tx, x, 3, xdims, xstr, xbox))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = set_smem(gmm_tc_prefill, P_SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((C + PM - 1) / PM, (F + PN - 1) / PN, E);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
    gmm_tc_prefill<<<grid, P_THREADS, P_SMEM, stream>>>(tx, tw, out, C, D,
                                                        F);
    return (int)cudaGetLastError();
  }
  const uint32_t xbox[3] = {TC_BK, DN, 1};
  if (!sm90::make_map_bf16(&tx, x, 3, xdims, xstr, xbox))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(gmm_tc_decode, D_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((F + DM - 1) / DM, E);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  gmm_tc_decode<<<grid, D_THREADS, D_SMEM, stream>>>(tw, tx, out, C, D, F);
  return (int)cudaGetLastError();
}

}  // namespace

// x (E,C,D) read through element strides (e, c, d); w (E,D,F) through
// (e, d, f); o contiguous (E,C,F) of the same dtype.  dtype: 0 = fp32,
// 1 = bf16.  variant: 0 = simt, 1 = tc (bf16, TMA-readable operands; the
// launcher checks).
extern "C" int repro_moe_gmm_fwd(const void* x, const void* w, void* o,
                                 int dtype, int E, int C, int D, int F,
                                 int xse, int xsc, int xsd, int wse, int wsd,
                                 int wsf, int variant, void* stream) {
  if (E < 1 || C < 1 || D < 0 || F < 1) return (int)cudaErrorInvalidValue;
  const int st[6] = {xse, xsc, xsd, wse, wsd, wsf};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1 || D < 1 || xsd != 1 || wsf != 1)
      return (int)cudaErrorInvalidValue;
    return launch_tc(x, w, o, E, C, D, F, st, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, w, o, E, C, D, F, st, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, o, E, C, D, F, st, s);
  return (int)cudaErrorInvalidValue;
}
