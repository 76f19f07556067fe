// Causal / sliding-window GQA prefill attention with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_bhsd).  Same function: masked
// scores are -1e30, the running max, sum and accumulator are fp32, the sum
// is clamped at 1e-30 before the final division, and kv tiles entirely
// above the causal diagonal or left of the window are skipped.  The TPU
// grid runs in order and carries (m, l, acc) in VMEM scratch from one kv
// block to the next; here one thread block owns one (batch, head, query
// tile) output tile and loops over the kv tiles itself.  q, k and v are
// read in the model layout (B, S, heads, hd), so the wrapper does no
// transposes.
//
// Three variants; the Python launcher picks one from the operands before
// the launch (kernels/flash_attention/kernel.py select_variant):
//
// "tc" (variant 1): bf16 with head dim 64, or 72 to 128 in steps of 8
// (Danube's 120), operands TMA can read.  The template parameter is the
// padded width, a multiple of the 64-column TMA box (64 or 128); the
// tensor maps keep the real head dim as their innermost extent, so at hd
// 120 the second box (columns 64..127) reads columns 120..127 as zeros
// (out of bounds) and nothing of the next head.  The padded products of
// Q K^T are zero, V's zero columns give zero accumulator columns, and the
// epilogue stores only the hd / 8 real column groups; the 128-byte swizzle
// and the shared-memory layout are those of hd 128.
// A block owns 128 query rows of one head: two consumer warpgroups of 64
// rows and a producer warpgroup whose one working thread loads the q tile
// once and 128-key K and V tiles into a two-stage ring (4-d tensor maps
// over (hd, heads, S, B) pick the head by coordinate; 128-byte swizzle;
// 160 KB of shared memory at hd 128).  S = Q K^T is wgmma from shared
// memory, both operands K-major; the online softmax runs on the fp32
// accumulator registers (exp2 with the scale folded in); P is rounded to
// bf16 in registers and fed as the register A operand of O += P V, with V
// the MN-major B operand.  Masks are computed only on tiles that cross the
// diagonal, the window edge or the end of the keys (keys past Skv, zero
// filled by TMA, are -inf: excluded outright).  Query tiles are issued
// longest first so causal work balances over the SMs; consecutive blocks
// are the heads of one kv group, so their K / V tiles come from L2.
// Numerics against the TPU kernel: the fp32 scores are scaled (the TPU
// scales q in fp32 before the dot), and p is rounded to bf16 before the PV
// product (the TPU keeps p in fp32); l sums the fp32 p.  Bound on this
// card: operations at the zoo's prefill (q (2,2048,48,128), causal:
// 103 GFLOP, 0.10 ms at 989 TFLOP/s bf16).
//
// "tiled" (variant 2): fp32 with head dim 16, 32, 64 or 128, operands
// cp.async can read 16 bytes at a time -- the cascade's path, whose 2e-5
// tolerance TF32 cannot meet, so IEEE fp32 FMAs on the CUDA cores.  A
// block owns 32 query rows of one head, 4 threads a row, so that even
// the engine's bucket 8 (128 blocks on 132 SMs) nearly fills the card.  q
// is scaled in fp32 and staged once; 64-key K and V tiles go into a
// two-stage shared-memory ring by 16-byte cp.async copies, the next tile
// loading while the current one computes.  Each thread computes a 4 x 4
// (rows x keys) tile of S = q K^T from float4 loads along hd (8 loads per
// 64 FMAs), reduces each row's max by shuffles within its half-warp,
// writes P to shared memory and accumulates O += P V on a 4 x hd/16
// register tile, P and V again read as float4s.  Masks, skips and the
// -1e30 / -inf / 1e-30 rules are the tc variant's.  At the cascade's
// shape (q/k/v (64,128,4,32), causal) the function moves 16.8 MB (5 us
// at 3.35 TB/s) and does 0.27 GFLOP (4 us at 67 TFLOP/s fp32): it sits
// near the ridge.
//
// "simt" (variant 0): every other case (other head dims, bf16 that TMA
// cannot read, strides or bases cp.async cannot take).  256 threads own
// 64 query rows, four threads a row.  For scores each of the four takes
// every fourth key of the 64-key tile with a full head-dim dot product;
// for the output each takes every fourth head dim, reading the row's
// probabilities back from shared memory.  Rows are padded by one float so
// neither pass has bank conflicts.  q is scaled before the dot as on the
// TPU; fp32 arithmetic on the CUDA cores (no TF32).  Every FMA reads two
// scalars from shared memory, which bounds this variant.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per kv tile
constexpr int THREADS = 256;  // 4 threads per query row
constexpr int MAX_HD = 128;
constexpr int DPT = MAX_HD / 4;  // head dims owned per thread (max)

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int group, int hd, int qsb, int qss, int qsh, int qsd,
                 int ksb, int kss, int ksh, int ksd, int vsb, int vss,
                 int vsh, int vsd, int causal, int window, float sm_scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;            // BQ x ld, pre-scaled
  float* ks = qs + BQ * ld;    // BKV x ld
  float* vs = ks + BKV * ld;   // BKV x ld
  float* ps = vs + BKV * ld;   // BQ x (BKV + 1) probabilities

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kh = h / group;
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const int qpos = q0 + r;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int row = i / hd, d = i - row * hd, qi = q0 + row;
    float val = 0.f;
    if (qi < Sq)
      val = to_float(q[(long long)b * qsb + (long long)qi * qss +
                       (long long)h * qsh + (long long)d * qsd]) *
            sm_scale;
    qs[row * ld + d] = val;
  }

  float m = REPRO_NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  const int n_kv = (Skv + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BKV;
    // block-level skips (uniform across the block, like the TPU grid's)
    if (causal && k0 > q0 + BQ - 1) break;
    if (window > 0 && k0 + BKV - 1 <= q0 - window) continue;
    __syncthreads();  // q loaded; previous tile's readers done
    for (int i = tid; i < BKV * hd; i += THREADS) {
      const int row = i / hd, d = i - row * hd, kj = k0 + row;
      float kv = 0.f, vv = 0.f;
      if (kj < Skv) {
        kv = to_float(k[(long long)b * ksb + (long long)kj * kss +
                        (long long)kh * ksh + (long long)d * ksd]);
        vv = to_float(v[(long long)b * vsb + (long long)kj * vss +
                        (long long)kh * vsh + (long long)d * vsd]);
      }
      ks[row * ld + d] = kv;
      vs[row * ld + d] = vv;
    }
    __syncthreads();

    float s[BKV / 4];
    float tmax = -INFINITY;
#pragma unroll
    for (int t = 0; t < BKV / 4; ++t) {
      const int j = c + 4 * t, kj = k0 + j;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += qs[r * ld + d] * ks[j * ld + d];
      bool valid = true;
      if (causal) valid = valid && kj <= qpos;
      if (window > 0) valid = valid && kj > qpos - window;
      // keys past the end are excluded outright (exp(-inf) = 0); masked
      // keys take the TPU's finite -1e30
      s[t] = kj >= Skv ? -INFINITY : (valid ? dot : REPRO_NEG_INF);
      tmax = fmaxf(tmax, s[t]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < BKV / 4; ++t) {
      const float p = expf(s[t] - m_new);
      ps[r * (BKV + 1) + c + 4 * t] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // a row's four threads share one warp
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = c + 4 * i;
      if (d < hd) {
        float a = acc[i] * corr;
        for (int j = 0; j < BKV; ++j)
          a += ps[r * (BKV + 1) + j] * vs[j * ld + d];
        acc[i] = a;
      }
    }
  }

  if (qpos < Sq) {
    const float lf = fmaxf(l, 1e-30f);
    T* orow = o + (((long long)b * Sq + qpos) * H + h) * hd;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = c + 4 * i;
      if (d < hd) orow[d] = from_float<T>(acc[i] / lf);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int K, int hd, const int* st, int causal,
           int window, float sm_scale, cudaStream_t stream) {
  const size_t smem = (size_t)(3 * BQ * (hd + 1) + BQ * (BKV + 1)) * 4;
  cudaError_t err = set_smem(flash_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, H / K, hd,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window, sm_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "tiled": fp32 register tiles on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int TL_BQ = 32;      // query rows per block
constexpr int TL_THREADS = TL_BQ * 4;
constexpr int TL_BKV = 64;     // keys per kv tile
constexpr int TL_STAGES = 2;   // K/V ring depth

// Shared-memory rows are padded by 4 floats: float4 accesses stay 16-byte
// aligned, and the 16 key groups of a half-warp (rows kg + 16 j, row
// strides = 4 banks mod 32 at hd 32 / 64 / 128, 20 at hd 16) hit
// distinct banks.
template <int HD>
struct TiledShape {
  static constexpr int LD = HD + 4;            // q / K / V row, floats
  static constexpr int PLD = TL_BKV + 4;       // P row, floats
  // P.V: the 16 threads of a row group split the head dims, VW floats a
  // load, NV loads a key row, the loads of neighbouring threads adjacent
  static constexpr int VW = HD >= 64 ? 4 : HD / 16;
  static constexpr int NV = HD / (16 * VW);
  static constexpr int DPT = VW * NV;          // head dims a thread owns
};

template <int HD>
constexpr size_t tiled_smem() {
  using T = TiledShape<HD>;
  return size_t(TL_BQ * T::LD + 2 * TL_STAGES * TL_BKV * T::LD +
                TL_BQ * T::PLD) *
         sizeof(float);
}

template <int VW>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  } else {
    dst[0] = src[0];
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  else if constexpr (VW == 2)
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  else
    dst[0] = src[0];
}

__device__ __forceinline__ float f4(const float4& t, int i) {
  return i == 0 ? t.x : i == 1 ? t.y : i == 2 ? t.z : t.w;
}

// TL_BQ query rows of one (batch, head) a block, 4 TL_BQ threads: thread
// t owns rows 4 (t / 16) .. + 3 and, of each 64-key tile, keys t % 16 +
// 16 j (j < 4); the 16 threads of a row group sit in one half-warp, so
// row maxima and sums are shuffles and P is exchanged under __syncwarp.
template <int HD>
__global__ void __launch_bounds__(TL_THREADS, 4)
flash_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   int Sq, int Skv, int H, int group, int qsb, int qss,
                   int qsh, int ksb, int kss, int ksh, int vsb, int vss,
                   int vsh, int causal, int window, float sm_scale) {
  using T = TiledShape<HD>;
  constexpr int THREADS = TL_THREADS, LD = T::LD, PLD = T::PLD;
  constexpr int CH = HD / 4;  // float4s a row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // TL_BQ x LD, pre-scaled
  float* kvs = qs + TL_BQ * LD;  // stage s: K at kvs + 2 s BKV LD, then V
  float* ps = kvs + 2 * TL_STAGES * TL_BKV * LD;  // TL_BQ x PLD

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TL_BQ;  // longest tiles first
  const int kh = h / group;
  const int tid = threadIdx.x, kg = tid & 15, r0 = (tid >> 4) * 4;
  const int n_kv = (Skv + TL_BKV - 1) / TL_BKV;
  // kv tiles entirely above the diagonal or left of the window are skipped
  const int hi = causal ? min(n_kv, (q0 + TL_BQ - 1) / TL_BKV + 1) : n_kv;
  const int lo = (window > 0 && q0 - window + 1 > 0)
                     ? (q0 - window + 1) / TL_BKV : 0;

  const float* kb = k + (long long)b * ksb + (long long)kh * ksh;
  const float* vb = v + (long long)b * vsb + (long long)kh * vsh;
  auto load_tile = [&](int kt, int s) {
    float* ks = kvs + 2 * s * TL_BKV * LD;
    float* vs = ks + TL_BKV * LD;
    const int k0 = kt * TL_BKV;
    for (int i = tid; i < TL_BKV * CH; i += THREADS) {
      const int row = i / CH, c = i % CH, kj = k0 + row;
      const bool ok = kj < Skv;                     // past Skv: zeros
      const long long kr = ok ? kj : 0;
      cp_async16(ks + row * LD + 4 * c, kb + kr * kss + 4 * c, ok);
      cp_async16(vs + row * LD + 4 * c, vb + kr * vss + 4 * c, ok);
    }
    cp_async_commit();
  };
  if (lo < hi) load_tile(lo, 0);

  // q, scaled in fp32 before the dot as on the TPU; rows past Sq are 0
  const float* qb = q + (long long)b * qsb + (long long)h * qsh;
  for (int i = tid; i < TL_BQ * CH; i += THREADS) {
    const int row = i / CH, c = i % CH, qi = q0 + row;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < Sq) {
      t = *reinterpret_cast<const float4*>(qb + (long long)qi * qss + 4 * c);
      t.x *= sm_scale; t.y *= sm_scale; t.z *= sm_scale; t.w *= sm_scale;
    }
    *reinterpret_cast<float4*>(qs + row * LD + 4 * c) = t;
  }

  float acc[4][T::DPT], m[4], l[4];  // l: this thread's keys' share
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < T::DPT; ++e) acc[i][e] = 0.f;
  }

  for (int kt = lo; kt < hi; ++kt) {
    const int s = (kt - lo) & 1;
    cp_async_wait<0>();
    // tile kt (and q) visible to every thread; every thread is past the
    // previous tile, so its stage may be refilled
    __syncthreads();
    if (kt + 1 < hi) load_tile(kt + 1, s ^ 1);
    const float* ks = kvs + 2 * s * TL_BKV * LD;
    const float* vs = ks + TL_BKV * LD;

    // S = q K^T on a 4 x 4 register tile: 8 float4 loads per 64 FMAs
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (r0 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (kg + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    // masks only on tiles that cross the diagonal, the window or the end:
    // keys past Skv are -inf (excluded outright), masked keys the TPU's
    // finite -1e30
    const int k0 = kt * TL_BKV;
    if (k0 + TL_BKV > Skv || (causal && k0 + TL_BKV - 1 > q0) ||
        (window > 0 && k0 <= q0 + TL_BQ - 1 - window)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + r0 + i, col = k0 + kg + 16 * j;
          if (col >= Skv)
            sc[i][j] = -INFINITY;
          else if ((causal && col > row) || (window > 0 && col <= row - window))
            sc[i][j] = REPRO_NEG_INF;
        }
    }

    // online softmax: each row's max over its 16 threads, one half-warp
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        psum += sc[i][j];
      }
      l[i] = l[i] * corr[i] + psum;
#pragma unroll
      for (int e = 0; e < T::DPT; ++e) acc[i][e] *= corr[i];
    }
    // P to shared memory; a row group's rows are read only by its own
    // half-warp (the barrier above ordered the previous tile's reads)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(r0 + i) * PLD + kg + 16 * j] = sc[i][j];
    __syncwarp();

    // O += P V on a 4 x DPT register tile
#pragma unroll 4
    for (int j = 0; j < TL_BKV; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (r0 + i) * PLD + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[T::DPT];
#pragma unroll
        for (int c = 0; c < T::NV; ++c)
          load_vec<T::VW>(vv + c * T::VW,
                          vs + (j + jj) * LD + (16 * c + kg) * T::VW);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = f4(p4[i], jj);
#pragma unroll
          for (int e = 0; e < T::DPT; ++e)
            acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
  }

  // l: sum the row group's shares; then O / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = q0 + r0 + i;
    if (row >= Sq) continue;
    const float lf = fmaxf(li, 1e-30f);
    float out[T::DPT];
#pragma unroll
    for (int e = 0; e < T::DPT; ++e) out[e] = acc[i][e] / lf;
    float* orow = o + (((long long)b * Sq + row) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < T::NV; ++c)
      store_vec<T::VW>(orow + (16 * c + kg) * T::VW, out + c * T::VW);
  }
}

template <int HD>
int launch_tiled(const void* q, const void* k, const void* v, void* o,
                 int B, int Sq, int Skv, int H, int K, const int* st,
                 int causal, int window, float sm_scale,
                 cudaStream_t stream) {
  constexpr size_t smem = tiled_smem<HD>();
  cudaError_t err = set_smem(flash_tiled_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + TL_BQ - 1) / TL_BQ, H, B);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  flash_tiled_kernel<HD><<<grid, TL_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H,
      H / K, st[0], st[1], st[2], st[4], st[5], st[6], st[8], st[9], st[10],
      causal, window, sm_scale);
  return (int)cudaGetLastError();
}

int launch_tiled_hd(const void* q, const void* k, const void* v, void* o,
                    int B, int Sq, int Skv, int H, int K, int hd,
                    const int* st, int causal, int window, float sm_scale,
                    cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_tiled<16>(q, k, v, o, B, Sq, Skv, H, K, st, causal,
                              window, sm_scale, stream);
    case 32:
      return launch_tiled<32>(q, k, v, o, B, Sq, Skv, H, K, st, causal,
                              window, sm_scale, stream);
    case 64:
      return launch_tiled<64>(q, k, v, o, B, Sq, Skv, H, K, st, causal,
                              window, sm_scale, stream);
    case 128:
      return launch_tiled<128>(q, k, v, o, B, Sq, Skv, H, K, st, causal,
                              window, sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// "tc": bf16 wgmma fed by TMA
// ---------------------------------------------------------------------------
constexpr int TC_BM = 128, TC_BN = 128, TC_STAGES = 2, TC_THREADS = 384;
constexpr int TC_BOX_BYTES = 128 * 128;  // 128 rows x 64 bf16 (one box)
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
constexpr size_t tc_smem() {
  // q tile, then K and V tiles per stage; barriers; 1024 B of alignment
  return size_t(1 + 2 * TC_STAGES) * (HD / 64) * TC_BOX_BYTES + 1024 +
         (1 + 2 * TC_STAGES) * sizeof(uint64_t);
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                int hd, int group, int causal, int window,
                float scale_log2) {
  constexpr int BOXES = HD / 64;                  // 64-wide head-dim boxes
  constexpr int TILE = BOXES * TC_BOX_BYTES;      // one q / K / V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* kv = smem + TILE;  // stage s: K at kv + 2 s TILE, V after it
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + (1 + 2 * TC_STAGES) *
                                               TILE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + TC_STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest causal tiles first
  const int q0 = qt * TC_BM, kh = h / group;
  const int n_kv = (Skv + TC_BN - 1) / TC_BN;
  const int hi = causal ? min(n_kv, qt + 1) : n_kv;
  const int lo = (window > 0 && q0 - window + 1 > 0)
                     ? (q0 - window + 1) / TC_BN : 0;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    sm90::mbar_init(qbar, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer warpgroup
    sm90::reg_dealloc<40>();
    if (threadIdx.x == 2 * 128) {
      sm90::prefetch_tensormap(&tq);
      sm90::prefetch_tensormap(&tk);
      sm90::prefetch_tensormap(&tv);
      sm90::mbar_arrive_expect_tx(qbar, TILE);
#pragma unroll
      for (int j = 0; j < BOXES; ++j)
        sm90::tma_load_4d(qs + j * TC_BOX_BYTES, &tq, qbar, 64 * j, h, q0, b);
      for (int kt = lo; kt < hi; ++kt) {
        const int i = kt - lo, s = i % TC_STAGES;
        sm90::mbar_wait(&empty[s], ((i / TC_STAGES) & 1) ^ 1);
        uint8_t* ks = kv + 2 * s * TILE;
        sm90::mbar_arrive_expect_tx(&full[s], 2 * TILE);
#pragma unroll
        for (int j = 0; j < BOXES; ++j) {
          sm90::tma_load_4d(ks + j * TC_BOX_BYTES, &tk, &full[s], 64 * j, kh,
                            kt * TC_BN, b);
          sm90::tma_load_4d(ks + TILE + j * TC_BOX_BYTES, &tv, &full[s],
                            64 * j, kh, kt * TC_BN, b);
        }
      }
    }
  } else {  // consumer warpgroups: query rows q0 + wg * 64 .. + 63
    sm90::reg_alloc<232>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int row_base = q0 + wg * 64;  // first row of this warpgroup
    // this thread's two rows (accumulator halves r = 0, 1)
    const int qrow = row_base + warp * 16 + lane / 4;
    float oacc[HD / 2], sacc[TC_BN / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < TC_BN / 2; ++i) sacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    sm90::mbar_wait(qbar, 0);
    for (int kt = lo; kt < hi; ++kt) {
      const int i = kt - lo, s = i % TC_STAGES;
      const uint8_t* ks = kv + 2 * s * TILE;
      const uint8_t* vs = ks + TILE;
      sm90::mbar_wait(&full[s], (i / TC_STAGES) & 1);
      // S = Q K^T (fp32), both operands K-major
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
        const int off = (k / 4) * TC_BOX_BYTES + (k % 4) * 32;
        sm90::wgmma_m64n128k16_ss<0, 0>(
            sacc, sm90::desc_sw128(qs + off + wg * 64 * 128, 16, 1024),
            sm90::desc_sw128(ks + off, 16, 1024), k > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sacc);

      const int k0 = kt * TC_BN;
      const bool need_mask =
          k0 + TC_BN > Skv || (causal && k0 + TC_BN - 1 > row_base) ||
          (window > 0 && k0 <= row_base + 63 - window);
#pragma unroll
      for (int j = 0; j < TC_BN / 2; ++j) sacc[j] *= scale_log2;
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < TC_BN / 2; ++j) {
          const int row = qrow + 8 * ((j / 2) % 2);
          const int col = k0 + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
          if (col >= Skv)
            sacc[j] = -INFINITY;
          else if ((causal && col > row) || (window > 0 && col <= row - window))
            sacc[j] = REPRO_NEG_INF;
        }
      }
      // online softmax on the two rows (each spread over a lane quad)
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < TC_BN / 2; ++j)
          if ((j / 2) % 2 == r) mx = fmaxf(mx, sacc[j]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < TC_BN / 2; ++j) {
        const int r = (j / 2) % 2;
        sacc[j] = exp2f(sacc[j] - m[r]);
        psum[r] += sacc[j];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) oacc[j] *= corr[(j / 2) % 2];
      // P (bf16) as the register A operand: the accumulator of keys
      // 16 t .. 16 t + 15 is exactly the A fragment of k-step t
      uint32_t pa[TC_BN / 16][4];
#pragma unroll
      for (int t = 0; t < TC_BN / 16; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pa[t][q] = sm90::pack_bf16(sacc[8 * t + 2 * q], sacc[8 * t + 2 * q + 1]);
      // O += P V, V the MN-major B operand (hd contiguous)
      sm90::wgmma_fence();
#pragma unroll
      for (int t = 0; t < TC_BN / 16; ++t) {
        const uint64_t dv = sm90::desc_sw128(vs + 2048 * t, TC_BOX_BYTES, 1024);
        if constexpr (HD == 128)
          sm90::wgmma_m64n128k16_rs<1>(oacc, pa[t], dv, 1);
        else
          sm90::wgmma_m64n64k16_rs<1>(oacc, pa[t], dv, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(oacc);
      if (threadIdx.x % 128 == 0) sm90::mbar_arrive(&empty[s]);
    }
    // l: the quad's partial sums; then O / max(l, 1e-30)
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      inv[r] = 1.f / fmaxf(lr, 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + 8 * r;
      if (row >= Sq) continue;
      __nv_bfloat16* orow =
          o + (((long long)blockIdx.y * Sq + row) * H + h) * hd;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)  // the real hd / 8 column groups
        if (8 * c < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + 2 * (lane % 4)) =
              __floats2bfloat162_rn(oacc[4 * c + 2 * r] * inv[r],
                                    oacc[4 * c + 2 * r + 1] * inv[r]);
    }
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Skv, int H, int K, int hd, const int* st,
              int causal, int window, float sm_scale, cudaStream_t stream) {
  // (B, S, heads, hd) as 4-d maps (hd, heads, S, B), strides in bytes; the
  // real hd (<= HD) is the innermost extent, so columns hd..HD-1 of the
  // last box are out of bounds and arrive as zeros
  const uint32_t box[4] = {64, 1, 128, 1};
  const uint64_t qd[4] = {(uint64_t)hd, (uint64_t)H, (uint64_t)Sq,
                          (uint64_t)B};
  const uint64_t kd[4] = {(uint64_t)hd, (uint64_t)K, (uint64_t)Skv,
                          (uint64_t)B};
  const uint64_t qs[3] = {(uint64_t)st[2] * 2, (uint64_t)st[1] * 2,
                          (uint64_t)st[0] * 2};
  const uint64_t ks[3] = {(uint64_t)st[6] * 2, (uint64_t)st[5] * 2,
                          (uint64_t)st[4] * 2};
  const uint64_t vs[3] = {(uint64_t)st[10] * 2, (uint64_t)st[9] * 2,
                          (uint64_t)st[8] * 2};
  CUtensorMap tq, tk, tv;
  if (!sm90::make_map_bf16(&tq, q, 4, qd, qs, box) ||
      !sm90::make_map_bf16(&tk, k, 4, kd, ks, box) ||
      !sm90::make_map_bf16(&tv, v, 4, kd, vs, box))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = tc_smem<HD>();
  cudaError_t err = set_smem(flash_tc_kernel<HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (Sq + TC_BM - 1) / TC_BM);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  flash_tc_kernel<HD><<<grid, TC_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Skv, H, hd, H / K,
      causal, window, sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,Sq,H,hd), k/v (B,Skv,K,hd) read through element strides
// (b, s, head, d) x {q, k, v}; o contiguous (B,Sq,H,hd) of the same dtype.
// dtype: 0 = fp32, 1 = bf16.  window <= 0 means no window.  variant:
// 0 = simt, 1 = tc (bf16, hd 64 or 72..128 in steps of 8, TMA-readable
// operands; hd above 64 runs the 128-wide instance), 2 = tiled
// (fp32, hd 16 / 32 / 64 / 128, head dims contiguous, other strides
// multiples of 4 elements, 16-byte-aligned bases); the launcher checks,
// and so does this function.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int H, int K, int hd, int qsb, int qss, int qsh, int qsd,
    int ksb, int kss, int ksh, int ksd, int vsb, int vss, int vsh, int vsd,
    int causal, int window, int variant, float sm_scale,
    void* stream) {
  if (hd < 1 || hd > MAX_HD || K < 1 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  const int st[12] = {qsb, qss, qsh, qsd, ksb, kss, ksh, ksd,
                      vsb, vss, vsh, vsd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (dtype != 1 || qsd != 1 || ksd != 1 || vsd != 1)
      return (int)cudaErrorInvalidValue;
    if (hd == 64)
      return launch_tc<64>(q, k, v, o, B, Sq, Skv, H, K, hd, st, causal,
                           window, sm_scale, s);
    if (hd > 64 && hd % 8 == 0)  // hd <= MAX_HD: checked above
      return launch_tc<128>(q, k, v, o, B, Sq, Skv, H, K, hd, st, causal,
                            window, sm_scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (variant == 2) {
    bool ok = dtype == 0 && qsd == 1 && ksd == 1 && vsd == 1;
    for (int i = 0; i < 12; ++i) ok = ok && (i % 4 == 3 || st[i] % 4 == 0);
    const uintptr_t bases =
        reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
    ok = ok && bases % 16 == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
    return launch_tiled_hd(q, k, v, o, B, Sq, Skv, H, K, hd, st, causal,
                           window, sm_scale, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, Sq, Skv, H, K, hd, st, causal, window,
                         sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, K, hd, st, causal,
                                 window, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
