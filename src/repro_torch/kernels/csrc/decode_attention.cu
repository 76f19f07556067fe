// Single-query GQA attention over a (ring) KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel, launched by decode_attention_grouped).  Same
// arithmetic: q is scaled before the dot, slots with pos < 0 are masked
// with -1e30 (so a cache with no valid slot averages its values, as the
// reference's softmax does), the online softmax runs across kv tiles in
// fp32, and the sum is clamped at 1e-30.
//
// Design.  One thread block per (batch, kv head) owns the G query heads
// that share it and loops over the cache in 64-slot tiles (the TPU grid's
// sequential kv axis becomes this loop).  Per tile: the keys are staged in
// shared memory (rows padded by one float), one thread per (head, slot)
// score, one warp per head for the tile max / exp / sum, then one thread
// per (head, dim) output element accumulates p * v with v read straight
// from device memory (consecutive dims -> coalesced).  k, v and pos are
// read through their strides, so a (W,) pos broadcast to (B, W) with a
// zero batch stride costs nothing.
//
// Bound on this card.  Decode streams the whole cache once: bytes, not
// operations, bound it (4 FLOP per cached element).  At the serving shape
// (B=64, W=128, H=K=4, hd=32) the readout moves 8.4 MB.  This version
// keeps one block per (batch, kv head), which gives 256 blocks at batch 64
// and 32 at batch 8; splitting the cache across blocks is later work.
#include "common.cuh"

namespace {

constexpr int TILE = 64;
constexpr int THREADS = 128;
constexpr int OUT_PER_THREAD = 8;  // G * hd <= THREADS * OUT_PER_THREAD

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos,
              T* __restrict__ o, int W, int H, int G, int hd, int qsb,
              int qsh, int qsd, int ksb, int ksw, int ksh, int ksd, int vsb,
              int vsw, int vsh, int vsd, int psb, int psw, float sm_scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;               // G x hd, pre-scaled
  float* ks = qs + G * hd;        // TILE x ld
  float* ss = ks + TILE * ld;     // G x TILE scores, then probabilities
  float* mrow = ss + G * TILE;    // G running max
  float* lrow = mrow + G;         // G running sum
  float* crow = lrow + G;         // G correction of the current tile

  const int kh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = THREADS / 32;

  for (int i = tid; i < G * hd; i += THREADS) {
    const int g = i / hd, d = i - g * hd;
    qs[i] = to_float(q[(long long)b * qsb + (long long)(kh * G + g) * qsh +
                       (long long)d * qsd]) *
            sm_scale;
  }
  for (int g = tid; g < G; g += THREADS) {
    mrow[g] = REPRO_NEG_INF;
    lrow[g] = 0.f;
  }
  float acc[OUT_PER_THREAD];
#pragma unroll
  for (int i = 0; i < OUT_PER_THREAD; ++i) acc[i] = 0.f;

  for (int w0 = 0; w0 < W; w0 += TILE) {
    __syncthreads();  // q/m/l initialised; previous tile's readers done
    for (int i = tid; i < TILE * hd; i += THREADS) {
      const int row = i / hd, d = i - row * hd, wj = w0 + row;
      ks[row * ld + d] =
          wj < W ? to_float(k[(long long)b * ksb + (long long)wj * ksw +
                              (long long)kh * ksh + (long long)d * ksd])
                 : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < G * TILE; i += THREADS) {
      const int g = i / TILE, j = i - g * TILE, wj = w0 + j;
      float sv = -INFINITY;  // past the end: excluded outright
      if (wj < W) {
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qs[g * hd + d] * ks[j * ld + d];
        const int p = pos[(long long)b * psb + (long long)wj * psw];
        sv = p >= 0 ? dot : REPRO_NEG_INF;
      }
      ss[i] = sv;
    }
    __syncthreads();
    for (int g = warp; g < G; g += nwarps) {
      float tmax = -INFINITY;
      for (int j = lane; j < TILE; j += 32) tmax = fmaxf(tmax, ss[g * TILE + j]);
      tmax = warp_max(tmax);
      const float m_prev = mrow[g];
      const float m_new = fmaxf(m_prev, tmax);
      float psum = 0.f;
      for (int j = lane; j < TILE; j += 32) {
        const float p = expf(ss[g * TILE + j] - m_new);
        ss[g * TILE + j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        crow[g] = corr;
        lrow[g] = lrow[g] * corr + psum;
        mrow[g] = m_new;
      }
    }
    __syncthreads();
    const int wend = min(TILE, W - w0);
#pragma unroll
    for (int slot = 0; slot < OUT_PER_THREAD; ++slot) {
      const int idx = tid + slot * THREADS;
      if (idx < G * hd) {
        const int g = idx / hd, d = idx - g * hd;
        float a = acc[slot] * crow[g];
        const T* vcol = v + (long long)b * vsb + (long long)kh * vsh +
                        (long long)d * vsd;
        for (int j = 0; j < wend; ++j)
          a += ss[g * TILE + j] * to_float(vcol[(long long)(w0 + j) * vsw]);
        acc[slot] = a;
      }
    }
  }

#pragma unroll
  for (int slot = 0; slot < OUT_PER_THREAD; ++slot) {
    const int idx = tid + slot * THREADS;
    if (idx < G * hd) {
      const int g = idx / hd, d = idx - g * hd;
      o[((long long)b * H + kh * G + g) * hd + d] =
          from_float<T>(acc[slot] / fmaxf(lrow[g], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* o, int B, int W, int H, int K, int hd, const int* st,
           float sm_scale, cudaStream_t stream) {
  const int G = H / K;
  const size_t smem =
      (size_t)(G * hd + TILE * (hd + 1) + G * TILE + 3 * G) * 4;
  cudaError_t err = set_smem(decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(K, B);
  decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(o), W, H, G, hd, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], st[12], sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,1,H,hd) via strides (b, head, d); k/v (B,W,K,hd) via (b, w, head, d);
// pos (B,W) int32 via (b, w); o contiguous (B,1,H,hd).  dtype 0 = fp32,
// 1 = bf16.  Requires H % K == 0 and (H/K) * hd <= 1024.
extern "C" int repro_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    int dtype, int B, int W, int H, int K, int hd, int qsb, int qsh, int qsd,
    int ksb, int ksw, int ksh, int ksd, int vsb, int vsw, int vsh, int vsd,
    int psb, int psw, float sm_scale, void* stream) {
  if (hd < 1 || K < 1 || H % K != 0 || (H / K) * hd > THREADS * OUT_PER_THREAD)
    return (int)cudaErrorInvalidValue;
  const int st[13] = {qsb, qsh, qsd, ksb, ksw, ksh, ksd,
                      vsb, vsw, vsh, vsd, psb, psw};
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, p, o, B, W, H, K, hd, st, sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, p, o, B, W, H, K, hd, st, sm_scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}
