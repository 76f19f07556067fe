// Causal / sliding-window GQA prefill attention with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_bhsd).  Same arithmetic:
// q is scaled before the dot, masked scores are -1e30, the running max,
// sum and accumulator are fp32, and the sum is clamped at 1e-30 before the
// final division.  kv tiles entirely above the causal diagonal or left of
// the window are skipped.
//
// Design.  The TPU kernel runs its grid in order and carries (m, l, acc)
// in VMEM scratch from one kv block to the next; here one thread block
// owns one (batch, head, 64-query tile) output tile and loops over the kv
// tiles itself.  256 threads: four threads per query row.  For scores
// each of the four takes every fourth key of the 64-key tile with a full
// head-dim dot product; for the output each takes every fourth head dim,
// reading the row's probabilities back from shared memory.  Rows are
// padded by one float so neither pass has bank conflicts.  q, k and v are
// read through their strides in the model layout (B, S, heads, hd), so
// the wrapper does no transposes; fp32 or bf16 in, fp32 arithmetic on the
// CUDA cores (no TF32), the input dtype out.
//
// Bound on this card.  At the serving shape (q/k/v (64,128,4,32) fp32,
// causal) the function moves 16.8 MB (3.35 TB/s: 5 us) and does about
// 0.27 GFLOP (67 TFLOP/s fp32: 4 us), so it sits near the ridge.  This
// first version uses scalar fp32 FMAs from shared memory and is far from
// either bound; tensor-core (wgmma) tiles are later work.
#include "common.cuh"

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

}  // namespace

// q (B,Sq,H,hd), k/v (B,Skv,K,hd) read through element strides
// (b, s, head, d) x {q, k, v}; o contiguous (B,Sq,H,hd) of the same dtype.
// dtype: 0 = fp32, 1 = bf16.  window <= 0 means no window.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Skv, int H, int K, int hd, int qsb, int qss, int qsh, int qsd,
    int ksb, int kss, int ksh, int ksd, int vsb, int vss, int vsh, int vsd,
    int causal, int window, float sm_scale, void* stream) {
  if (hd < 1 || hd > MAX_HD || K < 1 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  const int st[12] = {qsb, qss, qsh, qsd, ksb, kss, ksh, ksd,
                      vsb, vss, vsh, vsd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, B, Sq, Skv, H, K, hd, st, causal, window,
                         sm_scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, K, hd, st, causal,
                                 window, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
