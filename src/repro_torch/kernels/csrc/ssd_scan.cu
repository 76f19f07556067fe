// Mamba2 SSD chunked scan (n_groups = 1), forward.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_scan_chunked).  Per chunk of L tokens:
// cum = cumsum(A dt); the intra-chunk term y_i = sum_{j<=i} (C_i . B_j)
// exp(cum_i - cum_j) dt_j x_j; the inter-chunk term exp(cum_i) C_i . h;
// and the state update h <- h exp(cum_{L-1}) + sum_j exp(cum_{L-1} -
// cum_j) dt_j x_j B_j^T, with an fp32 (hp x N) state.
//
// Design.  The TPU grid walks the chunk axis in order and carries h in
// VMEM scratch; here one thread block per (head, batch) owns the whole
// sequence and loops over the chunks, with h resident in shared memory.
// The decay exp(cum_i - cum_j) is evaluated only for i >= j (the upper
// triangle can overflow).  At the serving shape (L=64, hp=64, N=32) the
// fp32 tiles take about 59 KB — x 16 KB, B and C 17 KB, the (L x L)
// scores 16 KB, h 8 KB — above the 48 KB default, so the launch opts
// into more dynamic shared memory first.  Rows of B, C and h are padded
// by one float against bank conflicts.
//
// Bound on this card.  At the serving shape (x (64,128,6,64)) the scan
// moves about 27 MB and does about 0.6 GFLOP, near the ridge.  The grid is
// (heads, batch): 6 x 64 = 384 blocks at batch 64 but only 6 x 8 = 48 at
// the smallest bucket, which leaves most of the 132 SMs idle; splitting
// the chunk axis across blocks (a second pass for the state) is later
// work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ adt,
           const float* __restrict__ dt, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y, int S, int H,
           int hp, int N, int L, int xsb, int xss, int xsh, int xsp, int asb,
           int ass, int ash, int dsb, int dss, int dsh, int bsb, int bss,
           int bsn, int csb, int css, int csn) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* xs = smem;              // L x hp
  float* bs = xs + L * hp;       // L x ldn
  float* cs = bs + L * ldn;      // L x ldn
  float* sc = cs + L * ldn;      // L x L intra-chunk scores (incl. dt_j)
  float* hs = sc + L * L;        // hp x ldn carried state
  float* cum = hs + hp * ldn;    // L
  float* dts = cum + L;          // L
  float* wout = dts + L;         // L: exp(cum_{L-1} - cum_j) dt_j

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  for (int i = tid; i < hp * ldn; i += THREADS) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();  // previous chunk's readers done
    for (int i = tid; i < L * hp; i += THREADS) {
      const int j = i / hp, p = i - j * hp;
      xs[i] = x[(long long)b * xsb + (long long)(c0 + j) * xss +
                (long long)h * xsh + (long long)p * xsp];
    }
    for (int i = tid; i < L * N; i += THREADS) {
      const int j = i / N, n = i - j * N;
      bs[j * ldn + n] = Bm[(long long)b * bsb + (long long)(c0 + j) * bss +
                           (long long)n * bsn];
      cs[j * ldn + n] = Cm[(long long)b * csb + (long long)(c0 + j) * css +
                           (long long)n * csn];
    }
    for (int j = tid; j < L; j += THREADS) {
      cum[j] = adt[(long long)b * asb + (long long)(c0 + j) * ass +
                   (long long)h * ash];
      dts[j] = dt[(long long)b * dsb + (long long)(c0 + j) * dss +
                  (long long)h * dsh];
    }
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum of A dt over the chunk
      float run = 0.f;
      for (int j = 0; j < L; ++j) {
        run += cum[j];
        cum[j] = run;
      }
    }
    __syncthreads();
    for (int i = tid; i < L * L; i += THREADS) {
      const int r = i / L, j = i - r * L;
      float val = 0.f;
      if (j <= r) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot += cs[r * ldn + n] * bs[j * ldn + n];
        val = dot * expf(cum[r] - cum[j]) * dts[j];
      }
      sc[i] = val;
    }
    for (int j = tid; j < L; j += THREADS)
      wout[j] = expf(cum[L - 1] - cum[j]) * dts[j];
    __syncthreads();
    for (int i = tid; i < L * hp; i += THREADS) {
      const int r = i / hp, p = i - r * hp;
      float a = 0.f;
      for (int j = 0; j <= r; ++j) a += sc[r * L + j] * xs[j * hp + p];
      float e = 0.f;
      for (int n = 0; n < N; ++n) e += cs[r * ldn + n] * hs[p * ldn + n];
      a += expf(cum[r]) * e;
      y[(((long long)b * S + c0 + r) * H + h) * hp + p] = a;
    }
    __syncthreads();  // the inter-chunk reads of h are done
    const float dec = expf(cum[L - 1]);
    for (int i = tid; i < hp * N; i += THREADS) {
      const int p = i / N, n = i - p * N;
      float a = 0.f;
      for (int j = 0; j < L; ++j) a += xs[j * hp + p] * wout[j] * bs[j * ldn + n];
      hs[p * ldn + n] = hs[p * ldn + n] * dec + a;
    }
  }
}

// Shared memory one block of the scan needs, in bytes (mirrored by
// smem_bytes in ssd_scan/kernel.py).
size_t smem_bytes(int hp, int N, int L) {
  return (size_t)(L * hp + 2 * L * (N + 1) + L * L + hp * (N + 1) + 3 * L) * 4;
}

}  // namespace

// x (Bsz,S,H,hp) via strides (b, s, h, p); adt/dt (Bsz,S,H) via (b, s, h);
// B/C (Bsz,S,N) via (b, s, n); fp32 throughout.  y contiguous
// (Bsz,S,H,hp).  Requires S % L == 0.
extern "C" int repro_ssd_scan_fwd(
    const void* x, const void* adt, const void* dt, const void* B,
    const void* C, void* y, int Bsz, int S, int H, int hp, int N, int L,
    int xsb, int xss, int xsh, int xsp, int asb, int ass, int ash, int dsb,
    int dss, int dsh, int bsb, int bss, int bsn, int csb, int css, int csn,
    void* stream) {
  if (L < 1 || S % L != 0 || hp < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(hp, N, L);
  cudaError_t err = set_smem(ssd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, Bsz);
  ssd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(adt),
      static_cast<const float*>(dt), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), S, H, hp, N, L,
      xsb, xss, xsh, xsp, asb, ass, ash, dsb, dss, dsh, bsb, bss, bsn, csb,
      css, csn);
  return (int)cudaGetLastError();
}
