// Mamba2 SSD chunked scan (n_groups = 1), forward.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_scan_chunked).  Per chunk of L tokens:
// cum = cumsum(A dt); the intra-chunk term y_i = sum_{j<=i} (C_i . B_j)
// exp(cum_i - cum_j) dt_j x_j; the inter-chunk term exp(cum_i) C_i . h;
// and the state update h <- h exp(cum_{L-1}) + sum_j exp(cum_{L-1} -
// cum_j) dt_j x_j B_j^T, with an fp32 (hp x N) state.
//
// Bound on this card.  At the serving shape (x (64,128,6,64), N 32,
// chunk 64) the scan does about 0.7 GFLOP of fp32 FMAs (the four chunk
// products, the two causal ones counted on their lower triangle) and
// moves about 4.5 MB: operations bound it, 10.6 us at 67 TFLOP/s.
//
// Design.  The TPU grid walks the chunk axis in order and carries h in
// VMEM scratch; here one thread block per (head, batch) owns the whole
// sequence and loops over the chunks, with h resident in shared memory
// (the chunk axis is not split across blocks: at the path's two chunks a
// split would at most double the smallest bucket's 48 blocks and add two
// launches; PERF.md gives the numbers).  Per chunk:
//   * load x, B, C (16-byte loads where rows allow) into shared memory,
//     B, C and h transposed (n-major) so that every product reads float4s;
//   * a warp scan gives cum; exp(cum), the output weights exp(cum_{L-1} -
//     cum_j) dt_j and the decay exp(cum_i - cum_j) (i >= j only: the upper
//     triangle can overflow) are evaluated once per chunk;
//   * the four products are register-tiled: each thread computes a 4 x 4
//     (2 x 4 for the state) tile of outputs from float4 operands, eight
//     FMAs per shared-memory load instead of half of one.  Tiles above the
//     diagonal are skipped and the causal y product stops at the diagonal.
// All arithmetic is IEEE fp32 FMAs.  Dimensions that are not multiples of
// 4 are zero-padded in shared memory.  At the serving shape a block takes
// 58 KB of shared memory, so three blocks share an SM.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

struct Args {
  int S, H, hp, N, L;
  int xsb, xss, xsh, xsp, asb, ass, ash, dsb, dss, dsh;
  int bsb, bss, bsn, csb, css, csn;
  int vx, vbc;  // 16-byte loads of x rows / of B and C rows
};

// L4_, P4_, N4_: the padded chunk, head and state dims when known at
// compile time (the serving shape), 0 to read them from the arguments.
template <int L4_, int P4_, int N4_>
__global__ void __launch_bounds__(THREADS, 2)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ adt,
           const float* __restrict__ dt, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y,
           const Args a) {
  extern __shared__ float4 smem4[];
  const int L = a.L, hp = a.hp, N = a.N;
  const int L4 = L4_ ? L4_ : pad4(L), P4 = P4_ ? P4_ : pad4(hp);
  const int N4 = N4_ ? N4_ : pad4(N);
  const int lq = L4 / 4, pq = P4 / 4;  // float4s per row of L4 / P4
  float* xs = reinterpret_cast<float*>(smem4);  // L4 x P4: x[j][p]
  float* ct = xs + L4 * P4;                     // N4 x L4: C[i][n]^T
  float* bt = ct + N4 * L4;                     // N4 x L4: B[j][n]^T
  float* st = bt + N4 * L4;                     // L4 x L4: S[i][j]^T
  float* ht = st + L4 * L4;                     // N4 x P4: h[p][n]^T
  float* cum = ht + N4 * P4;                    // L4
  float* ecum = cum + L4;                       // L4: exp(cum_i)
  float* wout = ecum + L4;                      // L4: exp(cum_L - cum_j) dt_j
  float* dts = wout + L4;                       // L4
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  const float4* ct4 = reinterpret_cast<const float4*>(ct);
  const float4* bt4 = reinterpret_cast<const float4*>(bt);
  const float4* st4 = reinterpret_cast<const float4*>(st);
  float4* ht4 = reinterpret_cast<float4*>(ht);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int total = L4 * P4 + 2 * N4 * L4 + L4 * L4 + N4 * P4 + 4 * L4;
  for (int i = tid; i < total; i += THREADS)  // pads stay zero throughout
    xs[i] = 0.f;
  const float* xb = x + (long long)b * a.xsb + (long long)h * a.xsh;

  for (int c0 = 0; c0 < a.S; c0 += L) {
    __syncthreads();  // previous chunk's readers done (and the zero fill)
    if (a.vx) {
      const int vr = hp / 4;
#pragma unroll 4
      for (int i = tid; i < L * vr; i += THREADS) {
        const int j = i / vr, c = i - j * vr;
        reinterpret_cast<float4*>(xs)[j * pq + c] =
            *reinterpret_cast<const float4*>(xb + (long long)(c0 + j) * a.xss +
                                             4 * c);
      }
    } else {
      for (int i = tid; i < L * hp; i += THREADS) {
        const int j = i / hp, p = i - j * hp;
        xs[j * P4 + p] =
            xb[(long long)(c0 + j) * a.xss + (long long)p * a.xsp];
      }
    }
    const float* brow = Bm + (long long)b * a.bsb + (long long)c0 * a.bss;
    const float* crow = Cm + (long long)b * a.csb + (long long)c0 * a.css;
    if (a.vbc) {
      const int vr = N / 4;
#pragma unroll 2
      for (int i = tid; i < L * vr; i += THREADS) {
        const int j = i / vr, n = 4 * (i - j * vr);
        const float4 bv =
            *reinterpret_cast<const float4*>(brow + (long long)j * a.bss + n);
        const float4 cv =
            *reinterpret_cast<const float4*>(crow + (long long)j * a.css + n);
        bt[n * L4 + j] = bv.x, bt[(n + 1) * L4 + j] = bv.y;
        bt[(n + 2) * L4 + j] = bv.z, bt[(n + 3) * L4 + j] = bv.w;
        ct[n * L4 + j] = cv.x, ct[(n + 1) * L4 + j] = cv.y;
        ct[(n + 2) * L4 + j] = cv.z, ct[(n + 3) * L4 + j] = cv.w;
      }
    } else {
      for (int i = tid; i < L * N; i += THREADS) {
        const int j = i / N, n = i - j * N;
        bt[n * L4 + j] = brow[(long long)j * a.bss + (long long)n * a.bsn];
        ct[n * L4 + j] = crow[(long long)j * a.css + (long long)n * a.csn];
      }
    }
    for (int j = tid; j < L; j += THREADS) {
      cum[j] = adt[(long long)b * a.asb + (long long)(c0 + j) * a.ass +
                   (long long)h * a.ash];
      dts[j] = dt[(long long)b * a.dsb + (long long)(c0 + j) * a.dss +
                  (long long)h * a.dsh];
    }
    __syncthreads();
    if (warp == 0) {  // inclusive cumsum of A dt: a warp scan
      const int per = (L4 + 31) / 32, j0 = lane * per;
      float run = 0.f;
      for (int e = 0; e < per; ++e)
        if (j0 + e < L) run += cum[j0 + e];
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      float r = incl - run;
      for (int e = 0; e < per; ++e) {
        const int j = j0 + e;
        if (j < L4) {
          if (j < L) r += cum[j];
          cum[j] = r;  // pad rows repeat cum_{L-1}
        }
      }
    }
    __syncthreads();
    const float cum_last = cum[L - 1];
    for (int j = tid; j < L4; j += THREADS) {
      ecum[j] = expf(cum[j]);
      wout[j] = expf(cum_last - cum[j]) * dts[j];
    }
    // (1) S[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for i >= j, stored
    // transposed; tiles (rt, jt) of 4 x 4 with jt <= rt
    for (int t = tid; t < lq * lq; t += THREADS) {
      const int rt = t / lq, jt = t - rt * lq;
      if (jt > rt) continue;
      float acc[4][4] = {};
#pragma unroll 8
      for (int n = 0; n < N4; ++n) {
        const float4 cv = ct4[n * lq + rt], bv = bt4[n * lq + jt];
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cr[r], br[c], acc[r][c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * jt + c;
        float col[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * rt + r;
          col[r] = i >= j ? acc[r][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
        reinterpret_cast<float4*>(st)[j * lq + rt] =
            make_float4(col[0], col[1], col[2], col[3]);
      }
    }
    __syncthreads();
    // (2) y = exp(cum_i) (C h^T)_i + sum_{j<=i} S[i][j] x_j; tiles (rt, pt)
    for (int t = tid; t < lq * pq; t += THREADS) {
      const int rt = t / pq, pt = t - rt * pq;
      float acc[4][4] = {};
#pragma unroll 8
      for (int n = 0; n < N4; ++n) {
        const float4 cv = ct4[n * lq + rt], hv = ht4[n * pq + pt];
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cr[r], hr[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = ecum[4 * rt + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }
      const int jend = 4 * rt + 4;  // causal: S[i][j] = 0 for j > i
#pragma unroll 4
      for (int j = 0; j < jend; ++j) {
        const float4 sv = st4[j * lq + rt], xv = xs4[j * pq + pt];
        const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(sr[r], xr[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * rt + r;
        if (i >= L) break;
        float* yr = y + (((long long)b * a.S + c0 + i) * a.H + h) * hp;
        if (P4 == hp) {
          reinterpret_cast<float4*>(yr)[pt] =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (4 * pt + c < hp) yr[4 * pt + c] = acc[r][c];
        }
      }
    }
    __syncthreads();  // the inter-chunk reads of h are done
    // (3) h[p][n] <- h exp(cum_{L-1}) + sum_j wout_j x_j[p] B_j[n];
    // tiles of 2 n x 4 p
    const float dec = expf(cum_last);
    for (int t = tid; t < (N4 / 2) * pq; t += THREADS) {
      const int nt = t / pq, pt = t - nt * pq, n0 = 2 * nt;
      float4 h0 = ht4[n0 * pq + pt], h1 = ht4[(n0 + 1) * pq + pt];
      float acc[2][4] = {{h0.x * dec, h0.y * dec, h0.z * dec, h0.w * dec},
                         {h1.x * dec, h1.y * dec, h1.z * dec, h1.w * dec}};
#pragma unroll 2
      for (int jq = 0; jq < lq; ++jq) {
        const float4 wv = reinterpret_cast<const float4*>(wout)[jq];
        const float4 b0 = bt4[n0 * lq + jq], b1 = bt4[(n0 + 1) * lq + jq];
        const float bw[2][4] = {
            {b0.x * wv.x, b0.y * wv.y, b0.z * wv.z, b0.w * wv.w},
            {b1.x * wv.x, b1.y * wv.y, b1.z * wv.z, b1.w * wv.w}};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 xv = xs4[(4 * jq + e) * pq + pt];
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(bw[r][e], xr[c], acc[r][c]);
        }
      }
      ht4[n0 * pq + pt] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      ht4[(n0 + 1) * pq + pt] =
          make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
    }
  }
}

}  // namespace

// Shared memory one block of the scan needs, in bytes (mirrored by
// smem_bytes in ssd_scan/kernel.py).
static size_t smem_bytes(int hp, int N, int L) {
  const int L4 = pad4(L), P4 = pad4(hp), N4 = pad4(N);
  return (size_t)(L4 * P4 + 2 * N4 * L4 + L4 * L4 + N4 * P4 + 4 * L4) * 4;
}

// x (Bsz,S,H,hp) via strides (b, s, h, p); adt/dt (Bsz,S,H) via (b, s, h);
// B/C (Bsz,S,N) via (b, s, n); fp32 throughout.  y contiguous
// (Bsz,S,H,hp).  Requires S % L == 0.  vx = 1 promises x rows that are
// contiguous, a multiple of 16 bytes long and 16-byte aligned; vbc = 1 the
// same of B and C.
extern "C" int repro_ssd_scan_fwd(
    const void* x, const void* adt, const void* dt, const void* B,
    const void* C, void* y, int Bsz, int S, int H, int hp, int N, int L,
    int xsb, int xss, int xsh, int xsp, int asb, int ass, int ash, int dsb,
    int dss, int dsh, int bsb, int bss, int bsn, int csb, int css, int csn,
    int vx, int vbc, void* stream) {
  if (L < 1 || S % L != 0 || hp < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(hp, N, L);
  // the serving shape (chunk 64, head dim 64, state 32) gets its own
  // instance with the loop bounds compiled in
  const bool serving = pad4(L) == 64 && pad4(hp) == 64 && pad4(N) == 32;
  auto kernel = serving ? ssd_kernel<64, 64, 32> : ssd_kernel<0, 0, 0>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const Args a = {S,   H,   hp,  N,   L,   xsb, xss, xsh, xsp, asb, ass,
                  ash, dsb, dss, dsh, bsb, bss, bsn, csb, css, csn, vx,
                  vbc};
  kernel<<<dim3(H, Bsz), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(adt),
      static_cast<const float*>(dt), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), a);
  return (int)cudaGetLastError();
}
