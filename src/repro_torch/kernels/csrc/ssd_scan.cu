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
//
// The zoo's chunk (ssd_subtile_kernel).  Mamba2-370m and Jamba scan chunks
// of L = 256 tokens at head dim 64 and state 128.  Holding such a chunk
// whole (x, B^T, C^T and the L x L scores) takes 626 KB, so this variant
// sub-tiles it: row tiles I and column tiles J <= I of TS = 64 tokens.
// cum, exp(cum), the output weights and dt live in shared memory for the
// whole chunk, so the math is the reference's chunk of 256 and only the
// summation order changes.  Per row tile I: C_I^T is staged, the
// inter-chunk term exp(cum_i) C_I h^T starts the accumulator, and for
// each J <= I the block stages B_J^T and x_J, forms S_IJ = (C_I B_J^T) *
// exp(cum_i - cum_j) dt_j (i >= j) and adds S_IJ x_J.  At J = I the block
// also adds (x_I * w_I)^T B_I to a state increment each thread keeps in
// registers (8 states x 4 head dims), so after the last row tile h <-
// h exp(cum_{L-1}) + increment needs no second pass over B and x.  One
// block takes 132 KB at the zoo's shape (h 32 KB, four chunk vectors 4
// KB, C_I^T and B_J^T 32 KB each, x_J and S_IJ 16 KB each).
//
// Both kernels start from an initial state h0 (Bsz, H, hp, N) when given
// one and write the state after the last chunk to hout (same layout)
// when asked: the zoo's prefill builds each MAMBA cache from it.  A null
// pointer skips either.
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
           const float* __restrict__ h0, float* __restrict__ hout,
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
  const long long hoff = ((long long)b * a.H + h) * hp * N;
  if (h0) {
    __syncthreads();  // the zero fill is done
    for (int i = tid; i < hp * N; i += THREADS) {
      const int p = i / N, n = i - p * N;
      ht[n * P4 + p] = h0[hoff + i];
    }
  }

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
  if (hout) {
    __syncthreads();  // the last state update is done
    for (int i = tid; i < hp * N; i += THREADS) {
      const int p = i / N, n = i - p * N;
      hout[hoff + i] = ht[n * P4 + p];
    }
  }
}

// ---------------------------------------------------------------------------
// The sub-tiled chunk (the zoo's L = 256, N = 128).  Thread t owns the y
// tile (4 rows rt = t / 16, 4 head dims pt = t % 16) of every row tile and
// the state increment (8 states nt = t / pq, 4 head dims t % pq).
// ---------------------------------------------------------------------------
constexpr int TS = 64;       // tokens of a sub-tile
constexpr int TQ = TS / 4;   // float4s along a sub-tile

__host__ __device__ __forceinline__ int pad8(int n) { return (n + 7) & ~7; }

__host__ __device__ __forceinline__ int subtile_tokens(int L) {
  return (L + TS - 1) / TS * TS;
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_subtile_kernel(const float* __restrict__ x, const float* __restrict__ adt,
                   const float* __restrict__ dt, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, float* __restrict__ y,
                   const float* __restrict__ h0, float* __restrict__ hout,
                   const Args a) {
  extern __shared__ float4 smem4[];
  const int L = a.L, hp = a.hp, N = a.N;
  const int P4 = pad4(hp), N8 = pad8(N), LT = subtile_tokens(L);
  const int pq = P4 / 4, nT = LT / TS;
  float* ht = reinterpret_cast<float*>(smem4);  // N8 x P4: h[p][n]^T
  float* cum = ht + N8 * P4;                    // LT
  float* ecum = cum + LT;                       // LT: exp(cum_i)
  float* wout = ecum + LT;                      // LT: exp(cum_L - cum_j) dt_j
  float* dts = wout + LT;                       // LT
  float* ct = dts + LT;                         // N8 x TS: C_I^T
  float* bt = ct + N8 * TS;                     // N8 x TS: B_J^T
  float* xs = bt + N8 * TS;                     // TS x P4: x_J
  float* st = xs + TS * P4;                     // TS x TS: S_IJ^T
  const float4* ct4 = reinterpret_cast<const float4*>(ct);
  const float4* bt4 = reinterpret_cast<const float4*>(bt);
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  const float4* st4 = reinterpret_cast<const float4*>(st);
  const float4* wout4 = reinterpret_cast<const float4*>(wout);
  float4* ht4 = reinterpret_cast<float4*>(ht);

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rt = tid / TQ, pt = tid % TQ;        // y tile
  const bool yown = pt < pq;
  const int hn = tid / pq, hpq = tid % pq;       // state-increment tile
  const bool hown = hn < N8 / 8;
  const int total = N8 * P4 + 4 * LT + 2 * N8 * TS + TS * P4 + TS * TS;
  for (int i = tid; i < total; i += THREADS)  // pads stay zero throughout
    ht[i] = 0.f;
  const float* xb = x + (long long)b * a.xsb + (long long)h * a.xsh;
  const long long hoff = ((long long)b * a.H + h) * hp * N;
  if (h0) {
    __syncthreads();  // the zero fill is done
    for (int i = tid; i < hp * N; i += THREADS) {
      const int p = i / N, n = i - p * N;
      ht[n * P4 + p] = h0[hoff + i];
    }
  }

  // stage rows t0 .. t0 + TS - 1 of B or C (zeros past L) transposed into
  // dst (N8 x TS); consecutive threads take consecutive tokens, so the
  // transposed stores do not conflict
  auto stage_bc = [&](float* dst, const float* src, int ss, int sn, int c0,
                      int t0) {
    if (a.vbc) {
      const int vr = N / 4;
      for (int i = tid; i < TS * vr; i += THREADS) {
        const int j = i % TS, n = 4 * (i / TS), t = t0 + j;
        const float4 v =
            t < L ? *reinterpret_cast<const float4*>(
                        src + (long long)(c0 + t) * ss + n)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
        dst[n * TS + j] = v.x, dst[(n + 1) * TS + j] = v.y;
        dst[(n + 2) * TS + j] = v.z, dst[(n + 3) * TS + j] = v.w;
      }
    } else {
      for (int i = tid; i < TS * N; i += THREADS) {
        const int j = i % TS, n = i / TS, t = t0 + j;
        dst[n * TS + j] =
            t < L ? src[(long long)(c0 + t) * ss + (long long)n * sn] : 0.f;
      }
    }
  };

  for (int c0 = 0; c0 < a.S; c0 += L) {
    __syncthreads();  // previous chunk's readers done (and the zero fill)
    for (int j = tid; j < LT; j += THREADS) {
      const bool in = j < L;
      cum[j] = in ? adt[(long long)b * a.asb + (long long)(c0 + j) * a.ass +
                        (long long)h * a.ash]
                  : 0.f;
      dts[j] = in ? dt[(long long)b * a.dsb + (long long)(c0 + j) * a.dss +
                       (long long)h * a.dsh]
                  : 0.f;
    }
    __syncthreads();
    if (warp == 0) {  // inclusive cumsum of A dt (pads add 0): a warp scan
      const int per = LT / 32, j0 = lane * per;
      float run = 0.f;
      for (int e = 0; e < per; ++e) run += cum[j0 + e];
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      float r = incl - run;
      for (int e = 0; e < per; ++e) {
        r += cum[j0 + e];
        cum[j0 + e] = r;  // pad rows repeat cum_{L-1}
      }
    }
    __syncthreads();
    const float cum_last = cum[L - 1];
    for (int j = tid; j < LT; j += THREADS) {
      ecum[j] = expf(cum[j]);
      wout[j] = expf(cum_last - cum[j]) * dts[j];
    }
    const float* brow = Bm + (long long)b * a.bsb;
    const float* crow = Cm + (long long)b * a.csb;
    float dh[8][4] = {};
    for (int I = 0; I < nT; ++I) {
      __syncthreads();  // the previous tile's readers of ct / bt / xs done
      stage_bc(ct, crow, a.css, a.csn, c0, I * TS);
      __syncthreads();
      // inter-chunk: exp(cum_i) sum_n C_i[n] h[p][n]
      float acc[4][4] = {};
      if (yown) {
#pragma unroll 8
        for (int n = 0; n < N8; ++n) {
          const float4 cv = ct4[n * TQ + rt], hv = ht4[n * pq + pt];
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(cr[r], hr[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float e = ecum[I * TS + 4 * rt + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] *= e;
        }
      }
      for (int J = 0; J <= I; ++J) {
        if (J > 0) __syncthreads();  // the previous J's readers done
        stage_bc(bt, brow, a.bss, a.bsn, c0, J * TS);
        if (a.vx) {
          const int vr = hp / 4;
          for (int i = tid; i < TS * vr; i += THREADS) {
            const int j = i / vr, c = i - j * vr, t = J * TS + j;
            reinterpret_cast<float4*>(xs)[j * pq + c] =
                t < L ? *reinterpret_cast<const float4*>(
                            xb + (long long)(c0 + t) * a.xss + 4 * c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        } else {
          for (int i = tid; i < TS * hp; i += THREADS) {
            const int j = i / hp, p = i - j * hp, t = J * TS + j;
            xs[j * P4 + p] =
                t < L ? xb[(long long)(c0 + t) * a.xss + (long long)p * a.xsp]
                      : 0.f;
          }
        }
        __syncthreads();
        // S_IJ[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for i >= j,
        // stored transposed; tiles (rt, jt) with jt <= rt on the diagonal
        {
          const int jt = pt;
          if (!(J == I && jt > rt)) {
            float s4[4][4] = {};
#pragma unroll 8
            for (int n = 0; n < N8; ++n) {
              const float4 cv = ct4[n * TQ + rt], bv = bt4[n * TQ + jt];
              const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
              const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
              for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  s4[r][c] = fmaf(cr[r], br[c], s4[r][c]);
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int j = J * TS + 4 * jt + c;
              float col[4];
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const int i = I * TS + 4 * rt + r;
                col[r] = i >= j ? s4[r][c] * expf(cum[i] - cum[j]) * dts[j]
                                : 0.f;
              }
              reinterpret_cast<float4*>(st)[(4 * jt + c) * TQ + rt] =
                  make_float4(col[0], col[1], col[2], col[3]);
            }
          }
        }
        __syncthreads();
        // y_I += S_IJ x_J (causal on the diagonal tile)
        if (yown) {
          const int jend = J == I ? 4 * rt + 4 : TS;
#pragma unroll 4
          for (int j = 0; j < jend; ++j) {
            const float4 sv = st4[j * TQ + rt], xv = xs4[j * pq + pt];
            const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
            const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[r][c] = fmaf(sr[r], xr[c], acc[r][c]);
          }
        }
        // the state increment of tile J = I: sum_j w_j B_j[n] x_j[p]
        if (J == I && hown) {
#pragma unroll 2
          for (int jq = 0; jq < TQ; ++jq) {
            const float4 wv = wout4[I * TQ + jq];
            float bw[8][4];
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const float4 bv = bt4[(8 * hn + r) * TQ + jq];
              bw[r][0] = bv.x * wv.x, bw[r][1] = bv.y * wv.y;
              bw[r][2] = bv.z * wv.z, bw[r][3] = bv.w * wv.w;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 xv = xs4[(4 * jq + e) * pq + hpq];
              const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
              for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  dh[r][c] = fmaf(bw[r][e], xr[c], dh[r][c]);
            }
          }
        }
      }
      if (yown) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = I * TS + 4 * rt + r;
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
    }
    __syncthreads();  // every row tile's read of h is done
    // h <- h exp(cum_{L-1}) + the increment
    if (hown) {
      const float dec = expf(cum_last);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float4& hv = ht4[(8 * hn + r) * pq + hpq];
        hv = make_float4(fmaf(hv.x, dec, dh[r][0]), fmaf(hv.y, dec, dh[r][1]),
                         fmaf(hv.z, dec, dh[r][2]), fmaf(hv.w, dec, dh[r][3]));
      }
    }
  }
  if (hout) {
    __syncthreads();  // the last state update is done
    for (int i = tid; i < hp * N; i += THREADS) {
      const int p = i / N, n = i - p * N;
      hout[hoff + i] = ht[n * P4 + p];
    }
  }
}

}  // namespace

// Shared memory one block needs, in bytes (mirrored by smem_bytes in
// ssd_scan/kernel.py): variant 0 holds the chunk whole, variant 1 sub-tiles
// it.
static size_t smem_bytes(int variant, int hp, int N, int L) {
  const int P4 = pad4(hp);
  if (variant == 1) {
    const int N8 = pad8(N), LT = subtile_tokens(L);
    return (size_t)(N8 * P4 + 4 * LT + 2 * N8 * TS + TS * P4 + TS * TS) * 4;
  }
  const int L4 = pad4(L), N4 = pad4(N);
  return (size_t)(L4 * P4 + 2 * N4 * L4 + L4 * L4 + N4 * P4 + 4 * L4) * 4;
}

// x (Bsz,S,H,hp) via strides (b, s, h, p); adt/dt (Bsz,S,H) via (b, s, h);
// B/C (Bsz,S,N) via (b, s, n); fp32 throughout.  y contiguous
// (Bsz,S,H,hp); h0 (initial state) and hout (final state) contiguous
// (Bsz,H,hp,N), either null.  Requires S % L == 0.  vx = 1 promises x rows
// that are contiguous, a multiple of 16 bytes long and 16-byte aligned;
// vbc = 1 the same of B and C.  variant 0: the whole chunk in shared
// memory; 1: sub-tiles of 64 tokens (hp <= 64, ceil(N / 8) * ceil(hp / 4)
// <= 256).
extern "C" int repro_ssd_scan_fwd(
    const void* x, const void* adt, const void* dt, const void* B,
    const void* C, void* y, const void* h0, void* hout, int Bsz, int S, int H,
    int hp, int N, int L, int xsb, int xss, int xsh, int xsp, int asb,
    int ass, int ash, int dsb, int dss, int dsh, int bsb, int bss, int bsn,
    int csb, int css, int csn, int vx, int vbc, int variant, void* stream) {
  if (L < 1 || S % L != 0 || hp < 1 || N < 1 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  if (variant == 1 && (pad4(hp) > TS || (pad8(N) / 8) * (pad4(hp) / 4) >
                                            THREADS))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(variant, hp, N, L);
  const Args a = {S,   H,   hp,  N,   L,   xsb, xss, xsh, xsp, asb, ass,
                  ash, dsb, dss, dsh, bsb, bss, bsn, csb, css, csn, vx,
                  vbc};
  const dim3 grid(H, Bsz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(adt);
  const float* df = static_cast<const float*>(dt);
  const float* bf = static_cast<const float*>(B);
  const float* cf = static_cast<const float*>(C);
  float* yf = static_cast<float*>(y);
  const float* h0f = static_cast<const float*>(h0);
  float* hof = static_cast<float*>(hout);
  cudaError_t err;
  if (variant == 1) {
    err = set_smem(ssd_subtile_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    ssd_subtile_kernel<<<grid, THREADS, smem, s>>>(xf, af, df, bf, cf, yf,
                                                  h0f, hof, a);
    return (int)cudaGetLastError();
  }
  // the serving shape (chunk 64, head dim 64, state 32) gets its own
  // instance with the loop bounds compiled in
  const bool serving = pad4(L) == 64 && pad4(hp) == 64 && pad4(N) == 32;
  auto kernel = serving ? ssd_kernel<64, 64, 32> : ssd_kernel<0, 0, 0>;
  err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, s>>>(xf, af, df, bf, cf, yf, h0f, hof, a);
  return (int)cudaGetLastError();
}
