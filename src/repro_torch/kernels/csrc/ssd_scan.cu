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
// The zoo's chunk ("parallel", variant 1).  Mamba2-370m and Jamba scan
// chunks of L = 256 tokens at head dim 64 and state 128, 64 (mamba2) or
// 512 (Jamba) (batch, head) pairs over 8 chunks.  Holding such a chunk
// whole takes 626 KB, and one block per (batch, head) walking its chunks
// in order fills 64 of 132 SMs.  So the op runs as four chunk-parallel
// passes (the structure of Mamba2's own GPU implementation,
// state-spaces/mamba ssd_combined: _bmm_chunk, _chunk_state,
// _state_passing, _chunk_scan), each a kernel of its own:
//   1. ssd_cb_kernel, per (batch, chunk, 64 x 64 tile pair J <= I):
//      CB = C B^T on and below the diagonal tiles, into scratch (Bsz, nc,
//      LT, LT) (LT: L padded to 64).  B and C are shared by the heads, so
//      this product is made once per (batch, chunk), not per head.
//   2. ssd_chunk_state_kernel, per (head, chunk, batch): cum = cumsum(A dt)
//      over the chunk (a warp scan in fp64), into fp64 scratch (Bsz, nc,
//      H, LT), and the chunk's own state increment
//      s = sum_j exp(cum_{L-1} - cum_j) dt_j x_j^T B_j (hp x N), into
//      scratch (Bsz, nc, H, hp, N).
//   3. ssd_state_pass_kernel, per (batch, head) and 256 state elements,
//      sequential only over the chunks: h_c = h_{c-1} exp(cum_{L-1}) + s_c
//      from h0 (or zeros); the state entering each chunk overwrites s_c,
//      and the last one goes to hout.
//   4. ssd_chunk_scan_kernel, per (64-row tile I, head, chunk x batch),
//      longest row tiles first: y_i = exp(cum_i) C_i . h_{c-1} + sum_{j<=i}
//      CB_ij exp(cum_i - cum_j) dt_j x_j.  exp is evaluated once per score
//      element, where i >= j only, on each C B^T tile in place.
// The cumsum stays in fp64 so that cum_i - cum_j is exact to fp32 rounding
// where |cum| is large (~500 in mamba2-370m's first layer, ~8e3 on O(1)
// inputs with A = -(1 .. 256)): an fp32 cumsum there moves exp(cum_i -
// cum_j) by up to ulp(|cum|), ~3e-5 relative at 500, which the decode
// step's per-token exp(A dt) does not share.
// The four large products (C B^T, the chunk state, C h^T and the scores
// times x) run on the tensor cores as 3xTF32: mma.sync m16n8k8 .tf32 with
// each fp32 operand split into a TF32 high and low part and three
// products (lo hi, hi lo, hi hi) accumulated in fp32, which keeps close to
// fp32 accuracy (plain TF32 would keep three decimal digits).  Operand
// tiles are staged by cp.async (16 bytes where rows allow, else 4), in
// passes 2 and 4 through a two-stage ring, the next tile loading while the
// current one computes; every element a fragment reads is staged (zeros
// past the chunk, the head dim or the state), and the shared-memory row
// strides (4 mod 8 or 8 mod 32 floats, as the fragment's access pattern
// needs) make every fragment load conflict-free.  Bound on this card: operations (the
// fp32 count of chip_smoke.py ssd_bound, C B^T once per (batch, chunk)):
// 6.6 GFLOP, 0.098 ms at mamba2's layer; 51.7 GFLOP, 0.77 ms at Jamba's.
// Shared memory: 66 KB (pass 1), 107 KB (pass 2: two blocks an SM), 73 KB
// (pass 4: three blocks an SM) at the zoo's shape.
//
// Both variants start from an initial state h0 (Bsz, H, hp, N) when given
// one and write the state after the last chunk to hout (same layout)
// when asked: the zoo's prefill builds each MAMBA cache from it.  A null
// pointer skips either.
#include <cstdint>

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
// The four passes of the zoo's chunk.  Fragments of mma.sync m16n8k8 .tf32
// (g = lane / 4, t = lane % 4): A (16 x 8, row-major) a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8) b0 (k = t, n =
// g), b1 (k = t + 4, n = g); C (16 x 8) c0 / c1 (g, 2t / 2t + 1), c2 / c3
// (g + 8, 2t / 2t + 1).
// ---------------------------------------------------------------------------
constexpr int PT = 64;           // tokens of a row or column tile
constexpr int MAX_PHP = 64;      // head dims the passes take
constexpr int MAX_PN = 128;      // states the passes take
constexpr int P1_THREADS = 128;  // pass 1: 4 warps of 16 rows x 64 columns
constexpr int P2_THREADS = 256;  // pass 2: 8 warps of 16 head dims x 64 states
constexpr int P3_THREADS = 256;  // pass 3: one state element a thread
constexpr int P3_CHUNKS = 8;     // pass 3: chunks whose loads go together
constexpr int P4_THREADS = 256;  // pass 4: 8 warps of 16 rows x 32 columns

__host__ __device__ __forceinline__ int pad_to(int n, int m) {
  return (n + m - 1) / m * m;
}

// row strides (floats) of the staged tiles: 4 mod 8 where a fragment reads
// (row g, column t), 8 mod 32 where it reads (row t, column g)
__host__ __device__ __forceinline__ int stride_g_t(int cols) {
  return pad_to(cols, 8) + 4;
}
__host__ __device__ __forceinline__ int stride_t_g(int cols) {
  return pad_to(cols, 32) + 8;
}

// v = hi + lo, both TF32 (hi: v rounded to TF32; lo: the rest, rounded)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (a0..a3 as laid out above) split into high and low parts
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};

// d[i] += A B_i in 3xTF32 for the first n of NTW n-tiles (b0[i], b1[i]
// tile i's B fragment): the small products first, and each kind issued
// back to back over the tiles, whose accumulators are independent, so
// that no product waits on the one before it.
template <int NTW>
__device__ __forceinline__ void mma_3xtf32(float (&d)[NTW][4],
                                           const FragA& a,
                                           const float (&b0)[NTW],
                                           const float (&b1)[NTW], int n) {
  uint32_t bh0[NTW], bl0[NTW], bh1[NTW], bl1[NTW];
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    split_tf32(b0[i], bh0[i], bl0[i]);
    split_tf32(b1[i], bh1[i], bl1[i]);
  }
#pragma unroll
  for (int i = 0; i < NTW; ++i)
    if (i < n) mma_tf32(d[i], a.lo, bh0[i], bh1[i]);
#pragma unroll
  for (int i = 0; i < NTW; ++i)
    if (i < n) mma_tf32(d[i], a.hi, bl0[i], bl1[i]);
#pragma unroll
  for (int i = 0; i < NTW; ++i)
    if (i < n) mma_tf32(d[i], a.hi, bh0[i], bh1[i]);
}

// Stage rows [0, R) x columns [0, CW) of a tile into shared memory (row
// stride ss): element (r, c) = src[r rs + c cs] where r < rv and c < cv,
// else zero.  vec: 16-byte copies (cs == 1; rs, cv, CW multiples of 4; src
// 16-byte aligned), else 4-byte ones.  Asynchronous: the caller commits
// and waits.
template <int NT>
__device__ __forceinline__ void stage_tile(float* dst, int ss,
                                           const float* src, long long rs,
                                           int cs, int R, int CW, int rv,
                                           int cv, bool vec, int tid) {
  if (vec) {
    const int q = CW / 4;
    for (int i = tid; i < R * q; i += NT) {
      const int r = i / q, c = 4 * (i - r * q);
      const bool ok = r < rv && c < cv;
      cp_async16(dst + r * ss + c, ok ? src + r * rs + c : src, ok);
    }
  } else {
    for (int i = tid; i < R * CW; i += NT) {
      const int r = i / CW, c = i - r * CW;
      const bool ok = r < rv && c < cv;
      cp_async4(dst + r * ss + c, ok ? src + r * rs + (long long)c * cs : src,
                ok);
    }
  }
}

// Pass 1: CB[i][j] = C_i . B_j for the tile pair (I, J <= I) of one (batch,
// chunk); rows and columns past L come out zero.
__global__ void __launch_bounds__(P1_THREADS)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, const Args a) {
  extern __shared__ float4 smem4[];
  const int N = a.N, L = a.L, NP = pad_to(N, 8), ss = stride_g_t(N);
  const int LT = pad_to(L, PT), nc = a.S / L;
  float* cs = reinterpret_cast<float*>(smem4);  // 64 x ss: C_I[i][n]
  float* bs = cs + PT * ss;                     // 64 x ss: B_J[j][n]
  int I = 0, J = blockIdx.x;  // pairs (0,0), (1,0), (1,1), (2,0), ...
  while (J > I) J -= ++I;
  const int c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const long long t0 = (long long)c * L;
  stage_tile<P1_THREADS>(cs, ss,
                         Cm + (long long)b * a.csb + (t0 + I * PT) * a.css,
                         a.css, a.csn, PT, NP, L - I * PT, N, a.vbc, tid);
  stage_tile<P1_THREADS>(bs, ss,
                         Bm + (long long)b * a.bsb + (t0 + J * PT) * a.bss,
                         a.bss, a.bsn, PT, NP, L - J * PT, N, a.vbc, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  float acc[8][4] = {};
  const float* ar = cs + (16 * warp + g) * ss + t;
  for (int k = 0; k < NP; k += 8) {
    FragA fa;
    fa.set(ar[k], ar[8 * ss + k], ar[k + 4], ar[8 * ss + k + 4]);
    float b0[8], b1[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float* br = bs + (8 * nt + g) * ss + k + t;
      b0[nt] = br[0], b1[nt] = br[4];
    }
    mma_3xtf32(acc, fa, b0, b1, 8);
  }
  float* out = cb + (((long long)b * nc + c) * LT + I * PT + 16 * warp + g) *
                        LT + J * PT + 2 * t;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<float2*>(out + 8 * nt) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + 8 * LT + 8 * nt) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// cum[j] = adt_0 + .. + adt_j over the chunk, summed and kept in fp64 by
// one warp (rows past L repeat cum[L-1]), and dts[j] = dt_j (0 past L),
// for j < n (a multiple of 64, at most LT).  Ends with __syncthreads.
template <int NT>
__device__ void chunk_cumsum(double* cum, float* dts, const float* adt,
                             long long aoff, int ass, const float* dt,
                             long long doff, int dss, int L, int n, int tid) {
  for (int j = tid; j < n; j += NT) {
    cum[j] = j < L ? adt[aoff + (long long)j * ass] : 0.0;
    dts[j] = j < L ? dt[doff + (long long)j * dss] : 0.f;
  }
  __syncthreads();
  if (tid < 32) {
    const int per = n / 32, j0 = tid * per;
    double run = 0.0;
    for (int e = 0; e < per; ++e) run += cum[j0 + e];
    double incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += v;
    }
    double r = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) r = 0.0;
    for (int e = 0; e < per; ++e) {
      r += cum[j0 + e];
      cum[j0 + e] = r;
    }
  }
  __syncthreads();
}

// Pass 2: the chunk's cumsum (to cum_out) and its own state increment
// s[p][n] = sum_j x_j[p] w_j B_j[n], w_j = exp(cum_{L-1} - cum_j) dt_j,
// as (hp x L)(L x N): warp w computes head dims 16 (w % 4) .. + 15 and
// states 64 (w / 4) .. + 63; the 64-token tiles of x and B stream through
// a two-stage ring.
__global__ void __launch_bounds__(P2_THREADS)
ssd_chunk_state_kernel(const float* __restrict__ x,
                       const float* __restrict__ adt,
                       const float* __restrict__ dt,
                       const float* __restrict__ Bm, float* __restrict__ st,
                       double* __restrict__ cum_out, const Args a) {
  extern __shared__ float4 smem4[];
  const int hp = a.hp, N = a.N, L = a.L, LT = pad_to(L, PT);
  const int nc = a.S / L, nT = LT / PT;
  const int MP = pad_to(hp, 16), NP = pad_to(N, 8);
  const int xs_s = stride_t_g(hp), bs_s = stride_t_g(N);
  const int stage_sz = PT * (xs_s + bs_s);
  double* cum = reinterpret_cast<double*>(smem4);     // LT
  float* w = reinterpret_cast<float*>(cum + LT);      // LT: dt, then weights
  float* ring = w + LT;                               // 2 x (x_J, B_J)
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const long long t0 = (long long)c * L;
  auto load = [&](int J) {
    float* xs = ring + (J & 1) * stage_sz;
    float* bs = xs + PT * xs_s;
    const long long tj = t0 + (long long)J * PT;
    stage_tile<P2_THREADS>(xs, xs_s,
                           x + (long long)b * a.xsb + (long long)h * a.xsh +
                               tj * a.xss,
                           a.xss, a.xsp, PT, MP, L - J * PT, hp, a.vx, tid);
    stage_tile<P2_THREADS>(bs, bs_s, Bm + (long long)b * a.bsb + tj * a.bss,
                           a.bss, a.bsn, PT, NP, L - J * PT, N, a.vbc, tid);
    cp_async_commit();
  };
  load(0);  // overlaps the scan
  chunk_cumsum<P2_THREADS>(
      cum, w, adt, (long long)b * a.asb + t0 * a.ass + (long long)h * a.ash,
      a.ass, dt, (long long)b * a.dsb + t0 * a.dss + (long long)h * a.dsh,
      a.dss, L, LT, tid);
  const double cl = cum[LT - 1];
  double* co = cum_out + (((long long)b * nc + c) * a.H + h) * LT;
  for (int j = tid; j < LT; j += P2_THREADS) {
    w[j] = expf((float)(cl - cum[j])) * w[j];
    co[j] = cum[j];
  }
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int mt = warp & 3, n0 = 8 * (warp >> 2);  // first n-tile
  const int ntw = min(8, NP / 8 - n0);             // this warp's n-tiles
  const bool active = 16 * mt < MP && ntw > 0;
  float acc[2][4][4] = {};  // two halves of 4 n-tiles (fewer live splits)
  for (int J = 0; J < nT; ++J) {
    if (J + 1 < nT) {
      load(J + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile J (and the weights) visible to every warp
    if (active) {
      const float* xs = ring + (J & 1) * stage_sz;
      const float* bs = xs + PT * xs_s;
      const float* wj = w + J * PT;
#pragma unroll 4
      for (int k = 0; k < PT; k += 8) {
        // A[p][j] = x_j[p] w_j: rows p = 16 mt + g (+8), columns j = k + t
        // (+4)
        const float w0 = wj[k + t], w1 = wj[k + t + 4];
        const float* xa = xs + (k + t) * xs_s + 16 * mt + g;
        FragA fa;
        fa.set(xa[0] * w0, xa[8] * w0, xa[4 * xs_s] * w1,
               xa[4 * xs_s + 8] * w1);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float b0[4], b1[4];
          const float* br = bs + (k + t) * bs_s + 8 * (n0 + 4 * q) + g;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            b0[i] = 4 * q + i < ntw ? br[8 * i] : 0.f;
            b1[i] = 4 * q + i < ntw ? br[4 * bs_s + 8 * i] : 0.f;
          }
          mma_3xtf32(acc[q], fa, b0, b1, ntw - 4 * q);
        }
      }
    }
    __syncthreads();  // stage J & 1 free for tile J + 2
  }
  if (!active) return;
  float* so = st + (((long long)b * nc + c) * a.H + h) * hp * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = 8 * (n0 + i) + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 16 * mt + g + 8 * r;
      if (p >= hp) continue;
      if (n < N) so[(long long)p * N + n] = acc[i / 4][i % 4][2 * r];
      if (n + 1 < N)
        so[(long long)p * N + n + 1] = acc[i / 4][i % 4][2 * r + 1];
    }
  }
}

// Pass 3: per (batch, head) and state element, sequential over the chunks:
// st[c] (the chunk's increment) becomes the state entering chunk c.
__global__ void __launch_bounds__(P3_THREADS)
ssd_state_pass_kernel(float* __restrict__ st, const double* __restrict__ cum,
                      const float* __restrict__ h0, float* __restrict__ hout,
                      const Args a) {
  const int hpN = a.hp * a.N, L = a.L, LT = pad_to(L, PT), nc = a.S / L;
  const int e = blockIdx.x * P3_THREADS + threadIdx.x, h = blockIdx.y;
  const int b = blockIdx.z;
  if (e >= hpN) return;
  const long long bh = (long long)b * a.H + h;
  float s = h0 ? h0[bh * hpN + e] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += P3_CHUNKS) {
    // the loads of P3_CHUNKS chunks first, then the dependent updates
    float inc[P3_CHUNKS], dec[P3_CHUNKS];
#pragma unroll
    for (int k = 0; k < P3_CHUNKS; ++k) {
      const long long bch = ((long long)b * nc + c0 + k) * a.H + h;
      if (c0 + k < nc) {
        inc[k] = st[bch * hpN + e];
        dec[k] = expf((float)cum[bch * LT + L - 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < P3_CHUNKS; ++k) {
      if (c0 + k < nc) {
        st[(((long long)b * nc + c0 + k) * a.H + h) * hpN + e] = s;
        s = s * dec[k] + inc[k];
      }
    }
  }
  if (hout) hout[bh * hpN + e] = s;
}

// Pass 4: y for the 64-row tile I of one (batch, chunk, head).  Warp w owns
// rows 16 (w % 4) .. + 15 and head dims 32 (w / 4) .. + 31.  First the
// inter-chunk term exp(cum_i) C_i . h^T (skipped when the entering state is
// zero: chunk 0 without h0), then the tiles J <= I of scores x x_J through
// a two-stage ring that reuses the inter-chunk operands' shared memory.
// Each C B^T tile is turned into its scores in place once it lands (one
// exp per element, by one thread), and on the diagonal tile a warp stops
// at its last row.
__global__ void __launch_bounds__(P4_THREADS, 3)
ssd_chunk_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ Cm,
                      const float* __restrict__ cb,
                      const double* __restrict__ cum_in,
                      const float* __restrict__ st, float* __restrict__ y,
                      const Args a, int has_h0) {
  extern __shared__ float4 smem4[];
  const int hp = a.hp, N = a.N, L = a.L, LT = pad_to(L, PT);
  const int nc = a.S / L, nT = LT / PT;
  const int HP8 = pad_to(hp, 8), NP = pad_to(N, 8);
  const int cs_s = stride_g_t(N), xs_s = stride_t_g(hp);
  const int cb_s = stride_g_t(PT);
  const int stage_sz = PT * (cb_s + xs_s);
  const int I = nT - 1 - blockIdx.x, h = blockIdx.y;
  const int c = blockIdx.z % nc, b = blockIdx.z / nc, tid = threadIdx.x;
  double* cum = reinterpret_cast<double*>(smem4);  // (I + 1) 64 of LT
  float* dts = reinterpret_cast<float*>(cum + LT);
  float* un = dts + LT;  // C_I and h, then the ring
  const long long bc = (long long)b * nc + c, t0 = (long long)c * L;
  const long long bch = bc * a.H + h;
  const bool has_state = c > 0 || has_h0;
  float* ci = un;                // 64 x cs_s: C_I[i][n]
  float* hs = un + PT * cs_s;    // HP8 x cs_s: h[p][n]
  if (has_state) {
    stage_tile<P4_THREADS>(ci, cs_s,
                           Cm + (long long)b * a.csb + (t0 + I * PT) * a.css,
                           a.css, a.csn, PT, NP, L - I * PT, N, a.vbc, tid);
    stage_tile<P4_THREADS>(hs, cs_s, st + bch * hp * N, N, 1, HP8, NP, hp, N,
                           N % 4 == 0, tid);
    cp_async_commit();
  }
  const int JT = (I + 1) * PT;
  for (int j = tid; j < JT; j += P4_THREADS) {
    cum[j] = cum_in[bch * LT + j];
    dts[j] = j < L ? dt[(long long)b * a.dsb + (t0 + j) * a.dss +
                        (long long)h * a.dsh]
                   : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, n0 = 4 * (warp >> 2);   // row group, n-tile
  const int ntw = min(4, HP8 / 8 - n0);             // this warp's n-tiles
  const int r0 = 16 * wr + g;                       // rows r0, r0 + 8
  float acc[4][4] = {};
  if (has_state) {
    if (ntw > 0) {
      const float* ar = ci + r0 * cs_s + t;
#pragma unroll 4
      for (int k = 0; k < NP; k += 8) {
        FragA fa;
        fa.set(ar[k], ar[8 * cs_s + k], ar[k + 4], ar[8 * cs_s + k + 4]);
        float b0[4], b1[4];
        const float* br = hs + (8 * n0 + g) * cs_s + k + t;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          b0[i] = i < ntw ? br[8 * i * cs_s] : 0.f;
          b1[i] = i < ntw ? br[8 * i * cs_s + 4] : 0.f;
        }
        mma_3xtf32(acc, fa, b0, b1, ntw);
      }
    }
    const float e0 = expf((float)cum[I * PT + r0]);
    const float e1 = expf((float)cum[I * PT + r0 + 8]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[nt][0] *= e0, acc[nt][1] *= e0;
      acc[nt][2] *= e1, acc[nt][3] *= e1;
    }
    __syncthreads();  // C_I and h read: their memory becomes the ring
  }
  auto load = [&](int J) {
    float* cbt = un + (J & 1) * stage_sz;
    float* xs = cbt + PT * cb_s;
    stage_tile<P4_THREADS>(cbt, cb_s, cb + (bc * LT + I * PT) * LT + J * PT,
                           LT, 1, PT, PT, PT, PT, true, tid);
    stage_tile<P4_THREADS>(xs, xs_s,
                           x + (long long)b * a.xsb + (long long)h * a.xsh +
                               (t0 + (long long)J * PT) * a.xss,
                           a.xss, a.xsp, PT, HP8, L - J * PT, hp, a.vx, tid);
    cp_async_commit();
  };
  load(0);
  for (int J = 0; J <= I; ++J) {
    if (J < I) {
      load(J + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile J visible to every warp
    float* cbt = un + (J & 1) * stage_sz;
    const float* xs = cbt + PT * cb_s;
    // the scores S_ij = CB_ij exp(cum_i - cum_j) dt_j (i >= j, else 0), in
    // place: each element's exp once, by one thread
    for (int e = tid; e < PT * PT; e += P4_THREADS) {
      const int gi = I * PT + e / PT, gj = J * PT + e % PT;
      float& v = cbt[(e / PT) * cb_s + e % PT];
      v = gi >= gj ? v * expf((float)(cum[gi] - cum[gj])) * dts[gj] : 0.f;
    }
    __syncthreads();
    // causal on the diagonal; a warp without head dims sits out
    const int kend = ntw <= 0 ? 0 : J == I ? 16 * wr + 16 : PT;
    const float* ar = cbt + r0 * cb_s + t;
#pragma unroll 4
    for (int k = 0; k < kend; k += 8) {
      FragA fa;
      fa.set(ar[k], ar[8 * cb_s + k], ar[k + 4], ar[8 * cb_s + k + 4]);
      float b0[4], b1[4];
      const float* br = xs + (k + t) * xs_s + 8 * n0 + g;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b0[i] = i < ntw ? br[8 * i] : 0.f;
        b1[i] = i < ntw ? br[4 * xs_s + 8 * i] : 0.f;
      }
      mma_3xtf32(acc, fa, b0, b1, ntw);
    }
    __syncthreads();  // stage J & 1 free for tile J + 2
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = I * PT + r0 + 8 * r;
    if (i >= L) continue;
    float* yr = y + (((long long)b * a.S + t0 + i) * a.H + h) * hp;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = 8 * (n0 + q) + 2 * t;
      if (p < hp) yr[p] = acc[q][2 * r];
      if (p + 1 < hp) yr[p + 1] = acc[q][2 * r + 1];
    }
  }
}

// Shared memory of the passes, in bytes (mirrored by smem_bytes in
// ssd_scan/kernel.py)
__host__ __forceinline__ size_t pass_smem(int pass, int hp, int N, int L) {
  const int LT = pad_to(L, PT), HP8 = pad_to(hp, 8);
  switch (pass) {
    case 1:
      return (size_t)2 * PT * stride_g_t(N) * 4;
    case 2:  // cum in fp64, the weights, the ring
      return (size_t)(3 * LT + 2 * PT * (stride_t_g(hp) + stride_t_g(N))) * 4;
    case 4: {
      const int init = (PT + HP8) * stride_g_t(N);
      const int ring = 2 * PT * (stride_g_t(PT) + stride_t_g(hp));
      return (size_t)(3 * LT + (init > ring ? init : ring)) * 4;
    }
    default:
      return 0;
  }
}

// Launch the passes named in the bit mask (1: C B^T, 2: chunk states, 4:
// state passing, 8: chunk scan), in that order, on one stream.
int launch_passes(const float* x, const float* adt, const float* dt,
                  const float* Bm, const float* Cm, float* y, const float* h0,
                  float* hout, float* cb, float* st, double* cum, const Args& a,
                  int Bsz, int passes, cudaStream_t s) {
  const int L = a.L, nc = a.S / L, nT = pad_to(L, PT) / PT;
  if (nc > 65535 || a.H > 65535 || Bsz > 65535 ||
      (long long)Bsz * nc > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (passes & 1) {
    const size_t smem = pass_smem(1, a.hp, a.N, L);
    if ((err = set_smem(ssd_cb_kernel, smem)) != cudaSuccess) return (int)err;
    ssd_cb_kernel<<<dim3(nT * (nT + 1) / 2, nc, Bsz), P1_THREADS, smem, s>>>(
        Bm, Cm, cb, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    const size_t smem = pass_smem(2, a.hp, a.N, L);
    if ((err = set_smem(ssd_chunk_state_kernel, smem)) != cudaSuccess)
      return (int)err;
    ssd_chunk_state_kernel<<<dim3(a.H, nc, Bsz), P2_THREADS, smem, s>>>(
        x, adt, dt, Bm, st, cum, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 4) {
    const int blocks = (a.hp * a.N + P3_THREADS - 1) / P3_THREADS;
    ssd_state_pass_kernel<<<dim3(blocks, a.H, Bsz), P3_THREADS, 0, s>>>(
        st, cum, h0, hout, a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (passes & 8) {
    const size_t smem = pass_smem(4, a.hp, a.N, L);
    if ((err = set_smem(ssd_chunk_scan_kernel, smem)) != cudaSuccess)
      return (int)err;
    ssd_chunk_scan_kernel<<<dim3(nT, a.H, Bsz * nc), P4_THREADS, smem, s>>>(
        x, dt, Cm, cb, cum, st, y, a, h0 != nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// Shared memory one block needs, in bytes (mirrored by smem_bytes in
// ssd_scan/kernel.py): variant 0 holds the chunk whole; variant 1, the
// largest of its passes.
static size_t smem_bytes(int variant, int hp, int N, int L) {
  if (variant == 1) {
    const size_t s1 = pass_smem(1, hp, N, L), s2 = pass_smem(2, hp, N, L);
    const size_t s4 = pass_smem(4, hp, N, L);
    const size_t s12 = s1 > s2 ? s1 : s2;
    return s12 > s4 ? s12 : s4;
  }
  const int P4 = pad4(hp), L4 = pad4(L), N4 = pad4(N);
  return (size_t)(L4 * P4 + 2 * N4 * L4 + L4 * L4 + N4 * P4 + 4 * L4) * 4;
}

// x (Bsz,S,H,hp) via strides (b, s, h, p); adt/dt (Bsz,S,H) via (b, s, h);
// B/C (Bsz,S,N) via (b, s, n); fp32 throughout.  y contiguous
// (Bsz,S,H,hp); h0 (initial state) and hout (final state) contiguous
// (Bsz,H,hp,N), either null.  Requires S % L == 0.  vx = 1 promises x rows
// that are contiguous, a multiple of 16 bytes long and 16-byte aligned;
// vbc = 1 the same of B and C.  variant 0: the whole chunk in shared
// memory (cb, st, cum and passes unused); 1: the four passes (hp <= 64,
// N <= 128), run as the bit mask ``passes`` names (15: all; a single pass
// alone reads the scratch the earlier ones write), with contiguous scratch
// cb (Bsz, S/L, LT, LT) and st (Bsz, S/L, H, hp, N) in fp32 and cum (Bsz,
// S/L, H, LT) in fp64, LT = L padded to a multiple of 64.
extern "C" int repro_ssd_scan_fwd(
    const void* x, const void* adt, const void* dt, const void* B,
    const void* C, void* y, const void* h0, void* hout, void* cb, void* st,
    void* cum, int Bsz, int S, int H, int hp, int N, int L, int xsb, int xss,
    int xsh, int xsp, int asb, int ass, int ash, int dsb, int dss, int dsh,
    int bsb, int bss, int bsn, int csb, int css, int csn, int vx, int vbc,
    int variant, int passes, void* stream) {
  if (L < 1 || S % L != 0 || hp < 1 || N < 1 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  const Args a = {S,   H,   hp,  N,   L,   xsb, xss, xsh, xsp, asb, ass,
                  ash, dsb, dss, dsh, bsb, bss, bsn, csb, css, csn, vx,
                  vbc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(adt);
  const float* df = static_cast<const float*>(dt);
  const float* bf = static_cast<const float*>(B);
  const float* cf = static_cast<const float*>(C);
  float* yf = static_cast<float*>(y);
  const float* h0f = static_cast<const float*>(h0);
  float* hof = static_cast<float*>(hout);
  if (variant == 1) {
    if (hp > MAX_PHP || N > MAX_PN || passes < 1 || passes > 15 ||
        smem_bytes(1, hp, N, L) > 232448)
      return (int)cudaErrorInvalidValue;
    return launch_passes(xf, af, df, bf, cf, yf, h0f, hof,
                         static_cast<float*>(cb), static_cast<float*>(st),
                         static_cast<double*>(cum), a, Bsz, passes, s);
  }
  const size_t smem = smem_bytes(variant, hp, N, L);
  const dim3 grid(H, Bsz);
  // the serving shape (chunk 64, head dim 64, state 32) gets its own
  // instance with the loop bounds compiled in
  const bool serving = pad4(L) == 64 && pad4(hp) == 64 && pad4(N) == 32;
  auto kernel = serving ? ssd_kernel<64, 64, 32> : ssd_kernel<0, 0, 0>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, s>>>(xf, af, df, bf, cf, yf, h0f, hof, a);
  return (int)cudaGetLastError();
}
