// Single-query GQA attention over a (ring) KV cache, split across blocks
// along the cache (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel, launched by decode_attention_grouped).  Same
// arithmetic: q is scaled before the dot, slots with pos < 0 are masked
// with -1e30 (so a cache with no valid slot averages its values, as the
// reference's softmax does), the online softmax runs across kv tiles in
// fp32, and the sum is clamped at 1e-30.
//
// Bound on this card.  Decode streams the whole cache once: bytes, not
// operations, bound it (4 FLOP per cached element and query head).  The
// zoo's step (B=2, W=2048, 8 kv heads of 128, bf16) reads 16.8 MB of K and
// V, 5.0 us at 3.35 TB/s; the cascade's readout (B=64, W=128, 4 heads of
// 32, fp32) 8.4 MB at most, less the padded slots.
//
// Design.  Grid (kv head, batch, split): a block owns the G query heads
// of one (b, kv head) and one contiguous range of slots; the split count
// comes from the shapes alone (kernel.py num_splits: about two blocks an
// SM, at least 128 slots a split), so the zoo's 16 (b, kv head) pairs fill
// the card with 16 splits where one block per pair used 16 SMs.  The block
// walks its range in tiles of 64 slots (16-32 for head dims above 128):
//   * stage: K and V rows go to shared memory as fp32, 16 bytes a thread
//     (8 bf16 or 4 fp32 values) when the head dim is contiguous and rows
//     are 16-byte aligned, eight loads in flight per thread before the
//     first store; element by element through the strides otherwise;
//   * scores: a group of lanes per slot (a warp at head dim 128, a quarter
//     warp at 32) reads the key as float4s; each lane holds its float4 of
//     up to GREG = 8 scaled query rows in registers, and a shuffle
//     reduction that spreads the sums across the group's lanes
//     (spread_sum) takes 9 shuffles for 8 heads where one reduction per
//     head takes 40.  A group of more than 8 heads (Llama-3-405B's 16 at
//     head dim 128) is scored 8 heads at a time from the same staged K
//     tile, each pass loading its heads' float4s from shared memory: K and
//     V still leave memory once, where splitting the heads across blocks
//     would read them once per block, and the bound counts them once;
//   * softmax: a warp per query head takes the tile max, exp and sum;
//   * p.v: each thread owns (g, 4 dims) outputs and reads V as float4s;
//     when there are fewer such quads than threads the tile's slots are
//     dealt to several threads per quad and summed at the end.
// One split: the block normalises and writes o, one launch.  More splits:
// each block writes its (m, l) and unnormalised accumulator to scratch
// the wrapper allocates, and a second small kernel combines them per
// (b, kv head, g): M = max m_s, L = sum l_s e^(m_s - M), o = sum acc_s
// e^(m_s - M) / max(L, 1e-30).  Slots past W are -inf (excluded), masked
// slots -1e30, so a split whose every slot is empty weighs e^(-1e30 - M) =
// 0 once another split holds a valid slot, and a cache with no valid slot
// averages all its values, as the single pass does.
//
// The "partial" entry (repro_decode_attention_partial) runs the same two
// kernels but stores the merged, unnormalised softmax state of its range
// instead of o: M, L and acc = sum acc_s e^(m_s - M), in fp32.  One split
// writes its block's (m, l, acc) there directly.  A decode step whose
// cache length is split over ranks runs it on each rank's slots and
// merges the ranks' states with the same arithmetic across the mesh
// (models/sharded.py), so only (B, H, hd + 2) floats a rank leave the
// kernel where an o would be (B, H, hd) in q's dtype.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_QUADS = 2;  // (g, 4 dims) outputs a thread owns
constexpr int GREG = 8;       // query heads the fast scorer keeps in registers
constexpr int UNROLL = 8;     // 16-byte loads in flight per thread

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 fma4(float p, float4 v, float4 acc) {
  return make_float4(fmaf(p, v.x, acc.x), fmaf(p, v.y, acc.y),
                     fmaf(p, v.z, acc.z), fmaf(p, v.w, acc.w));
}

// 16 bytes of T -> 16 / sizeof(T) floats at dst (16-byte aligned); bf16
// widens exactly by a shift into the high half of an fp32
__device__ __forceinline__ void store_vec(float* dst, uint4 r, float) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(r.x), __uint_as_float(r.y),
                  __uint_as_float(r.z), __uint_as_float(r.w));
}
__device__ __forceinline__ float4 bf16x4(unsigned lo, unsigned hi) {
  return make_float4(__uint_as_float(lo << 16),
                     __uint_as_float(lo & 0xffff0000u),
                     __uint_as_float(hi << 16),
                     __uint_as_float(hi & 0xffff0000u));
}
__device__ __forceinline__ void store_vec(float* dst, uint4 r,
                                          __nv_bfloat16) {
  reinterpret_cast<float4*>(dst)[0] = bf16x4(r.x, r.y);
  reinterpret_cast<float4*>(dst)[1] = bf16x4(r.z, r.w);
}

// Sum NV values across the lanes of a group (lanes that differ in the bits
// below 2 * OFF) while spreading them: each halving step sends the half a
// lane gives up and keeps the other, so 8 values over 32 lanes take 4 + 2
// + 1 + 1 + 1 shuffles instead of 8 x 5.  Lane li ends with its group's
// totals of heads g0 .. g0 + max(1, NV / group size) - 1 in v[0 ..].
template <int NV, int OFF>
__device__ __forceinline__ void spread_sum(float* v, int li, int& g0) {
  if constexpr (OFF > 0) {
    if constexpr (NV > 1) {
      constexpr int H = NV / 2;
      const bool up = (li & OFF) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if (up) g0 += H;
      spread_sum<H, OFF / 2>(v, li, g0);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      spread_sum<1, OFF / 2>(v, li, g0);
    }
  }
}

// Scores of tl slots for up to GREG query heads (G of them, rows g_lo ..
// g_lo + G - 1 of ss): LPS lanes per slot, lane li holding float4 chunk li
// of the scaled query rows in qreg (the row has at most LPS chunks),
// masked slots at -1e30.
template <int LPS>
__device__ __forceinline__ void score_tile(const float4 (&qreg)[GREG],
                                           const float4* ks4, const int* ps,
                                           float* ss, int nch, int ts, int tl,
                                           int G, int g_lo, int tid) {
  constexpr int SPP = THREADS / LPS, KEEP = LPS >= GREG ? 1 : GREG / LPS;
  constexpr int DUP = LPS > GREG ? LPS / GREG : 1;  // lanes with one total
  const int li = tid % LPS;
#pragma unroll 2
  for (int j0 = 0; j0 < tl; j0 += SPP) {
    const int j = j0 + tid / LPS;
    const bool live = j < tl;
    const float4 kk = (live && li < nch) ? ks4[j * nch + li]
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
    float v[GREG];
#pragma unroll
    for (int g = 0; g < GREG; ++g) v[g] = dot4(qreg[g], kk);
    int g0 = 0;
    spread_sum<GREG, LPS / 2>(v, li, g0);
    if (live && li % DUP == 0) {
      const bool ok = ps[j] >= 0;
#pragma unroll
      for (int i = 0; i < KEEP; ++i)
        if (g0 + i < G)
          ss[(g_lo + g0 + i) * ts + j] = ok ? v[i] : REPRO_NEG_INF;
    }
  }
}

struct Args {
  int W, H, G, hd, hd4, ts, split_len;
  int partial;  // store the range's (M, L, acc) instead of o
  int to_part;  // blocks write (m, l, acc): several splits, or partial
  int qsb, qsh, qsd, ksb, ksw, ksh, ksd, vsb, vsw, vsh, vsd, psb, psw;
  float sm_scale;
};

// Floats the K and V tiles take: at least a float4 per thread, which the
// final sum over slot parts reuses.
__host__ __device__ __forceinline__ int kv_floats(int ts, int hd4) {
  return max(2 * ts * hd4, 4 * THREADS);
}

// MULTI: more than GREG query heads a kv head, scored GREG at a time
template <typename T, bool VEC, bool MULTI>
__global__ void __launch_bounds__(THREADS, 2)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos,
              T* __restrict__ o, float* __restrict__ part_m,
              float* __restrict__ part_l, float* __restrict__ part_acc,
              const Args a) {
  extern __shared__ float4 smem4[];
  const int G = a.G, hd = a.hd, ld = a.hd4, ts = a.ts, nch = ld / 4;
  float* qs = reinterpret_cast<float*>(smem4);  // G x ld, pre-scaled
  float* ks = qs + G * ld;                      // ts x ld
  float* vs = ks + ts * ld;                     // ts x ld
  float* ss = ks + kv_floats(ts, ld);           // G x ts probabilities
  float* mrow = ss + G * ts;                    // G running max
  float* lrow = mrow + G;                       // G running sum
  float* crow = lrow + G;                       // G tile correction
  int* ps = reinterpret_cast<int*>(crow + G);   // ts slot positions
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);

  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int nsplit = gridDim.z, K = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s_lo = sp * a.split_len, s_hi = min(a.W, s_lo + a.split_len);
  const T* kb = k + (long long)b * a.ksb + (long long)kh * a.ksh;
  const T* vb = v + (long long)b * a.vsb + (long long)kh * a.vsh;
  const int* pb = pos + (long long)b * a.psb;

#pragma unroll 4
  for (int i = tid; i < G * ld; i += THREADS) {
    const int g = i / ld, d = i - g * ld;
    qs[i] = d < hd ? to_float(q[(long long)b * a.qsb +
                                (long long)(kh * G + g) * a.qsh +
                                (long long)d * a.qsd]) * a.sm_scale
                   : 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    mrow[g] = REPRO_NEG_INF;
    lrow[g] = 0.f;
  }
  // scorer: lps lanes per slot (a warp at head dim 128, a quarter warp at
  // 32); the fast path (a row of at most 32 float4s) holds each lane's
  // float4 of up to GREG query rows in registers (all G of them when G <=
  // GREG, else GREG at a time), the other reads them from shared memory
  int lps = 1;
  while (lps < 32 && lps < nch) lps *= 2;
  const int li = tid % lps, spp = THREADS / lps;
  const bool fast = nch <= lps;
  // p.v: quad oq (+ THREADS * s) of the G x nch (g, 4 dims) outputs; slots
  // j = part mod nparts when there are fewer quads than threads
  const int GQ = G * nch;
  const int nparts = GQ <= THREADS ? THREADS / GQ : 1;
  const int part = GQ <= THREADS ? tid / GQ : 0;
  const int oq = GQ <= THREADS ? tid % GQ : tid;
  float4 acc[MAX_QUADS];
#pragma unroll
  for (int s = 0; s < MAX_QUADS; ++s) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int vrow = hd / (16 / sizeof(T));  // 16-byte vectors per row
  __syncthreads();  // q staged
  float4 qreg[GREG];
#pragma unroll
  for (int g = 0; g < GREG; ++g)
    qreg[g] = (fast && !MULTI && g < G && li < nch)
                  ? qs4[g * nch + li]
                  : make_float4(0.f, 0.f, 0.f, 0.f);

  for (int w0 = s_lo; w0 < s_hi; w0 += ts) {
    const int tl = min(ts, s_hi - w0);
    // the slots' positions, loaded beside K and V (ts <= THREADS)
    const int pv = tid < tl ? pb[(long long)(w0 + tid) * a.psw] : 0;
    __syncthreads();  // previous tile's readers done
    if (VEC) {  // K rows then V rows, UNROLL loads a thread in flight
      constexpr int VE = 16 / sizeof(T);
      const int nv = tl * vrow;
      for (int base = 0; base < 2 * nv; base += THREADS * UNROLL) {
        uint4 buf[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int i = base + u * THREADS + tid;
          if (i < 2 * nv) {
            const bool isv = i >= nv;
            const int r = isv ? i - nv : i, row = r / vrow, c = r - row * vrow;
            const T* src = isv ? vb + (long long)(w0 + row) * a.vsw
                               : kb + (long long)(w0 + row) * a.ksw;
            buf[u] = *reinterpret_cast<const uint4*>(src + c * VE);
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int i = base + u * THREADS + tid;
          if (i < 2 * nv) {
            const bool isv = i >= nv;
            const int r = isv ? i - nv : i, row = r / vrow, c = r - row * vrow;
            store_vec((isv ? vs : ks) + row * ld + c * VE, buf[u], T());
          }
        }
      }
    } else {
      for (int i = tid; i < 2 * tl * ld; i += THREADS) {
        const bool isv = i >= tl * ld;
        const int r = isv ? i - tl * ld : i, row = r / ld, d = r - row * ld;
        float val = 0.f;
        if (d < hd)
          val = isv ? to_float(vb[(long long)(w0 + row) * a.vsw +
                                  (long long)d * a.vsd])
                    : to_float(kb[(long long)(w0 + row) * a.ksw +
                                  (long long)d * a.ksd]);
        (isv ? vs : ks)[row * ld + d] = val;
      }
    }
    if (tid < tl) ps[tid] = pv;
    __syncthreads();

    // scores of the tile's slots, a lane group per slot
    if (fast) {
      // MULTI: GREG heads a pass, each pass's loaded from shared memory
      for (int g_lo = 0; g_lo < G; g_lo += GREG) {
        const int gn = MULTI ? min(GREG, G - g_lo) : G;
        if (MULTI) {
#pragma unroll
          for (int g = 0; g < GREG; ++g)
            qreg[g] = (g < gn && li < nch) ? qs4[(g_lo + g) * nch + li]
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        switch (lps) {
          case 1:
            score_tile<1>(qreg, ks4, ps, ss, nch, ts, tl, gn, g_lo, tid);
            break;
          case 2:
            score_tile<2>(qreg, ks4, ps, ss, nch, ts, tl, gn, g_lo, tid);
            break;
          case 4:
            score_tile<4>(qreg, ks4, ps, ss, nch, ts, tl, gn, g_lo, tid);
            break;
          case 8:
            score_tile<8>(qreg, ks4, ps, ss, nch, ts, tl, gn, g_lo, tid);
            break;
          case 16:
            score_tile<16>(qreg, ks4, ps, ss, nch, ts, tl, gn, g_lo, tid);
            break;
          default:
            score_tile<32>(qreg, ks4, ps, ss, nch, ts, tl, gn, g_lo, tid);
        }
        if (!MULTI) break;
      }
    } else {
      for (int j0 = 0; j0 < tl; j0 += spp) {
        const int j = j0 + tid / lps;
        const bool live = j < tl;
        for (int g = 0; g < G; ++g) {
          float sc = 0.f;
          if (live)
            for (int c = li; c < nch; c += lps)
              sc += dot4(qs4[g * nch + c], ks4[j * nch + c]);
          for (int off = lps >> 1; off > 0; off >>= 1)
            sc += __shfl_xor_sync(0xffffffffu, sc, off);
          if (live && li == 0)
            ss[g * ts + j] = ps[j] >= 0 ? sc : REPRO_NEG_INF;
        }
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += THREADS / 32) {
      float tmax = -INFINITY;
      for (int j = lane; j < tl; j += 32) tmax = fmaxf(tmax, ss[g * ts + j]);
      tmax = warp_max(tmax);
      const float m_prev = mrow[g];
      const float m_new = fmaxf(m_prev, tmax);
      float psum = 0.f;
      for (int j = lane; j < tl; j += 32) {
        const float p = expf(ss[g * ts + j] - m_new);
        ss[g * ts + j] = p;
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
    if (part < nparts) {
#pragma unroll
      for (int s = 0; s < MAX_QUADS; ++s) {
        const int idx = oq + s * THREADS;
        if (idx < GQ) {
          const int g = idx / nch, dq = idx - g * nch;
          const float* pg = ss + g * ts;
          const float corr = crow[g];
          float4 x = make_float4(acc[s].x * corr, acc[s].y * corr,
                                 acc[s].z * corr, acc[s].w * corr);
#pragma unroll 4
          for (int j = part; j < tl; j += nparts)
            x = fma4(pg[j], vs4[j * nch + dq], x);
          acc[s] = x;
        }
      }
    }
  }

  if (nparts > 1) {  // sum the slot parts of each output quad
    float4* red = reinterpret_cast<float4*>(ks);
    __syncthreads();
    if (part < nparts) red[part * GQ + oq] = acc[0];
    __syncthreads();
    if (part == 0)
      for (int r = 1; r < nparts; ++r) {
        const float4 y = red[r * GQ + oq];
        acc[0] = make_float4(acc[0].x + y.x, acc[0].y + y.y, acc[0].z + y.z,
                             acc[0].w + y.w);
      }
  }
  if (part != 0) return;
  const long long row = ((long long)b * K + kh) * nsplit + sp;
#pragma unroll
  for (int s = 0; s < MAX_QUADS; ++s) {
    const int idx = oq + s * THREADS;
    if (idx < GQ) {
      const int g = idx / nch, d0 = 4 * (idx - g * nch);
      const float r[4] = {acc[s].x, acc[s].y, acc[s].z, acc[s].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (d0 + e >= hd) break;
        if (!a.to_part)
          o[((long long)b * a.H + kh * G + g) * hd + d0 + e] =
              from_float<T>(r[e] / fmaxf(lrow[g], 1e-30f));
        else
          part_acc[(row * G + g) * hd + d0 + e] = r[e];
      }
    }
  }
  if (a.to_part)
    for (int g = tid; g < G; g += THREADS) {
      part_m[row * G + g] = mrow[g];
      part_l[row * G + g] = lrow[g];
    }
}

// Blocks (kv head, batch, output slice): merge the splits' partials.  The
// splits' weights e^(m_s - M) and the clamped sums go to shared memory
// first, so each output's sum over splits is a run of independent loads.
// PARTIAL: store M, L and the weighted sum of the accumulators to
// out_m / out_l / out_acc, (B, H) / (B, H) / (B, H, hd) fp32, not o.
template <typename T, bool PARTIAL>
__global__ void __launch_bounds__(THREADS)
decode_combine(const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ o,
               float* __restrict__ out_m, float* __restrict__ out_l,
               float* __restrict__ out_acc, int H, int G, int hd,
               int nsplit) {
  extern __shared__ float wsm[];  // nsplit x G weights, then G sums
  float* lsum = wsm + nsplit * G;
  const int kh = blockIdx.x, b = blockIdx.y, K = gridDim.x;
  const long long row0 = ((long long)b * K + kh) * nsplit;
  const float* pm = part_m + row0 * G;  // (nsplit, G) of this (b, kh)
  const float* pl = part_l + row0 * G;
  for (int i = threadIdx.x; i < nsplit * G; i += THREADS) wsm[i] = pm[i];
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, wsm[s * G + g]);
    lsum[g] = M;
    if (PARTIAL && blockIdx.z == 0) out_m[(long long)b * H + kh * G + g] = M;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nsplit * G; i += THREADS)
    wsm[i] = expf(wsm[i] - lsum[i % G]);
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += THREADS) {
    float L = 0.f;
    for (int s = 0; s < nsplit; ++s) L += pl[s * G + g] * wsm[s * G + g];
    if (PARTIAL && blockIdx.z == 0) out_l[(long long)b * H + kh * G + g] = L;
    lsum[g] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const int idx = blockIdx.z * THREADS + threadIdx.x;
  if (idx >= G * hd) return;
  const int g = idx / hd, d = idx - g * hd;
  const float* pa = part_acc + (row0 * G + g) * hd + d;
  float acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s)
    acc += pa[(long long)s * G * hd] * wsm[s * G + g];
  const long long at = ((long long)b * H + kh * G + g) * hd + d;
  if (PARTIAL)
    out_acc[at] = acc;
  else
    o[at] = from_float<T>(acc / lsum[g]);
}

// Slots a tile stages: 64, fewer for wide heads (shared memory).
int tile_slots(int hd) { return hd <= 128 ? 64 : (hd <= 256 ? 32 : 16); }

size_t smem_bytes(int G, int hd4, int ts) {
  return (size_t)(G * hd4 + kv_floats(ts, hd4) + G * ts + 3 * G + ts) * 4;
}

// out (partial only): M (B*H), L (B*H), acc (B*H*hd) fp32, one after another
template <typename T, bool PARTIAL>
int combine(const float* pm, const float* pl, const float* pacc, void* o,
            float* out, int B, int K, int nsplit, const Args& a,
            cudaStream_t stream) {
  const size_t csmem = (size_t)(nsplit + 1) * a.G * 4;
  cudaError_t err = set_smem(decode_combine<T, PARTIAL>, csmem);
  if (err != cudaSuccess) return (int)err;
  const int slices = (a.G * a.hd + THREADS - 1) / THREADS;
  const long long bh = PARTIAL ? (long long)B * a.H : 0;
  decode_combine<T, PARTIAL><<<dim3(K, B, slices), THREADS, csmem, stream>>>(
      pm, pl, pacc, static_cast<T*>(o), out, out + bh, out + 2 * bh, a.H,
      a.G, a.hd, nsplit);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch(const void* q, const void* k, const void* v, const int* pos,
           void* o, float* pm, float* pl, float* pacc, int B, int K,
           int nsplit, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.G, a.hd4, a.ts);
  auto kernel = a.G > GREG ? decode_kernel<T, VEC, true>
                           : decode_kernel<T, VEC, false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // "partial" with one split: the block's (m, l, acc) are the output
  float* out = static_cast<float*>(o);
  const long long bh = (long long)B * a.H;
  const bool direct = a.partial && nsplit == 1;
  kernel<<<dim3(K, B, nsplit), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, static_cast<T*>(o),
      direct ? out : pm, direct ? out + bh : pl, direct ? out + 2 * bh : pacc,
      a);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  return a.partial ? combine<T, true>(pm, pl, pacc, nullptr, out, B, K,
                                      nsplit, a, stream)
                   : combine<T, false>(pm, pl, pacc, o, nullptr, B, K, nsplit,
                                       a, stream);
}

template <typename T>
int launch(bool vec, const void* q, const void* k, const void* v,
           const int* pos, void* o, float* pm, float* pl, float* pacc, int B,
           int K, int nsplit, const Args& a, cudaStream_t stream) {
  return vec ? launch<T, true>(q, k, v, pos, o, pm, pl, pacc, B, K, nsplit,
                               a, stream)
             : launch<T, false>(q, k, v, pos, o, pm, pl, pacc, B, K, nsplit,
                                a, stream);
}

// q (B,1,H,hd) via strides (b, head, d); k/v (B,W,K,hd) via (b, w, head, d);
// pos (B,W) int32 via (b, w); o contiguous (B,1,H,hd).  dtype 0 = fp32,
// 1 = bf16.  Requires H % K == 0 and (H/K) * hd <= 2048.  nsplit blocks
// of split_len slots each cover the cache (nsplit = ceil(W / split_len));
// with nsplit > 1, part_m / part_l (B,K,nsplit,G) and part_acc
// (B,K,nsplit,G,hd) fp32 are scratch.  vec = 1 promises 16-byte-aligned k
// and v rows with a contiguous head dim of a multiple of 16 bytes.
// partial = 1: o is instead fp32 M (B,H), L (B,H) and acc (B,H,hd), one
// after another.
int run(int partial, const void* q, const void* k, const void* v,
        const void* pos, void* o, void* part_m, void* part_l, void* part_acc,
        int dtype, int B, int W, int H, int K, int hd, int nsplit,
        int split_len, int vec, int qsb, int qsh, int qsd, int ksb, int ksw,
        int ksh, int ksd, int vsb, int vsw, int vsh, int vsd, int psb,
        int psw, float sm_scale, void* stream) {
  if (hd < 1 || K < 1 || H % K != 0 || (H / K) * hd > 2048 ||
      (H / K) * ((hd + 3) / 4) > THREADS * MAX_QUADS ||
      nsplit < 1 || split_len < 1 || (long long)nsplit * split_len < W ||
      (long long)(nsplit - 1) * split_len >= W)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.W = W;
  a.H = H;
  a.G = H / K;
  a.hd = hd;
  a.hd4 = (hd + 3) / 4 * 4;
  a.ts = tile_slots(hd);
  a.split_len = split_len;
  a.partial = partial;
  a.to_part = partial || nsplit > 1;
  a.qsb = qsb, a.qsh = qsh, a.qsd = qsd;
  a.ksb = ksb, a.ksw = ksw, a.ksh = ksh, a.ksd = ksd;
  a.vsb = vsb, a.vsw = vsw, a.vsh = vsh, a.vsd = vsd;
  a.psb = psb, a.psw = psw;
  a.sm_scale = sm_scale;
  const int* p = static_cast<const int*>(pos);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pacc = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(vec != 0, q, k, v, p, o, pm, pl, pacc, B, K, nsplit,
                         a, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(vec != 0, q, k, v, p, o, pm, pl, pacc, B, K,
                                 nsplit, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int repro_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    void* part_m, void* part_l, void* part_acc, int dtype, int B, int W,
    int H, int K, int hd, int nsplit, int split_len, int vec, int qsb,
    int qsh, int qsd, int ksb, int ksw, int ksh, int ksd, int vsb, int vsw,
    int vsh, int vsd, int psb, int psw, float sm_scale, void* stream) {
  return run(0, q, k, v, pos, o, part_m, part_l, part_acc, dtype, B, W, H, K,
             hd, nsplit, split_len, vec, qsb, qsh, qsd, ksb, ksw, ksh, ksd,
             vsb, vsw, vsh, vsd, psb, psw, sm_scale, stream);
}

// The same arguments; out holds fp32 M (B,H), L (B,H) and the unnormalised
// acc (B,H,hd) of the given slots (the "partial" variant).
extern "C" int repro_decode_attention_partial(
    const void* q, const void* k, const void* v, const void* pos, void* out,
    void* part_m, void* part_l, void* part_acc, int dtype, int B, int W,
    int H, int K, int hd, int nsplit, int split_len, int vec, int qsb,
    int qsh, int qsd, int ksb, int ksw, int ksh, int ksd, int vsb, int vsw,
    int vsh, int vsd, int psb, int psw, float sm_scale, void* stream) {
  return run(1, q, k, v, pos, out, part_m, part_l, part_acc, dtype, B, W, H,
             K, hd, nsplit, split_len, vec, qsb, qsh, qsd, ksb, ksw, ksh, ksd,
             vsb, vsw, vsh, vsd, psb, psw, sm_scale, stream);
}
