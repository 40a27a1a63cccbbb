// Flash decode for Hopper (sm_90a): one query token per (batch row,
// head) against the KV cache, with a per-row validity mask.
//
// Replaces the TPU kernel flash_decode_pallas
// (src/repro/kernels/flash_attention.py:121, pallas_call at :146). It
// computes the same function: fp32 scores q.k * scale, a softmax over
// the live cache rows, the fp32 weighted sum of v, divided by the
// softmax denominator at the end; a fully masked row gives zeros. It
// reads the cache in the model's own layout, k, v: (B, L, KVH, hd), with
// q: (B, KVH, G, hd) and valid: (B, L) uint8, so the G query heads that
// share a KV head read each K/V byte from device memory once (the TPU
// wrapper repeated K/V G times into (B*H, L, hd) blocks). Any L works.
//
// What bounds it on the card: bytes. A call must read the live rows of K
// and V once and does about 4 G flops per element read, below the ~295
// flops/byte where H100's compute would bind; at G 16 that is 64 flops a
// byte, more than the fp32 FMAs can do at the bytes' rate, so bf16 with
// G > 1 runs q.k and p.v on the tensor cores. At serving shapes (L 64)
// the launch and one round trip to memory are the floor. The design,
// against each way a decode kernel falls short of that:
//
//  * Too few blocks: L is split across blocks (flash-decoding). The grid
//    is (B * KVH, S); split s takes rows [s * chunk, (s + 1) * chunk).
//    S and chunk come from ops.decode_splits, a function of the shape
//    and the card's SM count (132 on the H100 SXM) that aims at one to
//    two waves of the SMs with at least one tile of rows a split (S = 1
//    at the path's L 64). With S > 1 each
//    split writes its fp32 (m, l, acc) to scratch; the last split of a
//    (b, h) to arrive (__threadfence, then an atomicAdd on a per-(b, h)
//    counter, which that block resets to 0) merges the S partials in
//    split order and writes the output: one launch a call. A split with
//    no live row has m = -1e30 and l = 0 and merges as nothing.
//  * A serial chain of rows: a tile's scores are computed in parallel,
//    LPR lanes a cache row (one 16-byte load a lane, or 8 bytes where
//    G is 16), reduced across the lanes by shuffles; at G 16 a butterfly
//    leaves each lane the sums of its own query heads. Then one max and
//    one sum a tile a query head, one rescale of the running (m, l, acc)
//    a tile, and p.v with threads over head dims and slices of rows,
//    reduced across the slices once, at the end. In bf16 with G > 1 the
//    G query heads are the 16 rows of mma.sync m16n8k16's A: scores are
//    q K^T (a warp 16 cache rows), p.v is P V (a warp HD / 4 head dims)
//    with P split into bf16 hi + lo parts, so p keeps ~16 bits as the
//    fp32 plain version's does; both sum in fp32.
//  * Round trips: q, the first tiles' K and V (cp.async, zeros past the
//    split) and their mask bytes are issued together; a ring of kStages
//    tiles keeps the next tiles' copies in flight under this tile's math.
//
// Head dims: any hd with hd % 8 == 0 and 8 <= hd <= 128 runs on the
// instance of the next HD in {32, 64, 128}. Global memory is read and
// written at the true hd (row strides of hd elements, never a column
// past hd); the columns hd .. HD - 1 are zero-filled in shared memory
// and registers, add exactly 0 to q.k, and are dropped from the output.
// The scale (1 / sqrt(hd)) comes from the wrapper. At hd == HD nothing
// is padded; chip_smoke.py holds hd 64 and 128 bitwise to the kernel
// before the padding (tests/data/attn_fingerprints_hd64_128.json).
//
// Built by nvcc into a shared library with a plain C interface and
// called through ctypes (src/repro_torch/kernels/ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;       // tiles in the cp.async ring
constexpr int kMaxSplits = 128;  // ops.MAX_DECODE_SPLITS
constexpr float kNeg = -1e30f;   // the TPU kernel's mask value

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// N consecutive elements of T at p (4, 8 or 16 bytes, p aligned to
// that) as floats, in one load. A bf16 is the high half of its float.
template <typename T, int N>
__device__ __forceinline__ void load_vec(float (&f)[N], const T* p) {
  constexpr int kWords = sizeof(T) * N / 4;
  static_assert(kWords == 1 || kWords == 2 || kWords == 4, "one load");
  uint32_t w[kWords];
  if constexpr (kWords == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (kWords == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// x rounded to bf16 (nearest even), as its 16 bits.
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Sums v over the LPR lanes of a row (lanes lr = lane % LPR). With C
// pairs left a step, each lane keeps one half of its values and sends the
// other to its partner, so after log2(LPR) steps lane lr holds the sums
// of values [lr * N / LPR, (lr + 1) * N / LPR) in v[0 ..) when N >= LPR,
// or of value lr / (LPR / N) in v[0] when N < LPR.
template <int C, int O, int N>
__device__ __forceinline__ void row_sum(float (&v)[N], int lane) {
  if constexpr (O >= 1) {
    if constexpr (C >= 1) {
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float send = up ? v[i] : v[i + C];
        const float keep = up ? v[i + C] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      row_sum<C / 2, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      row_sum<0, O / 2>(v, lane);
    }
  }
}

// HD: the instance's head dim (32, 64 or 128; the true hd <= HD runs
// zero-padded). GMAX: the largest G this instance takes (query heads per
// KV head), 1 or 16; G <= GMAX at run time. kTC: bf16 with GMAX 16 and
// HD a multiple of 64 runs q.k and p.v on the tensor cores (mma.sync
// m16n8k16, the G query heads as the 16 rows of A); the others, HD 32
// among them (its 128-row tile is more score rows than 4 warps of 16
// take), on fp32 FMAs.
template <typename T, int HD, int GMAX>
struct Decode {
  static constexpr bool kTC = sizeof(T) == 2 && GMAX == 16 && HD % 64 == 0;
  static constexpr int TL = 4096 / HD;                   // rows a tile (ops.decode_tile_rows)
  static constexpr int KE = GMAX == 1 ? 16 / sizeof(T) : 4;  // k elements a lane
  static constexpr int LPR = HD / KE;                    // lanes a row, scores
  static constexpr int RPP = kThreads / LPR;             // rows a pass
  static constexpr int NV = GMAX < LPR ? 1 : GMAX / LPR; // sums a lane keeps
  static constexpr int DPT = GMAX == 1 ? 16 / sizeof(T) : 2;  // dims a thread, p.v
  static constexpr int NCOL = HD / DPT;
  static constexpr int NSL = kTC ? 1 : kThreads / NCOL;  // row slices, p.v
  static constexpr int GP = GMAX == 1 ? 1 : GMAX + 4;    // p row stride (floats)
  static constexpr int QLD = HD + 8;                     // q row stride (kTC)
  static constexpr int kTile = TL * HD;                  // elements of K (or V) a tile
  static constexpr size_t smem = sizeof(T) * kStages * 2 * kTile;
  static_assert(TL % RPP == 0 && TL % NSL == 0 && LPR <= 32 && 32 % LPR == 0,
                "the passes cover a tile");
  static_assert(!kTC || (TL % 16 == 0 && TL / 16 <= kWarps && HD % 64 == 0),
                "16 score rows a warp, 16-column blocks of v a warp");
  static_assert(sizeof(float) * NSL * GMAX * HD <= smem &&
                    sizeof(float) * (kMaxSplits + 1) * GMAX <= smem,
                "the slice reduction and the merge weights fit in the ring");
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* valid;
  void* out;
  float* part_ml;   // (B*KVH, S, G, 2) m, l of each split (S > 1)
  float* part_acc;  // (B*KVH, S, G, HD) acc of each split (S > 1)
  int* count;       // (B*KVH,) arrivals, 0 between calls (S > 1)
  int L, KVH, G, S, chunk;
  int hd;           // the true head dim, <= HD: the row length in memory
  float scale;
};

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_kernel(Args a) {
  using D = Decode<T, HD, GMAX>;
  constexpr int TL = D::TL, KE = D::KE, LPR = D::LPR, RPP = D::RPP;
  constexpr int DPT = D::DPT, NCOL = D::NCOL, NSL = D::NSL, GP = D::GP;
  constexpr int CH = 16 / sizeof(T);             // elements a 16-byte copy
  constexpr int CPT = D::kTile / CH / kThreads;  // copies a thread, K or V
  constexpr int NB = HD / kWarps / 8;            // kTC: n8 blocks of v a warp
  extern __shared__ uint4 ring[];                // kStages x (K tile, V tile)
  __shared__ uint8_t smask[kStages][TL];
  __shared__ __align__(16) float sp[TL * GP];   // scores, then p
  __shared__ __align__(16) T sq[D::kTC ? 16 * D::QLD : 1];  // kTC: q, 16 rows
  __shared__ float s_m[GMAX], s_l[GMAX], s_alpha[GMAX];
  __shared__ float s_rmax[kWarps][GMAX], s_rsum[kWarps][GMAX];
  __shared__ int s_last;

  const int bh = blockIdx.x;  // b * KVH + h
  const int split = blockIdx.y;
  const int b = bh / a.KVH;
  const int h = bh - b * a.KVH;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = a.G;
  const int r0 = split * a.chunk;
  const int r1 = min(a.L, r0 + a.chunk);
  const int ntiles = (r1 - r0 + TL - 1) / TL;
  const int hd = a.hd;
  const size_t row_stride = (size_t)a.KVH * hd;  // elements between cache rows
  const size_t head_off = ((size_t)b * a.L * a.KVH + h) * hd;
  const T* kb = static_cast<const T*>(a.k) + head_off;
  const T* vb = static_cast<const T*>(a.v) + head_off;
  const T* qb = static_cast<const T*>(a.q) + (size_t)bh * G * hd;
  const uint8_t* vmask = a.valid + (size_t)b * a.L;
  T* ring_t = reinterpret_cast<T*>(ring);

  // Tile t of this split into ring slot t % kStages (zeros past r1 and
  // in the columns past hd); its mask bytes come back in a register,
  // stored by store_mask.
  auto issue = [&](int t) -> uint8_t {
    const int row0 = r0 + t * TL;
    T* sk = ring_t + (t % kStages) * 2 * D::kTile;
    T* sv = sk + D::kTile;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (HD / CH), c = idx % (HD / CH) * CH;
      const bool ok = row0 + r < r1 && c < hd;
      const size_t off = ok ? (size_t)(row0 + r) * row_stride + c : 0;
      cp_async_16(sk + r * HD + c, kb + off, ok);
      cp_async_16(sv + r * HD + c, vb + off, ok);
    }
    return tid < TL && row0 + tid < r1 ? vmask[row0 + tid] : 0;
  };
  auto store_mask = [&](int t, uint8_t m) {
    if (tid < TL) smask[t % kStages][tid] = m;
  };

  uint8_t mnext[kStages - 1];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    mnext[s] = s < ntiles ? issue(s) : 0;
    cp_async_commit();
  }
  // q: on the SIMT path this lane's slice of every query head in
  // registers (zeros past G and past hd); on the tensor cores 16 rows in
  // shared memory (zeros past G and hd), and p of the heads past G
  // stays 0.
  const int lr = lane % LPR;
  float qr[D::kTC ? 1 : GMAX][KE];
  if constexpr (D::kTC) {
    for (int i = tid; i < 16 * HD; i += kThreads) {
      const int g = i / HD, d = i - g * HD;
      sq[g * D::QLD + d] =
          g < G && d < hd ? qb[(size_t)g * hd + d] : from_float<T>(0.f);
    }
    for (int i = tid; i < TL * GP; i += kThreads) sp[i] = 0.f;
  } else {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G && lr * KE < hd) {
        load_vec<T, KE>(qr[g], qb + (size_t)g * hd + lr * KE);
      } else {
#pragma unroll
        for (int i = 0; i < KE; ++i) qr[g][i] = 0.f;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) store_mask(s, mnext[s]);
  if (tid < GMAX) {
    s_m[tid] = kNeg;
    s_l[tid] = 0.f;
  }

  const int col = tid % NCOL, sl = tid / NCOL;
  const int gq = lane >> 2, q4 = lane & 3;  // kTC: a lane's rows, columns
  float acc[D::kTC ? 1 : GMAX][DPT];          // SIMT p.v
  float acc_o[D::kTC ? NB : 1][4];            // kTC p.v: 16 x HD / kWarps a warp
#pragma unroll
  for (int g = 0; g < (D::kTC ? 1 : GMAX); ++g)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[g][j] = 0.f;
#pragma unroll
  for (int n = 0; n < (D::kTC ? NB : 1); ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_o[n][j] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();               // ... everyone's; slot (t - 1) % kStages is free
    const int tn = t + kStages - 1;
    const uint8_t mn = tn < ntiles ? issue(tn) : 0;
    cp_async_commit();
    const T* sk = ring_t + (t % kStages) * 2 * D::kTile;
    const T* sv = sk + D::kTile;
    const uint8_t* mk = smask[t % kStages];
    const int nrows = min(TL, r1 - (r0 + t * TL));

    if constexpr (D::kTC) {
      // Scores S (16 heads x 16 rows a warp) = q K^T: A from q's rows, B
      // from K's rows (ldmatrix), fp32 sums.
      const int w0 = warp * 16;
      if (w0 < TL) {
        float sacc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, sq + (lane & 15) * D::QLD + kk * 16 + (lane >> 4) * 8);
          ldmatrix_x4(bf, sk + (w0 + (lane & 7) + (lane >> 4) * 8) * HD +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(sacc[0], af, bf[0], bf[1]);
          mma_bf16(sacc[1], af, bf[2], bf[3]);
        }
        // Lane 4 gq + q4 holds heads gq, gq + 8 at rows 2 q4, 2 q4 + 1 of
        // each 8-row block.
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int g = gq + 8 * hh;
              if (g < G)
                sp[(w0 + 8 * nb + 2 * q4 + j) * GP + g] = sacc[nb][2 * hh + j] * a.scale;
            }
      }
    } else {
      // Scores: LPR lanes a row, RPP rows a pass.
#pragma unroll
      for (int p = 0; p < TL / RPP; ++p) {
        const int r = p * RPP + tid / LPR;
        float kf[KE];
        load_vec<T, KE>(kf, sk + r * HD + lr * KE);
        float part[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < KE; ++i) s = fmaf(qr[g][i], kf[i], s);
          part[g] = s;
        }
        row_sum<GMAX / 2, LPR / 2>(part, lane);
        if constexpr (GMAX >= LPR) {
#pragma unroll
          for (int j = 0; j < D::NV; ++j) {
            const int g = lr * D::NV + j;
            if (g < G) sp[r * GP + g] = part[j] * a.scale;
          }
        } else {
          const int g = lr / (LPR / GMAX);
          if (lr % (LPR / GMAX) == 0 && g < G) sp[r * GP + g] = part[0] * a.scale;
        }
      }
    }
    __syncthreads();

    // One max and one sum a tile per query head, p replacing the score:
    // thread tid takes head tid % GMAX and every NP-th row from tid / GMAX;
    // the parts meet by shuffles in the warp, then through s_rmax / s_rsum.
    {
      constexpr int NP = kThreads / GMAX;
      const int g = tid % GMAX, part = tid / GMAX;
      const bool on = g < G;
      const float m_old = on ? s_m[g] : kNeg;
      float mx = kNeg;
      for (int r = part; r < nrows; r += NP)
        if (on && mk[r]) mx = fmaxf(mx, sp[r * GP + g]);
#pragma unroll
      for (int off = 16; off >= GMAX; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane < GMAX) s_rmax[warp][g] = mx;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_rmax[w][g]);
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = part; r < TL; r += NP) {
        if (!on) break;
        const float p = r < nrows && mk[r] ? expf(sp[r * GP + g] - m_new) : 0.f;
        sp[r * GP + g] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off >= GMAX; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane < GMAX) s_rsum[warp][g] = sum;
      __syncthreads();
      if (on && part == 0) {
        float l_tile = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) l_tile += s_rsum[w][g];
        const float alpha = expf(m_old - m_new);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + l_tile;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    if constexpr (D::kTC) {
      // O (16 heads x HD / kWarps columns a warp) += P V: P from sp split
      // into bf16 hi + lo (p to ~16 bits), V's rows as k (ldmatrix.trans).
      const int d0 = warp * (HD / kWarps);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int g = gq + 8 * hh;
        const float al = g < G ? s_alpha[g] : 1.f;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          acc_o[n][2 * hh] *= al;
          acc_o[n][2 * hh + 1] *= al;
        }
      }
#pragma unroll
      for (int kc = 0; kc < TL / 16; ++kc) {
        float pv[4][2];  // A's (head, row) pairs in fragment order
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            pv[f][j] = sp[(kc * 16 + 2 * q4 + j + 8 * (f >> 1)) * GP + gq + 8 * (f & 1)];
        uint32_t hi[4], lo[4];  // pairs, the lower column in the low half
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const uint32_t h0 = bf16_bits(pv[f][0]), h1 = bf16_bits(pv[f][1]);
          hi[f] = h0 | h1 << 16;
          lo[f] = bf16_bits(pv[f][0] - __uint_as_float(h0 << 16)) |
                  bf16_bits(pv[f][1] - __uint_as_float(h1 << 16)) << 16;
        }
#pragma unroll
        for (int dp = 0; dp < NB / 2; ++dp) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, sv + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * HD +
                                    d0 + dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc_o[2 * dp], hi, bf[0], bf[1]);
          mma_bf16(acc_o[2 * dp + 1], hi, bf[2], bf[3]);
          mma_bf16(acc_o[2 * dp], lo, bf[0], bf[1]);
          mma_bf16(acc_o[2 * dp + 1], lo, bf[2], bf[3]);
        }
      }
    } else {
      // p.v: DPT head dims a thread, rows sl, sl + NSL, ...
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float al = s_alpha[g];
#pragma unroll
          for (int j = 0; j < DPT; ++j) acc[g][j] *= al;
        }
      }
      for (int r = sl; r < nrows; r += NSL) {
        float vf[DPT];
        load_vec<T, DPT>(vf, sv + r * HD + col * DPT);
        float p[GMAX];
        if constexpr (GMAX == 1) {
          p[0] = sp[r];
        } else {
#pragma unroll
          for (int g = 0; g < GMAX; g += 4) {
            const float4 u = *reinterpret_cast<const float4*>(sp + r * GP + g);
            p[g] = u.x;
            p[g + 1] = u.y;
            p[g + 2] = u.z;
            p[g + 3] = u.w;
          }
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int j = 0; j < DPT; ++j) acc[g][j] = fmaf(p[g], vf[j], acc[g][j]);
      }
    }
    store_mask(tn, mn);
  }

  // Sum the slices' acc (the ring is free now), then write the output, or
  // this split's partial and, in the last split to arrive, the merge.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // NSL x GMAX x HD
  if constexpr (D::kTC) {
    const int d0 = warp * (HD / kWarps);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int g = gq + 8 * hh;
          if (g < G) red[g * HD + d0 + 8 * n + 2 * q4 + j] = acc_o[n][2 * hh + j];
        }
  } else {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          red[(sl * GMAX + g) * HD + col * DPT + j] = acc[g][j];
      }
    }
  }
  __syncthreads();
  const size_t pbase = (size_t)bh * a.S + split;  // this split's partial
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i - g * HD;
    float o = 0.f;
#pragma unroll
    for (int s = 0; s < NSL; ++s) o += red[(s * GMAX + g) * HD + d];
    if (a.S == 1) {
      if (d < hd)
        static_cast<T*>(a.out)[((size_t)bh * G + g) * hd + d] =
            from_float<T>(o / fmaxf(s_l[g], 1e-30f));
    } else {
      a.part_acc[(pbase * G + g) * HD + d] = o;
    }
  }
  if (a.S == 1) return;
  if (tid < G) {
    a.part_ml[(pbase * G + tid) * 2] = s_m[tid];
    a.part_ml[(pbase * G + tid) * 2 + 1] = s_l[tid];
  }
  __threadfence();  // this split's partial is visible before it arrives
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(a.count + bh, 1);
    s_last = prev == a.S - 1;
    if (s_last) a.count[bh] = 0;  // ready for the next call on this stream
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The merge, in split order: w_s = exp(m_s - max m), out = sum w_s
  // acc_s / sum w_s l_s. Partials are read from L2 (__ldcg): other blocks
  // wrote them.
  float* wgt = red;                       // S x GMAX weights
  float* den = red + kMaxSplits * GMAX;   // GMAX denominators
  const float* pml = a.part_ml + (size_t)bh * a.S * G * 2;
  const float* pacc = a.part_acc + (size_t)bh * a.S * G * HD;
  for (int g = warp; g < G; g += kWarps) {
    float mx = kNeg;
    for (int s = lane; s < a.S; s += 32) mx = fmaxf(mx, __ldcg(pml + (s * G + g) * 2));
    mx = warp_max(mx);
    float dn = 0.f;
    for (int s = lane; s < a.S; s += 32) {
      const float w = expf(__ldcg(pml + (s * G + g) * 2) - mx);
      wgt[s * GMAX + g] = w;
      dn += w * __ldcg(pml + (s * G + g) * 2 + 1);
    }
    dn = warp_sum(dn);
    if (lane == 0) den[g] = dn;
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i - g * HD;
    if (d >= hd) continue;
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < a.S; ++s)
      o = fmaf(wgt[s * GMAX + g], __ldcg(pacc + ((size_t)s * G + g) * HD + d), o);
    static_cast<T*>(a.out)[((size_t)bh * G + g) * hd + d] =
        from_float<T>(o / fmaxf(den[g], 1e-30f));
  }
}

template <typename T, int HD, int GMAX>
int launch(const Args& a, int B, cudaStream_t stream) {
  using D = Decode<T, HD, GMAX>;
  if (a.S > 1 && a.chunk % D::TL != 0) return -1;  // splits are whole tiles
  auto kernel = flash_decode_kernel<T, HD, GMAX>;
  if (D::smem > 48 * 1024 - 8 * 1024) {  // the static arrays count too
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(D::smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<dim3(B * a.KVH, a.S), kThreads, D::smem, stream>>>(a);
  return 0;
}

// Instances for the dense configs the port builds: G = 1 (qwen1.5-0.5b,
// olmo-1b, every reduced config) and G = 16 (llama3-405b), which also
// serves any G in 2..16 with the unused heads zero.
template <typename T, int HD>
int launch_g(const Args& a, int B, cudaStream_t stream) {
  if (a.G == 1) return launch<T, HD, 1>(a, B, stream);
  if (a.G <= 16) return launch<T, HD, 16>(a, B, stream);
  return -1;
}

// The instance of a head dim: the next of 32, 64 and 128 at or above it
// (ops.decode_head_dim).
template <typename T>
int launch_hd(const Args& a, int B, cudaStream_t stream) {
  if (a.hd < 8 || a.hd > 128 || a.hd % 8 != 0) return -1;
  if (a.hd <= 32) return launch_g<T, 32>(a, B, stream);
  if (a.hd <= 64) return launch_g<T, 64>(a, B, stream);
  return launch_g<T, 128>(a, B, stream);
}

}  // namespace

// Returns 0 on success, -1 for a shape or dtype this kernel does not
// take, else the cudaError_t of the launch. dtype: 0 = float32,
// 1 = bfloat16. hd: the head dim, a multiple of 8 in [8, 128], run on
// the instance HD of the next of 32, 64 and 128. S <= kMaxSplits splits
// of `chunk` rows cover [0, L), none empty, `chunk` whole tiles of
// 4096 / HD rows where S > 1; with S > 1, part_ml (B*KVH*S*G*2 floats),
// part_acc (B*KVH*S*G*HD floats, HD the instance's) and count (B*KVH
// ints, all 0; the kernel leaves them 0) are scratch.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* valid, void* out, float* part_ml,
                            float* part_acc, int* count, int B, int L,
                            int KVH, int G, int hd, int S, int chunk,
                            int dtype, float scale, void* stream) {
  if (B < 1 || L < 1 || KVH < 1 || G < 1 || S < 1 || S > kMaxSplits ||
      chunk < 1 || (long)(S - 1) * chunk >= L || (long)S * chunk < L)
    return -1;
  if (S > 1 && (!part_ml || !part_acc || !count)) return -1;
  const Args a{q, k, v, static_cast<const uint8_t*>(valid), out, part_ml,
               part_acc, count, L, KVH, G, S, chunk, hd, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) rc = launch_hd<float>(a, B, s);
  else if (dtype == 1) rc = launch_hd<__nv_bfloat16>(a, B, s);
  else rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
