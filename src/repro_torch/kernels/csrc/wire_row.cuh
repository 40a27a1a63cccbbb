// The per-row wire encode shared by wire_encode.cu and fusion_proj.cu: one
// fusion row z in device memory -> its codec payload row, with or without
// the EF21 epilogue, computed by a team of threads: a whole block of
// kThreads, or one warp (wire_encode.cu a row a warp, several rows a
// block; the fused projection's encode, fusion_proj.cu, a row a warp on
// the rows of its own matmul, which it reads back from an L2-resident
// scratch). Team below.
//
// It computes the four wire schemes of src/repro/kernels/wire_fused.py
// (:133-253):
//
//  * int8_row: per-row absmax scale = max(absmax * inv_qmax, 1e-12)
//    (1 for an all-zero row), q = clip(rint(c / scale), -127, 127);
//    outputs q int8 (rows, d) and scale fp32 (rows, 1).
//  * int4: the same with qmax 7, stored as u = q + 8 and packed two to a
//    byte (low nibble = even column) into q4 uint8 (rows, ceil(d/2)); an
//    odd d packs its missing last column as nibble 8 (q = 0), which is
//    the reference's zero pad column. The pad never reaches memory.
//  * topk: values fp32 and indices int32 (rows, k) in descending |c|,
//    ties by ascending index (lax.top_k's order). That order is total:
//    each element is one 64-bit key (topk_key: the bits of |c|, then the
//    complement of the index), all keys distinct, so an exact sort of
//    the keys ranks the row as the reference does. The team sorts the
//    row's keys, padded with keys below every element's, by a bitonic
//    network held in registers (topk_regs): a block 512, 2048 or 8192
//    keys (2, 8 or 32 a thread), a warp 128 or 512 (4 or 16 a lane);
//    strides within a thread's keys are register swaps, strides within a
//    warp shuffles, and a block's strides across its warps go through
//    shared memory. A warp over a row of more than 512 (the fused encode
//    at large N) sorts in shared memory. It writes the first k; the EF
//    step's z_hat keeps the elements whose key is at least the k-th's.
//  * sketch: w bucket sums of c * sign, each bucket summed by one thread
//    over its features in ascending index order from +0.0 (the order a
//    sequential scatter-add takes; no atomics, so the sum is fixed). The
//    tables come in as inputs: sign (d), inv_counts (w), hash (d), and
//    the bucket lists order (d) / ptr (w + 1) derived from hash.
//
// With EF: c = z + e; the inner encode of c; z_hat, the decode of the
// payload, computed from the row in shared memory without unpacking what
// was written; e' = c - z_hat, clipped per row by
// min(1, max_ratio * ||z|| / max(||e'||, 1e-12)) (codec.py:277-293); e'
// is a second fp32 (rows, d) output.
//
// Numerics. The integer codes must equal the plain version's bitwise on
// the same input, so the arithmetic is written with round-to-nearest
// intrinsics that the compiler cannot contract into FMAs or replace by
// approximations: __fdiv_rn for c / scale, rintf (half to even) for the
// rounding, __fmul_rn for absmax * inv_qmax, q * scale and the clip
// factor, __fadd_rn / __fsub_rn for z + e and c - z_hat. inv_qmax comes
// from the host as float32(1.0 / qmax), the reference's rounding of the
// double. Only the two norms of the EF clip are summed in another order
// than the plain version (a tree in the block), so e' agrees within a
// few ulps, not bitwise; every other output is bitwise. The same row
// gives the same bits, e' included, whichever kernel or team runs it.
//
// The decode side (decode_at, dequant) is the codec's decode of one
// payload element with the codec's roundings: q * scale (__fmul_rn) for
// int8_row and the unpacked int4 nibbles, and (sketch[h_i] *
// inv_counts[h_i]) * sign_i for the sketch. A top-k row decodes by a
// scatter of its (value, index) pairs into a zero row (fusion_proj.cu).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wire {

constexpr int kThreads = 256;
constexpr int kMaxD = 8192;
// Dynamic shared bytes above which a launch needs the opt-in: 48 KB less
// block_reduce's static buffer (the default limit counts both).
constexpr size_t kOptInAbove = 48 * 1024 - sizeof(float) * (kThreads / 32);
enum Scheme { kInt8Row = 0, kInt4 = 1, kTopK = 2, kSketch = 3 };

struct Params {
  int d;
  int n;  // k (topk) or w (sketch)
  float inv_qmax;
  float qmax;
  int clip;
  float max_ratio;
  const float* __restrict__ sign;
  const float* __restrict__ inv_counts;
  const int* __restrict__ hash;
  const int* __restrict__ order;
  const int* __restrict__ ptr;
  void* out0;
  void* out1;
  float* __restrict__ e_out;
};

// Reduction over the block, the same result in every thread. `red` holds
// one value per warp; the leading barrier keeps an earlier reduction's
// readers from seeing it overwritten.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : __fadd_rn(v, o);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kThreads / 32; ++i)
    r = kMax ? fmaxf(r, red[i]) : __fadd_rn(r, red[i]);
  return r;
}

__device__ __forceinline__ float quant(float c, float scale, float qmax) {
  return fminf(fmaxf(rintf(__fdiv_rn(c, scale)), -qmax), qmax);
}

// The least power of two >= d.
__host__ __device__ inline int pow2_at_least(int d) {
  int P = 1;
  while (P < d) P <<= 1;
  return P;
}

// The keys a block team sorts for a top-k row of d: 512, 2048 or 8192
// (2, 8 or 32 a thread), pads included.
__host__ __device__ inline int block_sort_len(int d) {
  return d <= 512 ? 512 : d <= 2048 ? 2048 : 8192;
}

__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) & ~size_t(3); }

// Shared floats the row encode needs beyond the row c itself: top-k's
// sort keys (2 floats each: the block team's exchange, or a warp's whole
// sort where its keys do not fit in registers) or the bucket sums
// (sketch).
__host__ __device__ inline size_t scratch_floats(int scheme, int d, int n) {
  return scheme == kTopK ? 2 * static_cast<size_t>(block_sort_len(d))
                         : scheme == kSketch ? pad4(n) : 0;
}

// Shared floats of one team: the row c (padded to 16 bytes), then the
// scratch at c + pad4(d).
__host__ __device__ inline size_t team_floats(int scheme, int d, int n) {
  return pad4(d) + scratch_floats(scheme, d, n);
}

// Top-k's order as one integer, the larger first: |c| descending (the
// bits of fabsf(c), which order as the floats do for finite values and
// make -0 and +0 one key), then the index ascending. A pad key of 0 is
// below every element's.
__device__ __forceinline__ unsigned long long topk_key(float c, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(fabsf(c))) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned>(i));
}

__device__ __forceinline__ int topk_index(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key));
}

// The threads that encode one row together: the whole block (NT =
// kThreads) or one warp (NT = 32). Team thread t plays the block threads
// v NT + t, v < V: it visits the elements each of them would, in the same
// order, keeps a partial sum for each, and adds the partials in
// block_reduce's tree (each block warp's lanes by the same shuffles, then
// the warps in order). So a row encodes to the same bits, e' included,
// whichever team runs it.
template <int NT>
struct Team {
  static_assert(NT == kThreads || NT == 32, "the block or one warp");
  static constexpr int V = kThreads / NT;  // block threads a team thread plays
  __device__ static int thread() {
    return NT == kThreads ? threadIdx.x : threadIdx.x & 31;
  }
  __device__ static void sync() {
    if constexpr (NT == kThreads) {
      __syncthreads();
    } else {
      __syncwarp();
    }
  }
  // The max or sum over the block threads of part[v] (block thread v NT +
  // t), as block_reduce computes it; the same in every team thread.
  template <bool kMax>
  __device__ static float reduce(const float (&part)[V], float* red) {
    if constexpr (NT == kThreads) {
      return block_reduce<kMax>(part[0], red);
    } else {
      float r = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float x = part[v];
        for (int off = 16; off > 0; off >>= 1) {
          const float o = __shfl_xor_sync(0xffffffffu, x, off);
          x = kMax ? fmaxf(x, o) : __fadd_rn(x, o);
        }
        r = v == 0 ? x : kMax ? fmaxf(r, x) : __fadd_rn(r, x);
      }
      return r;
    }
  }
  // s[0 .. P) in descending order, P a power of two: a bitonic network
  // in shared memory, a team barrier after each pass. The caller's
  // barrier precedes it.
  __device__ static void sort_desc(unsigned long long* s, int P) {
    const int t = thread();
    for (int k = 2; k <= P; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int x = t; x < P / 2; x += NT) {
          const int i = ((x & ~(j - 1)) << 1) | (x & (j - 1));
          const unsigned long long a = s[i], b = s[i + j];
          if ((a < b) == ((i & k) == 0)) {
            s[i] = b;
            s[i + j] = a;
          }
        }
        sync();
      }
  }
};

// The compare-exchange of a bitonic pass: element e's key a against its
// partner's b (element e ^ j), in a run of length kk: the lower element
// of a descending run keeps the larger key.
__device__ __forceinline__ unsigned long long bitonic_keep(
    unsigned long long a, unsigned long long b, int e, int j, int kk) {
  const bool larger = ((e & j) == 0) == ((e & kk) == 0);
  return (a > b) == larger ? a : b;
}

// A team's P = R NT keys in registers, thread t holding elements r NT + t,
// sorted in descending order by a bitonic network: passes of stride j >=
// NT within a thread's registers, j < 32 by warp shuffles, and (block
// team) 32 <= j < NT through shared memory s (P keys). Then thread t holds
// ranks r NT + t.
template <int NT, int R>
__device__ void bitonic_regs(unsigned long long (&key)[R],
                             unsigned long long* s) {
  using T = Team<NT>;
  constexpr int P = R * NT;
  const int t = T::thread();
  for (int kk = 2; kk <= P; kk <<= 1) {
#pragma unroll
    for (int jr = R / 2; jr >= 1; jr >>= 1) {  // j = jr NT >= NT
      if (jr * NT >= kk) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r & jr) continue;
        const int e = r * NT + t;
        const unsigned long long a = key[r], b = key[r | jr];
        key[r] = bitonic_keep(a, b, e, jr * NT, kk);
        key[r | jr] = bitonic_keep(b, a, e | jr * NT, jr * NT, kk);
      }
    }
    for (int j = (kk < NT ? kk : NT) >> 1; j >= 1; j >>= 1) {
      if (NT > 32 && j >= 32) {  // across the block's warps
        T::sync();
#pragma unroll
        for (int r = 0; r < R; ++r) s[r * NT + t] = key[r];
        T::sync();
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int e = r * NT + t;
          key[r] = bitonic_keep(key[r], s[e ^ j], e, j, kk);
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned long long b = __shfl_xor_sync(0xffffffffu, key[r], j);
          key[r] = bitonic_keep(key[r], b, r * NT + t, j, kk);
        }
      }
    }
  }
}

// The first k ranks of sorted keys (bitonic_regs) -> the row's values and
// indices; returns the k-th key, the same in every team thread.
template <int NT, int R>
__device__ unsigned long long topk_write(const unsigned long long (&key)[R],
                                         const float* c, int k,
                                         unsigned long long* s, float* vals,
                                         int* idx) {
  using T = Team<NT>;
  const int t = T::thread();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * NT + t;
    if (e < k) {
      const int i = topk_index(key[r]);
      vals[e] = c[i];
      idx[e] = i;
    }
  }
  T::sync();  // the sort's readers of s are done
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r * NT + t == k - 1) s[0] = key[r];
  T::sync();
  return s[0];
}

// Top-k of one row by a team, all R NT of its keys sorted in registers
// (pads past d have key 0) -> the k-th key.
template <int NT, int R>
__device__ unsigned long long topk_regs(const float* c, int d, int k,
                                        unsigned long long* s, float* vals,
                                        int* idx) {
  const int t = Team<NT>::thread();
  unsigned long long key[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * NT + t;
    key[r] = e < d ? topk_key(c[e], e) : 0ull;
  }
  bitonic_regs<NT, R>(key, s);
  return topk_write<NT, R>(key, c, k, s, vals, idx);
}

// Top-k of a row of at most 512 by one warp, k <= 128, without sorting
// the row: a radix select over the bits of |c|, 8 bits a round from the
// top, narrows the row to its candidates, the elements whose bits so far
// are at least the k-th largest's; once they are at most 128 (most rows
// after two rounds), they alone are sorted (4 keys a lane), and the k-th
// key is theirs, since they hold the row's first k. Each round is a
// histogram of the remaining elements' next digit in shared memory (256
// counters), then a scan of it across the lanes. Returns false, having
// written nothing, where ties leave more than 128 candidates after the
// last round: the caller sorts the whole row. s: 256 counters, then 128
// keys.
__device__ bool topk_warp_select(const float* c, int d, int k,
                                 unsigned long long* s, float* vals, int* idx,
                                 unsigned long long* kth) {
  constexpr int R = 16;  // elements a lane: 512
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  unsigned* hist = reinterpret_cast<unsigned*>(s);
  unsigned long long* cand = s + 128;  // past the 256 counters
  unsigned u[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    u[r] = e < d ? __float_as_uint(fabsf(c[e])) : 0u;
  }
  unsigned mask = 0, prefix = 0;
  int above = 0, ncand = d;  // elements past the prefix; with it
  for (int shift = 24; shift >= 0 && ncand > 128; shift -= 8) {
#pragma unroll
    for (int q = 0; q < 8; ++q) hist[32 * q + lane] = 0;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r * 32 + lane < d && (u[r] & mask) == prefix)
        atomicAdd(hist + ((u[r] >> shift) & 0xFFu), 1u);
    __syncwarp();
    // Lane l scans digits 255 - 8 l down to 248 - 8 l.
    unsigned h[8];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      h[q] = hist[255 - 8 * lane - q];
      sum += h[q];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(full, incl, off);
      if (lane >= off) incl += n;
    }
    const int from = __ffs(__ballot_sync(full, above + incl - sum < k &&
                                                   k <= above + incl)) - 1;
    int digit = 0, past = above + incl - sum, in_digit = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (digit == 0 && past + static_cast<int>(h[q]) >= k) {
        digit = 256 - 8 * lane - q;  // + 1, so that 0 means not yet
        in_digit = h[q];
      } else if (digit == 0) {
        past += h[q];
      }
    }
    digit = __shfl_sync(full, digit, from) - 1;
    above = __shfl_sync(full, past, from);
    ncand = above + __shfl_sync(full, in_digit, from);
    prefix |= static_cast<unsigned>(digit) << shift;
    mask |= 0xFFu << shift;
    __syncwarp();  // the scan's reads are done before the next round
  }
  if (ncand > 128) return false;
  int base = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    const bool in = e < d && (u[r] & mask) >= prefix;
    const unsigned ball = __ballot_sync(full, in);
    if (in) cand[base + __popc(ball & ((1u << lane) - 1))] = topk_key(c[e], e);
    base += __popc(ball);
  }
  __syncwarp();
  unsigned long long key[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = r * 32 + lane;
    key[r] = e < ncand ? cand[e] : 0ull;
  }
  bitonic_regs<32, 4>(key, s);
  *kth = topk_write<32, 4>(key, c, k, s, vals, idx);
  return true;
}

// Top-k of one row by a team -> the k-th key. A block sorts
// block_sort_len(d) keys in registers (topk_regs); a warp 128 of them, or
// up to 512 selects its candidates first (topk_warp_select) or sorts all
// 512, and past 512 it sorts pow2_at_least(d) keys in shared memory
// (Team::sort_desc).
template <int NT>
__device__ unsigned long long topk_row(const float* c, int d, int k,
                                       unsigned long long* s, float* vals,
                                       int* idx) {
  if constexpr (NT == kThreads) {
    if (d <= 512) return topk_regs<NT, 2>(c, d, k, s, vals, idx);
    if (d <= 2048) return topk_regs<NT, 8>(c, d, k, s, vals, idx);
    return topk_regs<NT, 32>(c, d, k, s, vals, idx);
  } else {
    if (d <= 128) return topk_regs<NT, 4>(c, d, k, s, vals, idx);
    if (d <= 512) {
      unsigned long long kth;
      if (k <= 128 && topk_warp_select(c, d, k, s, vals, idx, &kth)) return kth;
      return topk_regs<NT, 16>(c, d, k, s, vals, idx);
    }
    using T = Team<NT>;
    const int P = pow2_at_least(d), t = T::thread();
    for (int i = t; i < P; i += NT) s[i] = i < d ? topk_key(c[i], i) : 0ull;
    T::sync();
    T::sort_desc(s, P);
    for (int r = t; r < k; r += NT) {
      const int i = topk_index(s[r]);
      vals[r] = c[i];
      idx[r] = i;
    }
    return s[k - 1];
  }
}

// Encode row `row` of the output. z (and e with EF) point at the row's d
// inputs in device memory, read through L2 (another block may just have
// written them); c (d floats) and scratch (scratch_floats, on 16 bytes)
// are the team's shared memory. Every thread of the team calls it; it
// starts with a team barrier, so a caller may run it on one row after
// another with the same buffers. red: kThreads / 32 shared floats (the
// block team only).
template <int S, bool EF, int NT = kThreads>
__device__ void encode_row(const Params& p, const float* z, const float* e,
                           float* c, float* scratch, float* red, size_t row) {
  using T = Team<NT>;
  constexpr int V = T::V;
  auto* key = reinterpret_cast<unsigned long long*>(scratch);  // topk: P keys
  float* bucket = scratch;                                      // sketch: w sums
  const int d = p.d;
  const int t = T::thread();
  // f(i, v) for each element i of block thread v NT + t, in its order.
  auto each = [&](auto f) {
#pragma unroll 2
    for (int base = 0; base < d; base += kThreads) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int i = base + v * NT + t;
        if (i < d) f(i, v);
      }
    }
  };
  T::sync();  // earlier readers of c and scratch are done

  // c = z (+ e): two passes' loads are issued before their stores, so a
  // team thread has 2 V of them in flight, not one. Without EF the row's
  // absmax (int8_row, int4) is taken on the way, a max being exact in any
  // order; with EF that costs the warp team more than the pass over c it
  // saves (measured).
  constexpr bool kRows = S == kInt8Row || S == kInt4;
  float zsq[V], am[V];
#pragma unroll
  for (int v = 0; v < V; ++v) zsq[v] = am[v] = 0.f;
  for (int base = 0; base < d; base += 2 * kThreads) {
    float zv[2][V], ev[2][V];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int i = base + u * kThreads + v * NT + t;
        zv[u][v] = i < d ? __ldcg(z + i) : 0.f;
        ev[u][v] = EF && i < d ? __ldcg(e + i) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int i = base + u * kThreads + v * NT + t;
        if (i >= d) continue;
        float ci = zv[u][v];
        if (EF) {
          ci = __fadd_rn(zv[u][v], ev[u][v]);
          zsq[v] = __fadd_rn(zsq[v], __fmul_rn(zv[u][v], zv[u][v]));
        }
        if (kRows && !EF) am[v] = fmaxf(am[v], fabsf(ci));
        c[i] = ci;
      }
  }
  T::sync();

  float scale = 1.f;
  unsigned long long kth = 0;  // topk: the k-th key
  if (kRows) {
    if (EF) each([&](int i, int v) { am[v] = fmaxf(am[v], fabsf(c[i])); });
    const float mx = T::template reduce<true>(am, red);
    scale = mx > 0.f ? fmaxf(__fmul_rn(mx, p.inv_qmax), 1e-12f) : 1.f;
    if (t == 0) static_cast<float*>(p.out1)[row] = scale;
    if (S == kInt8Row) {
      int8_t* q = static_cast<int8_t*>(p.out0) + row * d;
#pragma unroll 4
      for (int i = t; i < d; i += NT)
        q[i] = static_cast<int8_t>(static_cast<int>(quant(c[i], scale, p.qmax)));
    } else {
      const int dp = (d + 1) / 2;
      uint8_t* q4 = static_cast<uint8_t*>(p.out0) + row * dp;
#pragma unroll 4
      for (int j = t; j < dp; j += NT) {
        const int lo = static_cast<int>(quant(c[2 * j], scale, p.qmax)) + 8;
        const int hi = 2 * j + 1 < d
            ? static_cast<int>(quant(c[2 * j + 1], scale, p.qmax)) + 8 : 8;
        q4[j] = static_cast<uint8_t>(lo | (hi << 4));
      }
    }
  } else if (S == kTopK) {
    const int k = p.n;
    kth = topk_row<NT>(c, d, k, key, static_cast<float*>(p.out0) + row * k,
                       static_cast<int*>(p.out1) + row * k);
  } else {  // kSketch
    const int w = p.n;
    float* sk = static_cast<float*>(p.out0) + row * w;
    for (int b = t; b < w; b += NT) {
      float acc = 0.f;
      for (int j = p.ptr[b]; j < p.ptr[b + 1]; ++j) {
        const int i = p.order[j];
        acc = __fadd_rn(acc, __fmul_rn(c[i], p.sign[i]));
      }
      bucket[b] = acc;
      sk[b] = acc;
    }
  }
  if (!EF) return;
  T::sync();  // bucket sums visible to every team thread

  // z_hat_i: the decode of element i, from the row and the scheme state.
  auto zhat = [&](int i) -> float {
    if constexpr (kRows) {
      return __fmul_rn(quant(c[i], scale, p.qmax), scale);
    } else if constexpr (S == kTopK) {
      return topk_key(c[i], i) >= kth ? c[i] : 0.f;
    } else {
      const int b = p.hash[i];
      return __fmul_rn(__fmul_rn(bucket[b], p.inv_counts[b]), p.sign[i]);
    }
  };
  float* e_out = p.e_out + row * d;
  float factor = 1.f;
  if (p.clip) {
    float esq[V];
#pragma unroll
    for (int v = 0; v < V; ++v) esq[v] = 0.f;
    each([&](int i, int v) {
      const float ei = __fsub_rn(c[i], zhat(i));
      esq[v] = __fadd_rn(esq[v], __fmul_rn(ei, ei));
    });
    const float zn = sqrtf(T::template reduce<false>(zsq, red));
    const float en = sqrtf(T::template reduce<false>(esq, red));
    factor = fminf(1.f, __fdiv_rn(__fmul_rn(p.max_ratio, zn), fmaxf(en, 1e-12f)));
  }
#pragma unroll 4
  for (int i = t; i < d; i += NT) {
    const float ei = __fsub_rn(c[i], zhat(i));
    e_out[i] = p.clip ? __fmul_rn(ei, factor) : ei;
  }
}

// The codec's dequantisation of an int8_row or int4 code.
__device__ __forceinline__ float dequant(int q, float scale) {
  return __fmul_rn(static_cast<float>(q), scale);
}

// Element i of payload row `row`, decoded with the codec's roundings.
// in0/in1 are the payload leaves in the scheme's order (q/scale,
// q4/scale, sketch).
template <int S>
__device__ __forceinline__ float decode_at(const Params& p, const void* in0,
                                           const void* in1, size_t row,
                                           int i) {
  static_assert(S != kTopK, "a top-k row decodes by a scatter");
  if constexpr (S == kInt8Row) {
    return dequant(__ldg(static_cast<const int8_t*>(in0) + row * p.d + i),
                   __ldg(static_cast<const float*>(in1) + row));
  } else if constexpr (S == kInt4) {
    const int u =
        __ldg(static_cast<const uint8_t*>(in0) + row * ((p.d + 1) / 2) + (i >> 1));
    return dequant(((i & 1) ? (u >> 4) : (u & 0xF)) - 8,
                   __ldg(static_cast<const float*>(in1) + row));
  } else {
    const int b = __ldg(p.hash + i);
    return __fmul_rn(__fmul_rn(__ldg(static_cast<const float*>(in0) + row * p.n + b),
                               __ldg(p.inv_counts + b)),
                     __ldg(p.sign + i));
  }
}

}  // namespace wire
