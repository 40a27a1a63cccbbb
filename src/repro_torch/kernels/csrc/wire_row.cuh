// The per-row wire encode shared by wire_encode.cu and fusion_proj.cu: one
// fusion row z in device memory -> its codec payload row, with or without
// the EF21 epilogue, computed by a team of threads: a whole block of
// kThreads (wire_encode.cu) or one warp (the fused projection's encode,
// fusion_proj.cu, a row a warp on the rows of its own matmul, which it
// reads back from an L2-resident scratch). Team below.
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
//    ties by ascending index (lax.top_k's order). Each element's rank is
//    counted exactly, rank_i = #{j : |c_j| > |c_i| or (|c_j| == |c_i|
//    and j < i)}, and the element is written to slot rank_i if that is
//    below k. O(d^2) compares per row: simple, exact, and cheap at the
//    path's d = 432.
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
// gives the same bits, e' included, whichever kernel runs this code.
//
// The decode side (decode_row) is the codec's decode of one payload row
// with the codec's roundings: q * scale (__fmul_rn) for int8_row and the
// unpacked int4 nibbles, the top-k scatter into a zero row, and
// (sketch[h_i] * inv_counts[h_i]) * sign_i for the sketch.

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

// Shared memory the row encode needs beyond the row c itself: the ranks
// (topk) or the bucket sums (sketch).
__host__ __device__ inline size_t scratch_floats(int scheme, int d, int n) {
  return scheme == kTopK ? d : scheme == kSketch ? n : 0;
}

// The threads that encode one row together: the whole block (NT =
// kThreads, as wire_encode.cu runs it) or one warp (NT = 32, the fused
// projection's encode of a row group, a row a warp). Team thread t plays
// the block threads v NT + t, v < V: it visits the elements each of them
// would, in the same order, keeps a partial sum for each, and adds the
// partials in block_reduce's tree (each block warp's lanes by the same
// shuffles, then the warps in order). So a row encodes to the same bits,
// e' included, whichever team runs it.
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
};

// Encode row `row` of the output. z (and e with EF) point at the row's d
// inputs in device memory, read through L2 (another block may just have
// written them); c (d floats) and scratch (scratch_floats) are the team's
// shared memory. Every thread of the team calls it; it starts with a
// team barrier, so a caller may run it on one row after another with the
// same buffers. red: kThreads / 32 shared floats (the block team only).
template <int S, bool EF, int NT = kThreads>
__device__ void encode_row(const Params& p, const float* z, const float* e,
                           float* c, float* scratch, float* red, size_t row) {
  using T = Team<NT>;
  constexpr int V = T::V;
  int* rank = reinterpret_cast<int*>(scratch);  // topk: d ranks
  float* bucket = scratch;                      // sketch: w sums
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
  // team thread has 2 V of them in flight, not one.
  float zsq[V];
#pragma unroll
  for (int v = 0; v < V; ++v) zsq[v] = 0.f;
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
        c[i] = ci;
      }
  }
  T::sync();

  float scale = 1.f;
  if (S == kInt8Row || S == kInt4) {
    float am[V];
#pragma unroll
    for (int v = 0; v < V; ++v) am[v] = 0.f;
    each([&](int i, int v) { am[v] = fmaxf(am[v], fabsf(c[i])); });
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
    float* vals = static_cast<float*>(p.out0) + row * k;
    int* idx = static_cast<int*>(p.out1) + row * k;
    for (int i = t; i < d; i += NT) {
      const float a = fabsf(c[i]);
      int r = 0;
      for (int j = 0; j < d; ++j) {
        const float b = fabsf(c[j]);
        r += (b > a) || (b == a && j < i);
      }
      rank[i] = r;
      if (r < k) {
        vals[r] = c[i];
        idx[r] = i;
      }
    }
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
  T::sync();  // ranks / bucket sums visible to every team thread

  // z_hat_i: the decode of element i, from the row and the scheme state.
  auto zhat = [&](int i) -> float {
    if constexpr (S == kInt8Row || S == kInt4) {
      return __fmul_rn(quant(c[i], scale, p.qmax), scale);
    } else if constexpr (S == kTopK) {
      return rank[i] < p.n ? c[i] : 0.f;
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

// Decode payload row `row` into dst[i * stride], i < d: the codec's
// decode with its roundings. in0/in1 are the payload leaves in the order
// of the scheme's leaves (q/scale, q4/scale, values/indices, sketch). A
// top-k row is a scatter: the caller zeroes dst and puts a barrier
// between that and this call. One call per row, every thread of the block.
template <int S>
__device__ void decode_row(const Params& p, const void* in0, const void* in1,
                           size_t row, float* dst, int stride) {
  const int d = p.d;
  if (S == kInt8Row) {
    const int8_t* q = static_cast<const int8_t*>(in0) + row * d;
    const float scale = static_cast<const float*>(in1)[row];
    for (int i = threadIdx.x; i < d; i += kThreads)
      dst[i * stride] = __fmul_rn(static_cast<float>(q[i]), scale);
  } else if (S == kInt4) {
    const uint8_t* q4 = static_cast<const uint8_t*>(in0) + row * ((d + 1) / 2);
    const float scale = static_cast<const float*>(in1)[row];
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const int u = q4[i >> 1];
      const int q = ((i & 1) ? (u >> 4) : (u & 0xF)) - 8;
      dst[i * stride] = __fmul_rn(static_cast<float>(q), scale);
    }
  } else if (S == kTopK) {
    const int k = p.n;
    const float* vals = static_cast<const float*>(in0) + row * k;
    const int* idx = static_cast<const int*>(in1) + row * k;
    for (int j = threadIdx.x; j < k; j += kThreads) {
      const int i = idx[j];
      if (i >= 0 && i < d) dst[i * stride] = vals[j];
    }
  } else {  // kSketch
    const float* sk = static_cast<const float*>(in0) + row * p.n;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const int b = p.hash[i];
      dst[i * stride] = __fmul_rn(__fmul_rn(sk[b], p.inv_counts[b]), p.sign[i]);
    }
  }
}

}  // namespace wire
