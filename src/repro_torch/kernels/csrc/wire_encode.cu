// Wire encode for Hopper (sm_90a): one fp32 (rows, d) block of fusion
// outputs -> its codec payload, in one launch, with or without the EF21
// epilogue.
//
// Replaces the TPU kernels wire_encode and wire_encode_ef
// (src/repro/kernels/wire_fused.py:370 and :389, through _encode_call /
// _encode_kernel, pallas_call at :347). It computes the same functions,
// for the four wire schemes of wire_fused.py:133-253:
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
// With EF (wire_encode_ef): c = z + e; the inner encode of c; z_hat, the
// decode of the payload, computed from the row in shared memory without
// unpacking what was written; e' = c - z_hat, clipped per row by
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
// few ulps, not bitwise; every other output is bitwise.
//
// Layout. One block of 256 threads per row, the whole row of c in shared
// memory (d <= 8192 floats, MAX_FUSED_D of the reference); topk keeps
// the ranks and sketch the bucket sums beside it. The TPU kernel's row
// blocks of 256 rows and zero-padded row counts are gone: a grid of
// `rows` blocks covers any row count.
//
// What bounds it on the card: bytes (each z, e element is read once and
// each payload and e' element written once, a few flops each) at large
// row counts; at the IFL path's shape, (32, 432) per client per round,
// 32 blocks do ~70-170 KB of traffic and the launch latency dominates.
// This first version is simple and right, not tuned.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 8192;
enum Scheme { kInt8Row = 0, kInt4 = 1, kTopK = 2, kSketch = 3 };

struct Params {
  const float* __restrict__ z;
  const float* __restrict__ e;
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

template <int S, bool EF>
__global__ void __launch_bounds__(kThreads)
wire_encode_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32];
  float* c = smem;                                       // d: the row c
  int* rank = reinterpret_cast<int*>(smem + p.d);        // topk: d ranks
  float* bucket = smem + p.d;                            // sketch: w sums
  const int d = p.d;
  const size_t row = blockIdx.x;
  const float* z = p.z + row * d;

  float zsq = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float zi = z[i];
    float ci = zi;
    if (EF) {
      ci = __fadd_rn(zi, p.e[row * d + i]);
      zsq = __fadd_rn(zsq, __fmul_rn(zi, zi));
    }
    c[i] = ci;
  }
  __syncthreads();

  float scale = 1.f;
  if (S == kInt8Row || S == kInt4) {
    float am = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) am = fmaxf(am, fabsf(c[i]));
    am = block_reduce<true>(am, red);
    scale = am > 0.f ? fmaxf(__fmul_rn(am, p.inv_qmax), 1e-12f) : 1.f;
    if (threadIdx.x == 0) static_cast<float*>(p.out1)[row] = scale;
    if (S == kInt8Row) {
      int8_t* q = static_cast<int8_t*>(p.out0) + row * d;
      for (int i = threadIdx.x; i < d; i += kThreads)
        q[i] = static_cast<int8_t>(static_cast<int>(quant(c[i], scale, p.qmax)));
    } else {
      const int dp = (d + 1) / 2;
      uint8_t* q4 = static_cast<uint8_t*>(p.out0) + row * dp;
      for (int j = threadIdx.x; j < dp; j += kThreads) {
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
    for (int i = threadIdx.x; i < d; i += kThreads) {
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
    for (int b = threadIdx.x; b < w; b += kThreads) {
      float acc = 0.f;
      for (int t = p.ptr[b]; t < p.ptr[b + 1]; ++t) {
        const int i = p.order[t];
        acc = __fadd_rn(acc, __fmul_rn(c[i], p.sign[i]));
      }
      bucket[b] = acc;
      sk[b] = acc;
    }
  }
  if (!EF) return;
  __syncthreads();  // ranks / bucket sums visible to every thread

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
    float esq = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float ei = __fsub_rn(c[i], zhat(i));
      esq = __fadd_rn(esq, __fmul_rn(ei, ei));
    }
    const float zn = sqrtf(block_reduce<false>(zsq, red));
    const float en = sqrtf(block_reduce<false>(esq, red));
    factor = fminf(1.f, __fdiv_rn(__fmul_rn(p.max_ratio, zn), fmaxf(en, 1e-12f)));
  }
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float ei = __fsub_rn(c[i], zhat(i));
    e_out[i] = p.clip ? __fmul_rn(ei, factor) : ei;
  }
}

template <int S, bool EF>
int launch(const Params& p, int rows, cudaStream_t stream) {
  size_t smem = sizeof(float) * p.d;
  if (S == kTopK) smem += sizeof(int) * p.d;
  if (S == kSketch) smem += sizeof(float) * p.n;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        wire_encode_kernel<S, EF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  wire_encode_kernel<S, EF><<<rows, kThreads, smem, stream>>>(p);
  return 0;
}

template <bool EF>
int launch_scheme(int scheme, const Params& p, int rows, cudaStream_t s) {
  switch (scheme) {
    case kInt8Row: return launch<kInt8Row, EF>(p, rows, s);
    case kInt4: return launch<kInt4, EF>(p, rows, s);
    case kTopK: return launch<kTopK, EF>(p, rows, s);
    case kSketch: return launch<kSketch, EF>(p, rows, s);
    default: return -1;
  }
}

}  // namespace

// Returns 0 on success, -1 for a scheme or shape this kernel does not
// take, else the cudaError_t of the launch. scheme: 0 int8_row, 1 int4,
// 2 topk, 3 sketch. ef != 0 runs the EF21 epilogue (e and e_out needed).
// n is k (topk) or w (sketch). The sketch tables may be null otherwise.
extern "C" int wire_encode(int scheme, int ef, const float* z, const float* e,
                           int rows, int d, int n, float inv_qmax, float qmax,
                           int clip, float max_ratio, const float* sign,
                           const float* inv_counts, const int* hash,
                           const int* order, const int* ptr, void* out0,
                           void* out1, float* e_out, void* stream) {
  if (rows < 1 || d < 1 || d > kMaxD) return -1;
  if ((scheme == kTopK || scheme == kSketch) && (n < 1 || n > d)) return -1;
  if (scheme == kSketch && (!sign || !inv_counts || !hash || !order || !ptr))
    return -1;
  if (ef && (!e || !e_out)) return -1;
  Params p{z, e, d, n, inv_qmax, qmax, clip, max_ratio, sign, inv_counts,
           hash, order, ptr, out0, out1, e_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = ef ? launch_scheme<true>(scheme, p, rows, s)
                    : launch_scheme<false>(scheme, p, rows, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
