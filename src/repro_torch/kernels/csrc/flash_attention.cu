// Flash attention for Hopper (sm_90a): causal, optionally sliding-window
// self-attention over a full sequence, forward and backward.
//
// The forward replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:167, pallas_call at :189). It
// computes the same function: fp32 scores q.k * scale under the causal
// (and window) mask, an online softmax with fp32 running (m, l, acc),
// p cast to v's dtype before the PV product, the sum divided by the
// softmax denominator at the end, and exact zeros for a fully masked
// row. It also writes each row's fp32 logsumexp for the backward. The
// JAX package has no backward kernel (jax.grad differentiates its jnp
// path); the backward here is FlashAttention-2's: P is recomputed from
// q, k and the saved logsumexp, D = rowsum(dO * O), and
//   dV_j = sum_i P_ij dO_i,  dS_ij = P_ij (dO_i . v_j - D_i),
//   dK_j = scale * sum_i dS_ij q_i,  dQ_i = scale * sum_j dS_ij k_j.
// It runs as two kernels: one pass over KV tiles per query tile for dQ
// (which also writes D), then one pass over query tiles per KV tile for
// dK and dV, summing the G query heads that share a KV head inside the
// block. No atomics: every output element is summed by one thread in a
// fixed order, so results are deterministic.
//
// Design (simple SIMT; tensor cores, TMA and split-KV are later work):
//  * q, k, v, o and the gradients are read and written in the model's
//    layout, q: (B, S, H, hd), k, v: (B, S, KVH, hd), with query head h
//    reading KV head h / G. The TPU wrapper repeated K/V G times and
//    transposed to (B*H, S, hd); here nothing is copied.
//  * A warp splits into 4 groups of 8 lanes. Each lane holds hd/8 of a
//    row's dims (d = lane_in_group + 8 e), so a dot product is 8/16 FMAs
//    and 3 shuffles within the group, and the 4 groups work on 4
//    different keys (or queries) at once. Each group keeps its own
//    online-softmax state; the groups are merged with 2 shuffles at the
//    end. Masks are applied by selection, never by a branch around a
//    shuffle, so a ragged last tile (any S >= 1) is just masked.
//  * Tiles of 32 rows of K/V (or Q/dO) are staged in shared memory as
//    fp32, rows padded by 8 floats so the 4 groups hit 4 bank ranges.
//    Tiles wholly above the diagonal or left of the window are skipped.
//
// What bounds it on the card: at the training path's shape (B 2, H 16,
// S 512, hd 64, bf16) the forward must move ~8.4 MB (2.5 us at 3.35
// TB/s) for ~1.1 GFLOP of causal products (1.1 us at 989 TFLOP/s bf16),
// the backward ~16.8 MB for ~2.7 GFLOP: bytes bound both. This SIMT
// version is bound by its instruction issue instead (fp32 FMAs and
// shuffles, no tensor cores), far above both; its times are in PERF.md.
//
// Built by nvcc into a shared library with a plain C interface and
// called through ctypes (src/repro_torch/kernels/ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;               // lanes per group
constexpr int kGroups = 32 / kGroup;    // groups per warp
constexpr int kTile = 32;               // rows per shared-memory tile
constexpr float kNeg = -1e30f;          // the TPU kernel's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// Sum over the 8 lanes of a group.
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// Sum / max over the 4 groups (lanes t, t + 8, t + 16, t + 24).
__device__ __forceinline__ float groups_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 16);
  return x;
}
__device__ __forceinline__ float groups_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
  return x;
}

// Query row i sees key row j: causal, inside the window, both in range.
__device__ __forceinline__ bool visible(int i, int j, int S, int window) {
  return i < S && j < S && j <= i && (window <= 0 || j > i - window);
}

// Stage rows r0 .. r0 + kTile of a (B, S, NH, HD) tensor's head `head`
// of batch row b into shared memory as fp32, zeros past S.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int r0, int S, int NH, int head) {
  constexpr int HDP = HD + 8;
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx - r * HD;
    const int row = r0 + r;
    dst[r * HDP + c] =
        row < S ? to_float(src[(((size_t)b * S + row) * NH + head) * HD + c])
                : 0.f;
  }
}

template <typename T, int HD>
__device__ __forceinline__ void load_row(float (&dst)[HD / kGroup],
                                         const T* src, int b, int i, int S,
                                         int NH, int head, int t) {
#pragma unroll
  for (int e = 0; e < HD / kGroup; ++e)
    dst[e] = i < S ? to_float(src[(((size_t)b * S + i) * NH + head) * HD +
                                  t + kGroup * e])
                   : 0.f;
}

// ----------------------------------------------------------------- forward

// grid (ceil(S / BQ), B * H); each warp owns R query rows.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int S, int H, int KVH, int window,
                float scale) {
  constexpr int EPL = HD / kGroup;  // dims per lane
  constexpr int R = 32 / EPL;       // query rows per warp
  constexpr int BQ = kWarps * R;    // query rows per block
  constexpr int HDP = HD + 8;
  __shared__ float sk[kTile * HDP];
  __shared__ float sv[kTile * HDP];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / kGroup;
  const int t = lane % kGroup;
  const int q0 = blockIdx.x * BQ;
  const int row0 = q0 + warp * R;

  float qr[R][EPL], acc[R][EPL], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    load_row<T, HD>(qr[r], q, b, row0 + r, S, H, h, t);
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const int kv_hi = min(S, q0 + BQ);  // causal: keys < the block's last row + 1
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int j0 = (kv_lo / kTile) * kTile; j0 < kv_hi; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<T, HD>(sk, k, b, j0, S, KVH, kvh);
    load_tile<T, HD>(sv, v, b, j0, S, KVH, kvh);
    __syncthreads();
    for (int jj = g; jj < kTile; jj += kGroups) {
      const int j = j0 + jj;
      float kr[EPL], vr[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[e] = sk[jj * HDP + t + kGroup * e];
        vr[e] = sv[jj * HDP + t + kGroup * e];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s += qr[r][e] * kr[e];
        s = group_sum(s) * scale;
        const bool ok = visible(row0 + r, j, S, window);
        const float m_new = ok ? fmaxf(m[r], s) : m[r];
        const float alpha = expf(m[r] - m_new);
        const float p = ok ? expf(s - m_new) : 0.f;
        const float pv = to_float(from_float<T>(p));  // p in v's dtype
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = acc[r][e] * alpha + pv * vr[e];
        m[r] = m_new;
      }
    }
  }

  // Merge the 4 groups' (m, l, acc) and write the row.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    const float mt = groups_max(m[r]);
    const float c = expf(m[r] - mt);
    const float lt = groups_sum(l[r] * c);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const float a = groups_sum(acc[r][e] * c);
      if (g == 0 && i < S)
        o[(((size_t)b * S + i) * H + h) * HD + t + kGroup * e] =
            from_float<T>(a * inv);
    }
    if (lane == 0 && i < S)
      lse[((size_t)b * H + h) * S + i] = lt > 0.f ? mt + logf(lt) : kNeg;
  }
}

// ----------------------------------------------------------- backward: dQ

// grid (ceil(S / BQ), B * H). Also writes D_i = rowsum(dO_i * O_i).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ o,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   float* __restrict__ dsum, T* __restrict__ dq, int S, int H,
                   int KVH, int window, float scale) {
  constexpr int EPL = HD / kGroup;
  constexpr int R = 32 / EPL;
  constexpr int BQ = kWarps * R;
  constexpr int HDP = HD + 8;
  __shared__ float sk[kTile * HDP];
  __shared__ float sv[kTile * HDP];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / kGroup;
  const int t = lane % kGroup;
  const int q0 = blockIdx.x * BQ;
  const int row0 = q0 + warp * R;

  float qr[R][EPL], dor[R][EPL], dqa[R][EPL], lr[R], Dr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    float orow[EPL];
    load_row<T, HD>(qr[r], q, b, i, S, H, h, t);
    load_row<T, HD>(dor[r], dout, b, i, S, H, h, t);
    load_row<T, HD>(orow, o, b, i, S, H, h, t);
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      d += dor[r][e] * orow[e];
      dqa[r][e] = 0.f;
    }
    Dr[r] = group_sum(d);
    lr[r] = i < S ? lse[((size_t)b * H + h) * S + i] : 0.f;
    if (lane == 0 && i < S) dsum[((size_t)b * H + h) * S + i] = Dr[r];
  }

  const int kv_hi = min(S, q0 + BQ);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int j0 = (kv_lo / kTile) * kTile; j0 < kv_hi; j0 += kTile) {
    __syncthreads();
    load_tile<T, HD>(sk, k, b, j0, S, KVH, kvh);
    load_tile<T, HD>(sv, v, b, j0, S, KVH, kvh);
    __syncthreads();
    for (int jj = g; jj < kTile; jj += kGroups) {
      const int j = j0 + jj;
      float kr[EPL], vr[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[e] = sk[jj * HDP + t + kGroup * e];
        vr[e] = sv[jj * HDP + t + kGroup * e];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          s += qr[r][e] * kr[e];
          dp += dor[r][e] * vr[e];
        }
        s = group_sum(s) * scale;
        dp = group_sum(dp);
        const bool ok = visible(row0 + r, j, S, window);
        const float p = ok ? expf(s - lr[r]) : 0.f;
        const float ds = p * (dp - Dr[r]);
#pragma unroll
        for (int e = 0; e < EPL; ++e) dqa[r][e] += ds * kr[e];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const float a = groups_sum(dqa[r][e]) * scale;
      if (g == 0 && i < S)
        dq[(((size_t)b * S + i) * H + h) * HD + t + kGroup * e] = from_float<T>(a);
    }
  }
}

// ------------------------------------------------------- backward: dK, dV

// grid (ceil(S / BK), B * KVH); each warp owns RK key rows and walks the
// query rows that see them, for each of the G heads of its KV head.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int KVH, int window,
                     float scale) {
  constexpr int EPL = HD / kGroup;
  constexpr int RK = 16 / EPL;       // key rows per warp: 2 or 1
  constexpr int BK = kWarps * RK;    // key rows per block
  constexpr int HDP = HD + 8;
  __shared__ float sq[kTile * HDP];
  __shared__ float sdo[kTile * HDP];
  __shared__ float slse[kTile];
  __shared__ float sD[kTile];

  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y - b * KVH;
  const int G = H / KVH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / kGroup;
  const int t = lane % kGroup;
  const int k0 = blockIdx.x * BK;
  const int krow0 = k0 + warp * RK;

  float kr[RK][EPL], vr[RK][EPL], dka[RK][EPL], dva[RK][EPL];
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    load_row<T, HD>(kr[r], k, b, krow0 + r, S, KVH, kvh, t);
    load_row<T, HD>(vr[r], v, b, krow0 + r, S, KVH, kvh, t);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      dka[r][e] = 0.f;
      dva[r][e] = 0.f;
    }
  }

  // Query rows that see a key of this block: i >= k0 (causal) and
  // i < k_last + window (window).
  const int i_hi = window > 0 ? min(S, k0 + BK - 1 + window) : S;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    for (int i0 = (k0 / kTile) * kTile; i0 < i_hi; i0 += kTile) {
      __syncthreads();
      load_tile<T, HD>(sq, q, b, i0, S, H, h);
      load_tile<T, HD>(sdo, dout, b, i0, S, H, h);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const int i = i0 + r;
        slse[r] = i < S ? lse[((size_t)b * H + h) * S + i] : 0.f;
        sD[r] = i < S ? dsum[((size_t)b * H + h) * S + i] : 0.f;
      }
      __syncthreads();
      for (int ii = g; ii < kTile; ii += kGroups) {
        const int i = i0 + ii;
        float qi[EPL], doi[EPL];
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          qi[e] = sq[ii * HDP + t + kGroup * e];
          doi[e] = sdo[ii * HDP + t + kGroup * e];
        }
        const float lse_i = slse[ii];
        const float D_i = sD[ii];
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            s += qi[e] * kr[r][e];
            dp += doi[e] * vr[r][e];
          }
          s = group_sum(s) * scale;
          dp = group_sum(dp);
          const bool ok = visible(i, krow0 + r, S, window);
          const float p = ok ? expf(s - lse_i) : 0.f;
          const float ds = p * (dp - D_i);
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            dva[r][e] += p * doi[e];
            dka[r][e] += ds * qi[e];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int j = krow0 + r;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const float a = groups_sum(dka[r][e]) * scale;
      const float c = groups_sum(dva[r][e]);
      if (g == 0 && j < S) {
        const size_t off = (((size_t)b * S + j) * KVH + kvh) * HD + t + kGroup * e;
        dk[off] = from_float<T>(a);
        dv[off] = from_float<T>(c);
      }
    }
  }
}

// ------------------------------------------------------------- launchers

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *out, *lse_out, *dsum, *dq, *dk, *dv;
  int B, S, H, KVH, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
void launch_fwd(const Args& a) {
  constexpr int BQ = kWarps * (32 / (HD / kGroup));
  dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  attn_fwd_kernel<T, HD><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out),
      static_cast<float*>(a.lse_out), a.S, a.H, a.KVH, a.window, a.scale);
}

template <typename T, int HD>
int launch_bwd(const Args& a) {
  constexpr int BQ = kWarps * (32 / (HD / kGroup));
  constexpr int BK = kWarps * (16 / (HD / kGroup));
  dim3 grid_q((a.S + BQ - 1) / BQ, a.B * a.H);
  attn_bwd_dq_kernel<T, HD><<<grid_q, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.dsum), static_cast<T*>(a.dq), a.S, a.H, a.KVH,
      a.window, a.scale);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  dim3 grid_k((a.S + BK - 1) / BK, a.B * a.KVH);
  attn_bwd_dkdv_kernel<T, HD><<<grid_k, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.H, a.KVH,
      a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch(const Args& a, int dtype, bool bwd) {
  if (dtype == 0) {
    if (bwd) return launch_bwd<float, HD>(a);
    launch_fwd<float, HD>(a);
  } else if (dtype == 1) {
    if (bwd) return launch_bwd<__nv_bfloat16, HD>(a);
    launch_fwd<__nv_bfloat16, HD>(a);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

int run(const Args& a, int HD, int dtype, bool bwd) {
  if (a.B < 1 || a.S < 1 || a.H < 1 || a.KVH < 1 || a.H % a.KVH != 0)
    return -1;
  if (a.B * (bwd ? a.KVH : a.H) > 65535) return -1;
  switch (HD) {
    case 64: return dispatch<64>(a, dtype, bwd);
    case 128: return dispatch<128>(a, dtype, bwd);
    default: return -1;
  }
}

}  // namespace

// Both return 0 on success, -1 for a shape or dtype these kernels do not
// take, else the cudaError_t of a launch. dtype: 0 = float32,
// 1 = bfloat16. window <= 0 means global causal attention.

// q: (B, S, H, HD); k, v: (B, S, KVH, HD) -> o (B, S, H, HD),
// lse (B, H, S) fp32.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int S, int H, int KVH, int HD, int window,
                                   int dtype, float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out = o; a.lse_out = lse;
  a.B = B; a.S = S; a.H = H; a.KVH = KVH; a.window = window; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(a, HD, dtype, false);
}

// The forward's q, k, v, o, lse and dO (the shape of o) -> dq, dk, dv
// (the shapes of q, k, v); dsum is (B, H, S) fp32 scratch for D.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dsum, void* dq, void* dk, void* dv,
                                   int B, int S, int H, int KVH, int HD,
                                   int window, int dtype, float scale,
                                   void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lse = lse;
  a.dsum = dsum; a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.S = S; a.H = H; a.KVH = KVH; a.window = window; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(a, HD, dtype, true);
}
