// Flash attention for Hopper (sm_90a): causal or bidirectional, optionally
// sliding-window self-attention over a full sequence, forward and
// backward.
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
// q, k, v, o and the gradients are read and written in the model's
// layout, q: (B, S, H, hd), k, v: (B, S, KVH, hd), with query head h
// reading KV head h / G. The TPU wrapper repeated K/V G times and
// transposed to (B*H, S, hd); here nothing is copied. Any S >= 1: the
// ragged last tile is masked. Tiles wholly above the diagonal or left of
// the window are skipped.
//
// causal = false is the TPU kernel's causal=False (the encoder's
// bidirectional self-attention, q and k of one length): the forward and
// dQ walk every key tile, not only those up to the query tile's last row,
// the dK/dV kernels walk the query tiles from row 0, not from the key
// tile's first row, and the mask drops j <= i but keeps the window
// (j > i - window), as the TPU kernel's does. The flag is a template
// argument of every kernel (each HD has a causal and a bidirectional
// instance), so the causal instances compile to the code and the bits
// they had before it.
//
// What bounds it on the card: at the training path's shape (B 2, H 16,
// S 512, hd 64, bf16) the forward must move ~8.4 MB (2.5 us at 3.35
// TB/s) for ~1.1 GFLOP of causal products (1.1 us at 989 TFLOP/s bf16),
// the backward ~16.8 MB for ~2.7 GFLOP: bytes bound both, but only a
// kernel whose products run on the tensor cores gets near either. A
// SIMT kernel is bound by its instruction issue: each score costs 8 or
// 16 scalar FMAs and 3 shuffles, and the softmax update runs once per
// (row, key) pair (on an H100, 231.9 us forward and 527 us backward at
// that shape for the SIMT kernels below; PERF.md has both designs'
// times).
//
// bf16 (the training path's dtype) runs on the tensor cores,
// FlashAttention-2's structure with mma.sync:
//  * every product (Q Kᵀ and P V forward; Q Kᵀ, dO Vᵀ, dS K, Pᵀ dO and
//    dSᵀ Q backward) is mma.sync m16n8k16 bf16 with fp32 accumulation,
//    fragments loaded from shared memory by ldmatrix (.trans where the
//    tile's rows are the product's k);
//  * K/V (forward, dQ) and Q/dO/lse/D (dK/dV) tiles stay bf16 in shared
//    memory, staged by 16-byte cp.async into a two-stage ring with zero
//    fill past S, rows padded by 16 bytes so ldmatrix is conflict-free;
//  * the online softmax runs on the accumulator fragments in fp32 (a
//    row's max and sum over the 4 lanes of a quad, 2 shuffles), in log2
//    units (scale * log2 e folded into the scores) so each exponential
//    is one ex2.approx on the special-function unit; p goes from the
//    score registers into the PV A fragment rounded to bf16, as the TPU
//    kernel rounds it, while l sums the fp32 p; masked entries are
//    selected to exactly 0, never left to exp;
//  * the backward rounds P and dS to bf16 as mma operands (the fp32
//    kernels keep dS in fp32); the card tests hold the forward and the
//    backward within 2e-2 / 3e-2 of the plain version.
// These kernels still take several times their byte bound (PERF.md §6):
// wgmma with TMA loads is the next step for them.
//
// fp32 stays on the SIMT kernels below: tensor cores take fp32 only as
// TF32 (10-bit mantissa), which would break the 2e-5 / 1e-4 limits the
// fp32 path is held to, and the reduced LM config's card-vs-CPU check
// (1e-4) runs it.
//
// Head dims: q and k have a head dim hd, v (and so o, dO and dv) its own
// hdv <= hd (MLA: hd 192 = nope 128 + rope 64, hdv 128). Any hd with
// hd % 8 == 0 and 8 <= hd <= 192 runs on the instance of the next HD in
// {32, 64, 128, 192}, and any hdv % 8 == 0 in [8, hd] on the same one: a
// bf16 row is then a whole number of 16-byte chunks. Every kernel reads
// and writes global memory at the true hd and hdv (rows of hd or hdv
// elements, never a column past them); the columns hd .. HD - 1 of q
// and k and hdv .. HD - 1 of v, o and dO are zero-filled in shared
// memory or registers, so they add exactly 0 to every product over a
// head dim (q.k, dO.v, rowsum(dO * O)) and give exactly 0 in the padded
// columns of P V, which are not written, nor are those of dq, dk and dv.
// The PV products still run over HD columns: at MLA's (192, 128) a
// third of that work multiplies zeros. The scale comes from the wrapper
// (1 / sqrt(hd) unless the caller gives one). At hd == hdv == HD nothing
// is padded; chip_smoke.py holds hd 64 and 128 bitwise to the kernels
// before the padding (tests/data/attn_fingerprints_hd64_128.json). The
// fp32 kernels stage 16-row tiles at HD 192 (two 32-row tiles would
// pass the 48 KB of static shared memory).
//
// Built by nvcc into a shared library with a plain C interface and
// called through ctypes (src/repro_torch/kernels/ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;

// ============================================================ fp32: SIMT
//
// A warp splits into 4 groups of 8 lanes. Each lane holds hd/8 of a row's
// dims (d = lane_in_group + 8 e), so a dot product is 8/16 FMAs and 3
// shuffles within the group, and the 4 groups work on 4 different keys
// (or queries) at once. Each group keeps its own online-softmax state;
// the groups are merged with 2 shuffles at the end. Masks are applied by
// selection, never by a branch around a shuffle. Tiles of 32 rows of K/V
// (or Q/dO) are staged in shared memory as fp32, rows padded by 8 floats
// so the 4 groups hit 4 bank ranges.

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;               // lanes per group
constexpr int kGroups = 32 / kGroup;    // groups per warp
// Rows per shared-memory tile: 32, or 16 at HD 192, where two 32-row
// fp32 tiles (51,200 bytes) would pass the 48 KB static limit.
template <int HD>
__host__ __device__ constexpr int simt_tile() {
  return HD > 128 ? 16 : 32;
}
// Query rows a warp (the forward, dQ) and key rows a warp (dK/dV) own.
template <int HD>
__host__ __device__ constexpr int simt_rows_q() {
  return 32 / (HD / 8) > 0 ? 32 / (HD / 8) : 1;
}
template <int HD>
__host__ __device__ constexpr int simt_rows_k() {
  return 16 / (HD / 8) > 0 ? 16 / (HD / 8) : 1;
}
constexpr float kNeg = -1e30f;          // the TPU kernel's mask value

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

// Query row i sees key row j: both in range, inside the window and, when
// causal, j <= i. Without causal the window still bounds j from below
// (the TPU kernel's mask: cols > rows - window), and nothing above.
__device__ __forceinline__ bool visible(int i, int j, int S, int window,
                                        bool causal) {
  return i < S && j < S && (!causal || j <= i) &&
         (window <= 0 || j > i - window);
}

// Stage rows r0 .. r0 + simt_tile<HD>() of head `head` of batch row b of
// a (B, S, NH, hd) fp32 tensor into shared memory as HD columns, zeros
// past S and past hd.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int b,
                                          int r0, int S, int NH, int head,
                                          int hd) {
  constexpr int HDP = HD + 8;
  for (int idx = threadIdx.x; idx < simt_tile<HD>() * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx - r * HD;
    const int row = r0 + r;
    dst[r * HDP + c] = row < S && c < hd
                           ? src[(((size_t)b * S + row) * NH + head) * hd + c]
                           : 0.f;
  }
}

template <int HD>
__device__ __forceinline__ void load_row(float (&dst)[HD / kGroup],
                                         const float* src, int b, int i, int S,
                                         int NH, int head, int t, int hd) {
#pragma unroll
  for (int e = 0; e < HD / kGroup; ++e)
    dst[e] = i < S && t + kGroup * e < hd
                 ? src[(((size_t)b * S + i) * NH + head) * hd + t + kGroup * e]
                 : 0.f;
}

// ----------------------------------------------------------------- forward

// grid (ceil(S / BQ), B * H); each warp owns R query rows.
template <int HD, bool causal>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, int S, int H, int KVH, int window,
                float scale, int hd, int hdv) {
  constexpr int EPL = HD / kGroup;  // dims per lane
  constexpr int R = simt_rows_q<HD>();  // query rows per warp
  constexpr int BQ = kWarps * R;    // query rows per block
  constexpr int HDP = HD + 8;
  constexpr int kTile = simt_tile<HD>();
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
    load_row<HD>(qr[r], q, b, row0 + r, S, H, h, t, hd);
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  // Causal: keys < the block's last row + 1; else every key.
  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int j0 = (kv_lo / kTile) * kTile; j0 < kv_hi; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<HD>(sk, k, b, j0, S, KVH, kvh, hd);
    load_tile<HD>(sv, v, b, j0, S, KVH, kvh, hdv);
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
        const bool ok = visible(row0 + r, j, S, window, causal);
        const float m_new = ok ? fmaxf(m[r], s) : m[r];
        const float alpha = expf(m[r] - m_new);
        const float p = ok ? expf(s - m_new) : 0.f;
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = acc[r][e] * alpha + p * vr[e];
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
      if (g == 0 && i < S && t + kGroup * e < hdv)
        o[(((size_t)b * S + i) * H + h) * hdv + t + kGroup * e] = a * inv;
    }
    if (lane == 0 && i < S)
      lse[((size_t)b * H + h) * S + i] = lt > 0.f ? mt + logf(lt) : kNeg;
  }
}

// ----------------------------------------------------------- backward: dQ

// grid (ceil(S / BQ), B * H). Also writes D_i = rowsum(dO_i * O_i).
template <int HD, bool causal>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ dout, const float* __restrict__ lse,
                   float* __restrict__ dsum, float* __restrict__ dq, int S, int H,
                   int KVH, int window, float scale, int hd, int hdv) {
  constexpr int EPL = HD / kGroup;
  constexpr int R = simt_rows_q<HD>();
  constexpr int BQ = kWarps * R;
  constexpr int HDP = HD + 8;
  constexpr int kTile = simt_tile<HD>();
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
    load_row<HD>(qr[r], q, b, i, S, H, h, t, hd);
    load_row<HD>(dor[r], dout, b, i, S, H, h, t, hdv);
    load_row<HD>(orow, o, b, i, S, H, h, t, hdv);
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

  const int kv_hi = causal ? min(S, q0 + BQ) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int j0 = (kv_lo / kTile) * kTile; j0 < kv_hi; j0 += kTile) {
    __syncthreads();
    load_tile<HD>(sk, k, b, j0, S, KVH, kvh, hd);
    load_tile<HD>(sv, v, b, j0, S, KVH, kvh, hdv);
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
        const bool ok = visible(row0 + r, j, S, window, causal);
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
      if (g == 0 && i < S && t + kGroup * e < hd)
        dq[(((size_t)b * S + i) * H + h) * hd + t + kGroup * e] = a;
    }
  }
}

// ------------------------------------------------------- backward: dK, dV

// grid (ceil(S / BK), B * KVH); each warp owns RK key rows and walks the
// query rows that see them, for each of the G heads of its KV head.
template <int HD, bool causal>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int H, int KVH, int window,
                     float scale, int hd, int hdv) {
  constexpr int EPL = HD / kGroup;
  constexpr int RK = simt_rows_k<HD>();  // key rows per warp: 2 or 1
  constexpr int BK = kWarps * RK;    // key rows per block
  constexpr int HDP = HD + 8;
  constexpr int kTile = simt_tile<HD>();
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
    load_row<HD>(kr[r], k, b, krow0 + r, S, KVH, kvh, t, hd);
    load_row<HD>(vr[r], v, b, krow0 + r, S, KVH, kvh, t, hdv);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      dka[r][e] = 0.f;
      dva[r][e] = 0.f;
    }
  }

  // Query rows that see a key of this block: i >= k0 (causal only) and
  // i < k_last + window (window).
  const int i_lo = causal ? (k0 / kTile) * kTile : 0;
  const int i_hi = window > 0 ? min(S, k0 + BK - 1 + window) : S;
  for (int hh = 0; hh < G; ++hh) {
    const int h = kvh * G + hh;
    for (int i0 = i_lo; i0 < i_hi; i0 += kTile) {
      __syncthreads();
      load_tile<HD>(sq, q, b, i0, S, H, h, hd);
      load_tile<HD>(sdo, dout, b, i0, S, H, h, hdv);
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
          const bool ok = visible(i, krow0 + r, S, window, causal);
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
      const size_t row = ((size_t)b * S + j) * KVH + kvh;
      if (g == 0 && j < S && t + kGroup * e < hd)
        dk[row * hd + t + kGroup * e] = a;
      if (g == 0 && j < S && t + kGroup * e < hdv)
        dv[row * hdv + t + kGroup * e] = c;
    }
  }
}

// ====================================================== bf16: tensor cores
//
// A block has 4 warps. The forward and the dQ kernel own 64 query rows of
// one (b, h), 16 per warp, and walk the 64-key tiles those rows see; the
// dK/dV kernel owns 64 key rows of one (b, kvh), 16 per warp, and walks
// the query tiles (64 rows at hd 64, 32 at hd 128) that see them, for
// each of the G query heads of its KV head. Tiles are staged in bf16 by
// cp.async into a two-stage ring: the next tile's copy is in flight
// while the warps multiply the current one.

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kBlk = 64;      // query rows (fwd, dQ) or key rows (dK/dV) a block
constexpr int kKeys = 64;     // keys per tile (fwd, dQ)
constexpr int kPad = 8;       // bf16 elements of padding a shared row (16 bytes)
constexpr size_t kOptInAbove = 48 * 1024;  // dynamic shared memory beyond: opt in
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------- PTX
//
// Copies, ldmatrix and mma.sync are in mma_sm90.cuh.

// 2^x on the special-function unit (flushes denormals to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------- PTX ends here

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows r0 .. r0 + R of head `head` of a (B, S, NH, hd) bf16
// tensor into shared memory as HD columns (row stride HD + kPad), zeros
// past S and past hd.
template <int R, int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int b,
                                           int r0, int S, int NH, int head,
                                           int hd) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < R * kChunks; idx += kTcThreads) {
    const int r = idx / kChunks;
    const int c = idx - r * kChunks;
    const bool ok = r0 + r < S && c * 8 < hd;
    const bf16* g = src + (((size_t)b * S + (ok ? r0 + r : 0)) * NH + head) * hd +
                    (ok ? c * 8 : 0);
    cp_async_16(dst + r * (HD + kPad) + c * 8, g, ok);
  }
}

// Stage entries r0 .. r0 + R of an fp32 row of length S, zeros past S.
template <int R>
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int r0,
                                          int S) {
  for (int r = threadIdx.x; r < R; r += kTcThreads) {
    const bool ok = r0 + r < S;
    cp_async_4(dst + r, src + (ok ? r0 + r : 0), ok);
  }
}

// The A fragment of rows r0 .. r0 + 15, columns c0 .. c0 + 15 of a shared
// tile.
template <int HD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * (HD + kPad) + c0 + (lane >> 4) * 8);
}

// B fragments of two n-blocks whose columns are the tile's rows r0 .. r0
// + 7 and r0 + 8 .. r0 + 15, with the tile's columns c0 .. c0 + 15 as k:
// {b[0], b[1]} and {b[2], b[3]}. For Kᵀ in Q Kᵀ.
template <int HD>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(b, tile + (r0 + (lane & 7) + (lane >> 4) * 8) * (HD + kPad) +
                     c0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n-blocks whose columns are the tile's columns c0 ..
// c0 + 7 and c0 + 8 .. c0 + 15, with the tile's rows r0 .. r0 + 15 as k.
// For V in P V.
template <int HD>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* tile,
                                        int r0, int c0, int lane) {
  ldmatrix_x4_trans(b, tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  (HD + kPad) +
                           c0 + (lane >> 4) * 8);
}

// The A fragment of an fp32 accumulator's columns 16 kc .. 16 kc + 15,
// held in its n-blocks c0 = 2 kc and c1 = 2 kc + 1, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// acc += A (16 x 16 kn, rows r0.. of tile a) * B (16 kn x N, tile b's rows
// as columns): N / 8 n-blocks of D. Q Kᵀ, dO Vᵀ (fwd, dQ) and K Qᵀ,
// V dOᵀ (dK/dV).
template <int HD, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const bf16* ta,
                                        int r0, const bf16* tb, int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    frag_a<HD>(a, ta, r0, kk * 16, lane);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      frag_b<HD>(b, tb, np * 16, kk * 16, lane);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x HD) += P (16 x K, fp32 accumulator in registers, rounded to
// bf16) * tile rows 0 .. K - 1 (K x HD). P V (fwd), dS K (dQ), Pᵀ dO and
// dSᵀ Q (dK/dV).
template <int HD, int K>
__device__ __forceinline__ void mma_pv(float (&acc)[HD / 8][4],
                                       const float (&p)[K / 8][4],
                                       const bf16* tb, int lane) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    uint32_t a[4];
    acc_to_a(a, p[2 * kc], p[2 * kc + 1]);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      frag_bt<HD>(b, tb, kc * 16, dp * 16, lane);
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Query rows w0 .. w0 + 15 against keys j0 .. j0 + N - 1: does any pair
// pass the mask, and do all pairs whose outputs are kept (rows < S) pass?
struct TileMask {
  bool any, full;
};
template <int N>
__device__ __forceinline__ TileMask rows_vs_keys(int w0, int j0, int S,
                                                 int window, bool causal) {
  TileMask t;
  t.any = w0 < S && (!causal || j0 <= w0 + 15) &&
          (window <= 0 || j0 + N - 1 > w0 - window);
  t.full = (!causal || j0 + N - 1 <= w0) && j0 + N <= S &&
           (window <= 0 || j0 > w0 + 15 - window);
  return t;
}

template <int HD>
constexpr size_t fwd_smem() {
  return sizeof(bf16) * (HD + kPad) * (kBlk + 4 * kKeys);  // Q, 2 x (K, V)
}
template <int HD>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (HD + kPad) * (2 * kBlk + 4 * kKeys) +
         sizeof(float) * 2 * kBlk;  // Q, dO, 2 x (K, V), lse, D
}
template <int HD>
__host__ __device__ constexpr int dkdv_rows() {
  return HD <= 64 ? 64 : 32;  // query rows per inner tile: registers at hd 128
}
template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(bf16) * (HD + kPad) * (2 * kBlk + 4 * dkdv_rows<HD>()) +
         sizeof(float) * 4 * dkdv_rows<HD>();  // K, V, 2 x (Q, dO, lse, D)
}

// ------------------------------------------------------- forward (bf16)

// grid (ceil(S / 64), B * H); block x takes query tile nq - 1 - x, so
// the tiles with the most keys start first.
template <int HD, bool causal>
__global__ void __launch_bounds__(kTcThreads)
attn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, int S, int H, int KVH, int window,
                   float scale, int hd, int hdv) {
  constexpr int kStage = kKeys * (HD + kPad);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kBlk * (HD + kPad);
  bf16* sv = sk + 2 * kStage;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlk;
  const int w0 = q0 + warp * 16;  // this warp's first row

  const int kv_hi = causal ? min(S, q0 + kBlk) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / kKeys;
  const int t_hi = (kv_hi + kKeys - 1) / kKeys;

  stage_rows<kBlk, HD>(sq, q, b, q0, S, H, h, hd);
  stage_rows<kKeys, HD>(sk, k, b, t_lo * kKeys, S, KVH, kvh, hd);
  stage_rows<kKeys, HD>(sv, v, b, t_lo * kKeys, S, KVH, kvh, hdv);
  cp_async_commit();

  const float c = scale * kLog2e;  // scores in log2 units
  float acc[HD / 8][4] = {};
  float m[2] = {kNeg, kNeg};       // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};         // this lane's part of the row sums

  for (int it = t_lo; it < t_hi; ++it) {
    const int st = (it - t_lo) & 1;
    if (it + 1 < t_hi) {
      stage_rows<kKeys, HD>(sk + (st ^ 1) * kStage, k, b, (it + 1) * kKeys, S,
                            KVH, kvh, hd);
      stage_rows<kKeys, HD>(sv + (st ^ 1) * kStage, v, b, (it + 1) * kKeys, S,
                            KVH, kvh, hdv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = it * kKeys;
    const TileMask tm = rows_vs_keys<kKeys>(w0, j0, S, window, causal);
    if (tm.any) {
      float s[kKeys / 8][4] = {};
      mma_abt<HD, kKeys>(s, sq, warp * 16, sk + st * kStage, lane);
      // Scale, mask by selection (bit nb * 4 + e of vis), row maxima.
      uint32_t vis = 0xffffffffu;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nb = 0; nb < kKeys / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nb][e] * c;
          if (!tm.full &&
              !visible(w0 + g + 8 * (e >> 1), j0 + nb * 8 + 2 * t + (e & 1), S,
                       window, causal)) {
            vis &= ~(1u << (nb * 4 + e));
            x = kNeg;
          }
          s[nb][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        acc[nb][0] *= alpha[0];
        acc[nb][1] *= alpha[0];
        acc[nb][2] *= alpha[1];
        acc[nb][3] *= alpha[1];
      }
      // p = exp(s - m) where the mask passes, else exactly 0 (a row that
      // sees no key yet has m == kNeg, where exp would give 1). l sums
      // the fp32 p; the PV product takes p rounded to bf16, v's dtype.
#pragma unroll
      for (int nb = 0; nb < kKeys / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (vis >> (nb * 4 + e)) & 1u
                              ? ex2(s[nb][e] - m[e >> 1])
                              : 0.f;
          s[nb][e] = p;
          l[e >> 1] += p;
        }
      }
      mma_pv<HD, kKeys>(acc, s, sv + st * kStage, lane);
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = w0 + g + 8 * r;
    const float lt = quad_sum(l[r]);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    if (i >= S) continue;
    bf16* orow = o + (((size_t)b * S + i) * H + h) * hdv + 2 * t;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      if (nb * 8 < hdv)
        *reinterpret_cast<uint32_t*>(orow + nb * 8) =
            pack_bf16(acc[nb][2 * r] * inv, acc[nb][2 * r + 1] * inv);
    if (t == 0)
      lse[((size_t)b * H + h) * S + i] = lt > 0.f ? m[r] * kLn2 + logf(lt) : kNeg;
  }
}

// --------------------------------------------------- backward: dQ (bf16)

// grid (ceil(S / 64), B * H), heaviest tile first. Also writes
// D_i = rowsum(dO_i * O_i).
template <int HD, bool causal>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ dsum,
                      bf16* __restrict__ dq, int S, int H, int KVH, int window,
                      float scale, int hd, int hdv) {
  constexpr int kStage = kKeys * (HD + kPad);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kBlk * (HD + kPad);
  bf16* sk = sdo + kBlk * (HD + kPad);
  bf16* sv = sk + 2 * kStage;
  float* sl = reinterpret_cast<float*>(sv + 2 * kStage);
  float* sd = sl + kBlk;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlk;
  const int w0 = q0 + warp * 16;
  const size_t bh = (size_t)b * H + h;

  const int kv_hi = causal ? min(S, q0 + kBlk) : S;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = kv_lo / kKeys;
  const int t_hi = (kv_hi + kKeys - 1) / kKeys;

  stage_rows<kBlk, HD>(sq, q, b, q0, S, H, h, hd);
  stage_rows<kBlk, HD>(sdo, dout, b, q0, S, H, h, hdv);
  stage_rows<kKeys, HD>(sk, k, b, t_lo * kKeys, S, KVH, kvh, hd);
  stage_rows<kKeys, HD>(sv, v, b, t_lo * kKeys, S, KVH, kvh, hdv);
  cp_async_commit();

  // D and lse of the block's rows: two threads a row, half a row each.
  {
    const int r = threadIdx.x / 2;
    const int half = threadIdx.x % 2;
    const int i = q0 + r;
    float d = 0.f;
    if (i < S) {
      const size_t off = (((size_t)b * S + i) * H + h) * hdv + half * (HD / 2);
#pragma unroll
      for (int e = 0; e < HD / 2; e += 8) {
        if (half * (HD / 2) + e >= hdv) break;  // the padded columns add 0
        const uint4 xo = *reinterpret_cast<const uint4*>(o + off + e);
        const uint4 xd = *reinterpret_cast<const uint4*>(dout + off + e);
        const bf16* po = reinterpret_cast<const bf16*>(&xo);
        const bf16* pd = reinterpret_cast<const bf16*>(&xd);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          d += __bfloat162float(pd[u]) * __bfloat162float(po[u]);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      sd[r] = d;
      if (i < S) dsum[bh * S + i] = d;
    } else {
      sl[r] = i < S ? lse[bh * S + i] : 0.f;
    }
  }
  __syncthreads();
  const float c = scale * kLog2e;
  float lse2[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = sl[warp * 16 + g + 8 * r] * kLog2e;
    Dr[r] = sd[warp * 16 + g + 8 * r];
  }

  float acc[HD / 8][4] = {};
  for (int it = t_lo; it < t_hi; ++it) {
    const int st = (it - t_lo) & 1;
    if (it + 1 < t_hi) {
      stage_rows<kKeys, HD>(sk + (st ^ 1) * kStage, k, b, (it + 1) * kKeys, S,
                            KVH, kvh, hd);
      stage_rows<kKeys, HD>(sv + (st ^ 1) * kStage, v, b, (it + 1) * kKeys, S,
                            KVH, kvh, hdv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = it * kKeys;
    const TileMask tm = rows_vs_keys<kKeys>(w0, j0, S, window, causal);
    if (tm.any) {
      const bf16* tk = sk + st * kStage;
      float s[kKeys / 8][4] = {};
      float dp[kKeys / 8][4] = {};
      mma_abt<HD, kKeys>(s, sq, warp * 16, tk, lane);
      mma_abt<HD, kKeys>(dp, sdo, warp * 16, sv + st * kStage, lane);
      // dS = P (dP - D), P = exp(s - lse), exactly 0 where masked.
#pragma unroll
      for (int nb = 0; nb < kKeys / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok =
              tm.full || visible(w0 + g + 8 * (e >> 1),
                                 j0 + nb * 8 + 2 * t + (e & 1), S, window,
                                 causal);
          const float p = ok ? ex2(s[nb][e] * c - lse2[e >> 1]) : 0.f;
          s[nb][e] = p * (dp[nb][e] - Dr[e >> 1]);
        }
      }
      mma_pv<HD, kKeys>(acc, s, tk, lane);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = w0 + g + 8 * r;
    if (i >= S) continue;
    bf16* row = dq + (((size_t)b * S + i) * H + h) * hd + 2 * t;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      if (nb * 8 < hd)
        *reinterpret_cast<uint32_t*>(row + nb * 8) =
            pack_bf16(acc[nb][2 * r] * scale, acc[nb][2 * r + 1] * scale);
  }
}

// ----------------------------------------------- backward: dK, dV (bf16)

// grid (ceil(S / 64), B * KVH). Each warp owns 16 key rows; the block
// walks, for each of the G heads of its KV head in turn, the query tiles
// of N rows that see its keys, summing into one accumulator.
template <int HD, bool causal>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int S, int H, int KVH,
                        int window, float scale, int hd, int hdv) {
  constexpr int N = dkdv_rows<HD>();
  constexpr int kStage = N * (HD + kPad);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kBlk * (HD + kPad);
  bf16* sq = sv + kBlk * (HD + kPad);  // 2 stages each
  bf16* sdo = sq + 2 * kStage;
  float* sl = reinterpret_cast<float*>(sdo + 2 * kStage);
  float* sd = sl + 2 * N;

  const int b = blockIdx.y / KVH;
  const int kvh = blockIdx.y - b * KVH;
  const int G = H / KVH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int k0 = blockIdx.x * kBlk;
  const int w0 = k0 + warp * 16;  // this warp's first key row

  // Query rows that see a key of the block: i >= k0 (causal only) and
  // i < k0 + 63 + window (window).
  const int i_hi = window > 0 ? min(S, k0 + kBlk - 1 + window) : S;
  const int t_lo = causal ? k0 / N : 0;
  const int nt = (i_hi + N - 1) / N - t_lo;  // query tiles a head
  const int total = G * nt;

  auto stage = [&](int n, int st) {
    const int h = kvh * G + n / nt;
    const int i0 = (t_lo + n % nt) * N;
    const size_t bh = (size_t)b * H + h;
    stage_rows<N, HD>(sq + st * kStage, q, b, i0, S, H, h, hd);
    stage_rows<N, HD>(sdo + st * kStage, dout, b, i0, S, H, h, hdv);
    stage_vec<N>(sl + st * N, lse + bh * S, i0, S);
    stage_vec<N>(sd + st * N, dsum + bh * S, i0, S);
  };

  stage_rows<kBlk, HD>(sk, k, b, k0, S, KVH, kvh, hd);
  stage_rows<kBlk, HD>(sv, v, b, k0, S, KVH, kvh, hdv);
  stage(0, 0);
  cp_async_commit();

  const float c = scale * kLog2e;
  float dka[HD / 8][4] = {};
  float dva[HD / 8][4] = {};
  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    if (it + 1 < total) {
      stage(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = (t_lo + it % nt) * N;
    // Keys w0 .. w0 + 15 against queries i0 .. i0 + N - 1.
    const bool any = (!causal || i0 + N - 1 >= w0) && w0 < S &&
                     (window <= 0 || i0 < w0 + 15 + window);
    const bool full = (!causal || i0 >= w0 + 15) && i0 + N <= S &&
                      (window <= 0 || i0 + N - 1 - w0 < window);
    if (any) {
      const bf16* tq = sq + st * kStage;
      const bf16* tdo = sdo + st * kStage;
      const float* tl = sl + st * N;
      const float* td = sd + st * N;
      float s[N / 8][4] = {};   // Sᵀ, then Pᵀ
      float dp[N / 8][4] = {};  // dPᵀ, then dSᵀ
      mma_abt<HD, N>(s, sk, warp * 16, tq, lane);
      mma_abt<HD, N>(dp, sv, warp * 16, tdo, lane);
#pragma unroll
      for (int nb = 0; nb < N / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nb * 8 + 2 * t + (e & 1);
          const bool ok =
              full || visible(i0 + col, w0 + g + 8 * (e >> 1), S, window,
                              causal);
          const float p = ok ? ex2(s[nb][e] * c - tl[col] * kLog2e) : 0.f;
          s[nb][e] = p;
          dp[nb][e] = p * (dp[nb][e] - td[col]);
        }
      }
      mma_pv<HD, N>(dva, s, tdo, lane);
      mma_pv<HD, N>(dka, dp, tq, lane);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = w0 + g + 8 * r;
    if (j >= S) continue;
    const size_t row = ((size_t)b * S + j) * KVH + kvh;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      if (nb * 8 < hd)
        *reinterpret_cast<uint32_t*>(dk + row * hd + 2 * t + nb * 8) =
            pack_bf16(dka[nb][2 * r] * scale, dka[nb][2 * r + 1] * scale);
      if (nb * 8 < hdv)
        *reinterpret_cast<uint32_t*>(dv + row * hdv + 2 * t + nb * 8) =
            pack_bf16(dva[nb][2 * r], dva[nb][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------- launchers

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *out, *lse_out, *dsum, *dq, *dk, *dv;
  int B, S, H, KVH, window;
  bool causal;  // false: every key of the sequence (causal=False)
  int hd;   // q's and k's true head dim, <= the instance's HD
  int hdv;  // v's (and o's) true head dim, <= hd
  float scale;
  cudaStream_t stream;
};

template <int HD, bool C>
void launch_fwd_simt(const Args& a) {
  constexpr int BQ = kWarps * simt_rows_q<HD>();
  dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  attn_fwd_kernel<HD, C><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out),
      static_cast<float*>(a.lse_out), a.S, a.H, a.KVH, a.window, a.scale,
      a.hd, a.hdv);
}

template <int HD, bool C>
int launch_bwd_simt(const Args& a) {
  constexpr int BQ = kWarps * simt_rows_q<HD>();
  constexpr int BK = kWarps * simt_rows_k<HD>();
  dim3 grid_q((a.S + BQ - 1) / BQ, a.B * a.H);
  attn_bwd_dq_kernel<HD, C><<<grid_q, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.o),
      static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<float*>(a.dsum), static_cast<float*>(a.dq), a.S, a.H,
      a.KVH, a.window, a.scale, a.hd, a.hdv);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  dim3 grid_k((a.S + BK - 1) / BK, a.B * a.KVH);
  attn_bwd_dkdv_kernel<HD, C><<<grid_k, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.S, a.H, a.KVH,
      a.window, a.scale, a.hd, a.hdv);
  return static_cast<int>(cudaGetLastError());
}

// Lets `kernel` take `smem` bytes of dynamic shared memory; 0 or the
// cudaError_t of the opt-in.
template <typename Kernel>
int opt_in(Kernel kernel, size_t smem) {
  if (smem <= kOptInAbove) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// cp.async and the tensor-core tiles read 16-byte chunks.
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int HD, bool C>
int launch_fwd_tc(const Args& a) {
  if (!aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
      !aligned16(a.out))
    return -1;
  constexpr size_t smem = fwd_smem<HD>();
  static const int opt = opt_in(attn_fwd_tc_kernel<HD, C>, smem);
  if (opt != 0) return opt;
  dim3 grid((a.S + kBlk - 1) / kBlk, a.B * a.H);
  attn_fwd_tc_kernel<HD, C><<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out),
      static_cast<float*>(a.lse_out), a.S, a.H, a.KVH, a.window, a.scale,
      a.hd, a.hdv);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool C>
int launch_bwd_tc(const Args& a) {
  const void* tensors[] = {a.q, a.k, a.v, a.o, a.dout, a.dq, a.dk, a.dv};
  for (const void* p : tensors)
    if (!aligned16(p)) return -1;
  static const int opt_dq =
      opt_in(attn_bwd_dq_tc_kernel<HD, C>, dq_smem<HD>());
  static const int opt_kv =
      opt_in(attn_bwd_dkdv_tc_kernel<HD, C>, dkdv_smem<HD>());
  if (opt_dq != 0) return opt_dq;
  if (opt_kv != 0) return opt_kv;
  dim3 grid_q((a.S + kBlk - 1) / kBlk, a.B * a.H);
  attn_bwd_dq_tc_kernel<HD, C>
      <<<grid_q, kTcThreads, dq_smem<HD>(), a.stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
          static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
          static_cast<float*>(a.dsum), static_cast<bf16*>(a.dq), a.S, a.H,
          a.KVH, a.window, a.scale, a.hd, a.hdv);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  dim3 grid_k((a.S + kBlk - 1) / kBlk, a.B * a.KVH);
  attn_bwd_dkdv_tc_kernel<HD, C>
      <<<grid_k, kTcThreads, dkdv_smem<HD>(), a.stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
          static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
          static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, a.H,
          a.KVH, a.window, a.scale, a.hd, a.hdv);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool C>
int dispatch_mode(const Args& a, int dtype, bool bwd) {
  if (dtype == 0) {  // fp32: SIMT
    if (bwd) return launch_bwd_simt<HD, C>(a);
    launch_fwd_simt<HD, C>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1)    // bf16: tensor cores
    return bwd ? launch_bwd_tc<HD, C>(a) : launch_fwd_tc<HD, C>(a);
  return -1;
}

template <int HD>
int dispatch(const Args& a, int dtype, bool bwd) {
  return a.causal ? dispatch_mode<HD, true>(a, dtype, bwd)
                  : dispatch_mode<HD, false>(a, dtype, bwd);
}

// The instance of a head dim: the next of 32, 64, 128 and 192 at or
// above q's and k's.
int run(const Args& a, int dtype, bool bwd) {
  if (a.B < 1 || a.S < 1 || a.H < 1 || a.KVH < 1 || a.H % a.KVH != 0)
    return -1;
  if (a.B * a.H > 65535) return -1;  // grid y of the forward and of dQ
  if (a.hd < 8 || a.hd > 192 || a.hd % 8 != 0) return -1;
  if (a.hdv < 8 || a.hdv > a.hd || a.hdv % 8 != 0) return -1;
  if (a.hd <= 32) return dispatch<32>(a, dtype, bwd);
  if (a.hd <= 64) return dispatch<64>(a, dtype, bwd);
  if (a.hd <= 128) return dispatch<128>(a, dtype, bwd);
  return dispatch<192>(a, dtype, bwd);
}

}  // namespace

// Both return 0 on success, -1 for a shape or dtype these kernels do not
// take (or, in bf16, a tensor not starting on 16 bytes), else the
// cudaError_t of a launch. dtype: 0 = float32, 1 = bfloat16. window <= 0
// means no window; causal != 0 masks keys after the query's row, causal
// == 0 lets every row see every key (bidirectional, the encoder's
// self-attention), the window bounding keys from below only.

// q, k: (B, S, H or KVH, hd); v: (B, S, KVH, hdv) -> o (B, S, H, hdv),
// lse (B, H, S) fp32; hd a multiple of 8 in [8, 192], hdv one in
// [8, hd].
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int S, int H, int KVH, int hd, int hdv,
                                   int window, int causal, int dtype,
                                   float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out = o; a.lse_out = lse;
  a.B = B; a.S = S; a.H = H; a.KVH = KVH; a.window = window; a.scale = scale;
  a.causal = causal != 0;
  a.hd = hd;
  a.hdv = hdv;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(a, dtype, false);
}

// The forward's q, k, v, o, lse and dO (the shape of o) -> dq, dk, dv
// (the shapes of q, k, v); dsum is (B, H, S) fp32 scratch for D.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dsum, void* dq, void* dk, void* dv,
                                   int B, int S, int H, int KVH, int hd,
                                   int hdv, int window, int causal,
                                   int dtype, float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lse = lse;
  a.dsum = dsum; a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.S = S; a.H = H; a.KVH = KVH; a.window = window; a.scale = scale;
  a.causal = causal != 0;
  a.hd = hd;
  a.hdv = hdv;
  a.stream = static_cast<cudaStream_t>(stream);
  return run(a, dtype, true);
}
