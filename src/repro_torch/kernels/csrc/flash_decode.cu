// Flash decode for Hopper (sm_90a): one query token per (batch row,
// head) against the KV cache, with a per-row validity mask.
//
// Replaces the TPU kernel flash_decode_pallas
// (src/repro/kernels/flash_attention.py:121, pallas_call at :146). It
// computes the same function: fp32 scores q.k * scale, an online
// softmax over the live cache rows, the fp32 weighted sum of v, divided
// by the softmax denominator at the end; a fully masked row gives zeros.
// It does not carry the TPU grid over block by block:
//
//  * It reads the cache in the model's own layout, k, v: (B, L, KVH,
//    hd), with q: (B, KVH, G, hd) and valid: (B, L) uint8. The TPU
//    wrapper repeated K/V G times and transposed them into (B*H, L, hd)
//    blocks, a copy of the whole cache per layer and token; here one
//    block serves the G query heads that share a KV head, so each K/V
//    byte is read from device memory once.
//  * One block of 4 warps per (b, kv-head). The block walks L in tiles
//    staged in shared memory (16-byte loads); each warp takes every 4th
//    row of a tile and keeps its own running (m, l, acc) in fp32
//    registers, each lane holding hd/32 of the head dims. The warps'
//    states are merged through shared memory at the end and the result
//    is written in q's dtype. The ragged last tile is masked, so any L
//    works (the TPU kernel needed L % 256 == 0).
//  * Masked rows are skipped in the arithmetic: that is exactly the TPU
//    kernel's "score = NEG, p *= mask" arithmetic, without the work.
//    They are still copied into the tile: a tile's K, V and mask loads
//    are issued together, one round trip to memory. Reading the mask
//    first to copy only live rows puts a second dependent round trip in
//    front of every tile, and measured slower at serving shapes, where
//    the kernel is bound by latency, not bytes.
//
// What bounds it on the card: bytes. Per call it must read the live rows
// of K and V once (2 * live rows * KVH * hd elements) and does about 4
// flops per element read, far below the ~295 flops/byte where H100's
// compute would bind.
// This first version is simple and correct; it launches B * KVH blocks,
// which leaves most of the 132 SMs idle at serving widths (64 blocks at
// W = 4, KVH = 16). Splitting L across blocks (flash-decoding) is the
// later fix.
//
// Built by nvcc into a shared library with a plain C interface and
// called through ctypes (src/repro_torch/kernels/ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;  // the TPU kernel's mask value

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// HD: head dim (64 or 128). GMAX: the largest G this instance
// takes (query heads per KV head), a power of two; G <= GMAX at run time.
template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ valid,
                    T* __restrict__ out, int L, int KVH, int G, float scale) {
  constexpr int EPL = HD / 32;                 // head dims per lane
  constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int ROW_VECS = HD / VEC;           // 16-byte loads per cache row
  constexpr int TL_RAW = 16384 / (HD * (int)sizeof(T));
  constexpr int TL = TL_RAW < 8 ? 8 : TL_RAW;  // tile rows: K + V = 32 KB

  // The tiles are declared as uint4 (16-byte aligned, no constructors)
  // and read through T pointers.
  __shared__ uint4 sk_raw[TL * ROW_VECS];
  __shared__ uint4 sv_raw[TL * ROW_VECS];
  __shared__ uint8_t svalid[TL];
  T* sk = reinterpret_cast<T*>(sk_raw);
  T* sv = reinterpret_cast<T*>(sv_raw);
  __shared__ float sm[kWarps];
  __shared__ float sl[kWarps];
  __shared__ float sacc[kWarps * HD];

  const int bh = blockIdx.x;  // b * KVH + h
  const int b = bh / KVH;
  const int h = bh - b * KVH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row_stride = (size_t)KVH * HD;  // elements between cache rows
  const size_t head_off = ((size_t)b * L * KVH + h) * HD;
  const T* kb = k + head_off;
  const T* vb = v + head_off;
  const uint8_t* vmask = valid + (size_t)b * L;

  float qr[GMAX][EPL];
  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      acc[g][i] = 0.f;
      qr[g][i] = g < G ? to_float(q[((size_t)bh * G + g) * HD + lane * EPL + i])
                       : 0.f;
    }
  }

  for (int t0 = 0; t0 < L; t0 += TL) {
    const int rows = min(TL, L - t0);
    for (int i = threadIdx.x; i < rows * ROW_VECS; i += kThreads) {
      const int r = i / ROW_VECS;
      const int c = i - r * ROW_VECS;
      const size_t off = (size_t)(t0 + r) * row_stride + (size_t)c * VEC;
      sk_raw[i] = *reinterpret_cast<const uint4*>(kb + off);
      sv_raw[i] = *reinterpret_cast<const uint4*>(vb + off);
    }
    for (int i = threadIdx.x; i < rows; i += kThreads) svalid[i] = vmask[t0 + i];
    __syncthreads();

    for (int r = warp; r < rows; r += kWarps) {
      if (!svalid[r]) continue;  // uniform across the warp
      float kr[EPL], vr[EPL];
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        kr[i] = to_float(sk[r * HD + lane * EPL + i]);
        vr[i] = to_float(sv[r * HD + lane * EPL + i]);
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) s += qr[g][i] * kr[i];
        s = warp_sum(s) * scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[g][i] = acc[g][i] * alpha + p * vr[i];
        m[g] = m_new;
      }
    }
    __syncthreads();
  }

  // Merge the warps' (m, l, acc) per query head and write the output.
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm[warp] = m[g];
      sl[warp] = l[g];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) sacc[warp * HD + lane * EPL + i] = acc[g][i];
    __syncthreads();
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w]);
    for (int d = threadIdx.x; d < HD; d += kThreads) {
      float denom = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(sm[w] - mx);
        denom += sl[w] * c;
        a += sacc[w * HD + d] * c;
      }
      out[((size_t)bh * G + g) * HD + d] = from_float<T>(a / fmaxf(denom, 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T, int HD, int GMAX>
void launch(const void* q, const void* k, const void* v, const void* valid,
            void* out, int B, int L, int KVH, int G, float scale,
            cudaStream_t stream) {
  flash_decode_kernel<T, HD, GMAX><<<B * KVH, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<T*>(out), L, KVH, G, scale);
}

// Instances for the dense configs the port builds: G = 1 (qwen1.5-0.5b,
// olmo-1b, every reduced config) and G = 16 (llama3-405b), which also
// serves any G in 2..16 with the unused rows skipped.
template <typename T, int HD>
int launch_g(const void* q, const void* k, const void* v, const void* valid,
             void* out, int B, int L, int KVH, int G, float scale,
             cudaStream_t stream) {
  if (G == 1) launch<T, HD, 1>(q, k, v, valid, out, B, L, KVH, G, scale, stream);
  else if (G <= 16) launch<T, HD, 16>(q, k, v, valid, out, B, L, KVH, G, scale, stream);
  else return -1;
  return 0;
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* valid,
              void* out, int B, int L, int KVH, int G, int HD, float scale,
              cudaStream_t stream) {
  switch (HD) {
    case 64: return launch_g<T, 64>(q, k, v, valid, out, B, L, KVH, G, scale, stream);
    case 128: return launch_g<T, 128>(q, k, v, valid, out, B, L, KVH, G, scale, stream);
    default: return -1;
  }
}

}  // namespace

// Returns 0 on success, -1 for a shape or dtype this kernel does not
// take, else the cudaError_t of the launch.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* valid, void* out, int B, int L,
                            int KVH, int G, int HD, int dtype, float scale,
                            void* stream) {
  if (B < 1 || L < 1 || KVH < 1 || G < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) rc = launch_hd<float>(q, k, v, valid, out, B, L, KVH, G, HD, scale, s);
  else if (dtype == 1) rc = launch_hd<__nv_bfloat16>(q, k, v, valid, out, B, L, KVH, G, HD, scale, s);
  else rc = -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
