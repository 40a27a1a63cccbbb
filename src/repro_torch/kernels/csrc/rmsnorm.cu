// RMSNorm over the last dim for Hopper (sm_90a): for each row of an
// (M, D) input, y = (x * rsqrt(sum(x^2) / D + eps)) * scale, all in fp32,
// in that order, with one rounding to the output type at the end.
//
// Replaces the TPU kernel rmsnorm_pallas (src/repro/kernels/rmsnorm.py:25,
// pallas_call at :31; arithmetic at :18-22, the jnp oracle
// src/repro/kernels/ref.py:121-125). x is fp32 or bf16, scale fp32 or
// bf16 independently of x, and y takes x's type. The TPU wrapper pads M
// to 256-row blocks (src/repro/kernels/ops.py:163-166); here a grid of
// ceil(M / rows-per-block) blocks takes any M >= 1 and any D >= 1.
//
// What bounds it on the card: bytes. Each element is read, squared and
// summed, then read again, scaled and written: 3 flops and 2 element
// moves, far below Hopper's ~20 fp32 flops per byte. The design keeps
// the one read and one write of device memory the function needs:
//
//  * a row of D <= 1024 goes to one warp (8 rows per 256-thread block),
//    a longer row to the whole block, so a row's sum of squares is a
//    warp-shuffle tree, or shuffle trees joined through shared memory;
//  * a row whose x and y start on 16 bytes is read and written in 16-byte
//    vectors (4 fp32 or 8 bf16), its last D % V elements one by one; an
//    unaligned row (D * sizeof(x) not a multiple of 16) goes element by
//    element;
//  * the second pass re-reads the row the same block just read, from L1
//    or L2 rather than device memory (a 16 KB row of the (8192, 4096)
//    fp32 case, ~8 rows resident per SM).
//
// Sums are taken in another order than the plain version's (a tree over
// threads, not PyTorch's CPU reduction), so fp32 outputs agree within a
// few ulps, not bitwise. This first version is simple and right, not
// tuned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpRowMaxD = 1024;  // rows up to this length: a warp each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The sum of v over the TPR threads of a row, in every one of them.
template <int TPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (TPR == 32) return v;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;
}

// TPR threads per row: 32 (a warp) or kThreads (the block).
template <typename TX, typename TS, int TPR>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ s,
               TX* __restrict__ y, long long rows, int d, float eps) {
  constexpr int V = 16 / sizeof(TX);  // elements in 16 bytes
  constexpr int kRowsPerBlock = kThreads / TPR;
  __shared__ float red[kThreads / 32];
  const int lane = threadIdx.x % TPR;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / TPR;
  // A warp past the last row has nothing to do; with TPR == kThreads the
  // grid has exactly one block per row, so no thread of a block that
  // reaches __syncthreads() leaves early.
  if (row >= rows) return;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(yr)) &
       15) == 0;
  const int nvec = vec ? d / V : 0;

  float ss = 0.0f;
  for (int i = lane; i < nvec; i += TPR) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
    const TX* v = reinterpret_cast<const TX*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f(v[j]);
      ss += f * f;
    }
  }
  for (int i = nvec * V + lane; i < d; i += TPR) {
    const float f = to_f(xr[i]);
    ss += f * f;
  }
  ss = row_sum<TPR>(ss, red);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int i = lane; i < nvec; i += TPR) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
    const TX* v = reinterpret_cast<const TX*>(&raw);
    uint4 out;
    TX* o = reinterpret_cast<TX*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = from_f<TX>(to_f(v[j]) * r * to_f(s[i * V + j]));
    reinterpret_cast<uint4*>(yr)[i] = out;
  }
  for (int i = nvec * V + lane; i < d; i += TPR)
    yr[i] = from_f<TX>(to_f(xr[i]) * r * to_f(s[i]));
}

template <typename TX, typename TS>
int launch(const void* x, const void* s, void* y, long long rows, int d,
           float eps, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TS* sp = static_cast<const TS*>(s);
  TX* yp = static_cast<TX*>(y);
  if (d <= kWarpRowMaxD) {
    constexpr int kRows = kThreads / 32;
    const long long blocks = (rows + kRows - 1) / kRows;
    if (blocks > 0x7fffffffLL) return -1;
    rmsnorm_kernel<TX, TS, 32><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 stream>>>(xp, sp, yp, rows, d, eps);
  } else {
    if (rows > 0x7fffffffLL) return -1;
    rmsnorm_kernel<TX, TS, kThreads><<<static_cast<unsigned>(rows), kThreads,
                                       0, stream>>>(xp, sp, yp, rows, d, eps);
  }
  return 0;
}

}  // namespace

// Returns 0 on success, -1 for a shape or type this kernel does not take,
// else the cudaError_t of the launch. x_dtype, s_dtype: 0 fp32, 1 bf16;
// y has x's type. x and y are contiguous (rows, d), scale (d,).
extern "C" int rmsnorm(const void* x, const void* scale, void* y,
                       long long rows, int d, int x_dtype, int s_dtype,
                       float eps, void* stream) {
  if (rows < 1 || d < 1 || !x || !scale || !y) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (x_dtype == 0 && s_dtype == 0)
    rc = launch<float, float>(x, scale, y, rows, d, eps, st);
  else if (x_dtype == 0 && s_dtype == 1)
    rc = launch<float, __nv_bfloat16>(x, scale, y, rows, d, eps, st);
  else if (x_dtype == 1 && s_dtype == 0)
    rc = launch<__nv_bfloat16, float>(x, scale, y, rows, d, eps, st);
  else if (x_dtype == 1 && s_dtype == 1)
    rc = launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d, eps, st);
  else
    return -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
