// RMSNorm over the last dim for Hopper (sm_90a): for each row of an
// (M, D) input, y = (x * rsqrt(sum(x^2) / D + eps)) * scale, all in fp32,
// in that order, with one rounding to the output type at the end.
//
// Replaces the TPU kernel rmsnorm_pallas (src/repro/kernels/rmsnorm.py:25,
// pallas_call at :31; arithmetic at :18-22, the jnp oracle
// src/repro/kernels/ref.py:121-125). x is fp32 or bf16, scale fp32 or
// bf16 independently of x, and y takes x's type. The TPU wrapper pads M
// to 256-row blocks (src/repro/kernels/ops.py:163-166); here any M >= 1
// and any D >= 1.
//
// What bounds it on the card: bytes. Each element is read, squared and
// summed, scaled and written: 3 flops and 2 element moves, far below
// Hopper's ~20 fp32 flops per byte, so the kernel should read each byte
// of x once, write each byte of y once, and keep enough bytes in flight
// to cover device memory's latency. The design:
//
//  * one read of each row, held in registers: a row of D <= 1024 goes to
//    one warp (at most 32 elements a lane: 8 float4 or 4 x 8 bf16), a
//    row of D <= 8192 to the whole 256-thread block (32 a thread), so
//    the row is squared, summed (a warp-shuffle tree, joined through
//    shared memory for a block) and scaled from registers, in 16-byte
//    loads and stores;
//  * the scale is read once per thread, in 16-byte (or 8-byte) vectors
//    where it starts on 16 bytes, and kept in registers while the thread
//    walks its rows: a grid of at most 2 blocks an SM, grid-stride, each
//    row slot walking ceil(M / slots) rows, the next row's loads issued
//    before this row's sum;
//  * rows the registers do not take, longer ones (D > 8192) and rows not
//    all on 16 bytes (D not a multiple of 4 fp32 or 8 bf16, or x or y
//    off 16 bytes), go to the two-pass kernel: a warp or the block reads
//    the row for its sum of squares, then again from L1 or L2 to scale
//    it, in 16-byte vectors where that row starts on 16 bytes (its last
//    D % V elements one by one), else element by element.
//
// Sums are taken in another order than the plain version's (a tree over
// threads, not PyTorch's CPU reduction), so fp32 outputs agree within a
// few ulps, not bitwise; each element is still (x * r) * scale with r =
// rsqrt(sum / D + eps), one rounding at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 2;   // resident blocks a launch plans for
constexpr int kEPT = 32;          // row elements a thread holds in registers
constexpr int kWarpRowMaxD = 32 * kEPT;         // 1024: a warp a row
constexpr int kBlockRowMaxD = kThreads * kEPT;  // 8192: a block a row

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

// The sum of v over the TPR threads of a row, in every one of them. A
// block-wide sum (TPR == kThreads) goes through red[kThreads / 32]; a
// caller that sums again before every thread has read red passes the
// other half of a double buffer.
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

// V elements of type T from p into floats: 16-byte loads (8-byte for 4
// bf16) when vec, else one at a time.
template <typename T, int V>
__device__ __forceinline__ void load_run(float (&o)[V], const T* p,
                                         bool vec) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < kBytes / 16; ++q) {
        const uint4 raw = reinterpret_cast<const uint4*>(p)[q];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < 16 / static_cast<int>(sizeof(T)); ++i)
          o[q * (16 / sizeof(T)) + i] = to_f(e[i]);
      }
      return;
    }
  } else if constexpr (kBytes == 8) {
    if (vec) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = to_f(e[i]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = to_f(p[i]);
}

template <typename TX>
__device__ __forceinline__ float at(const uint4& raw, int e) {
  return to_f(reinterpret_cast<const TX*>(&raw)[e]);
}

// One read of each row, held in registers; every row starts on 16 bytes
// (d a multiple of V = 16 / sizeof(x), x and y on 16 bytes). The row's
// TPR threads (a warp, or the block) split it into 16-byte slots; thread
// `lane` holds slots lane + TPR j, j < NS. Its slots of the scale are read
// once and kept while it walks rows first, first + stride, ...; the next
// row's loads are issued before this row's sum.
template <typename TX, typename TS, int TPR>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
rmsnorm_reg_kernel(const TX* __restrict__ x, const TS* __restrict__ s,
                   TX* __restrict__ y, long long rows, int d, float eps,
                   bool s_vec) {
  constexpr int V = 16 / sizeof(TX);
  constexpr int NS = kEPT / V;
  constexpr int kRowsPerBlock = kThreads / TPR;
  __shared__ float red[2][kThreads / 32];
  const int lane = threadIdx.x % TPR;
  const int nslot = d / V;
  const long long stride = static_cast<long long>(gridDim.x) * kRowsPerBlock;
  long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / TPR;

  // Slot j of this thread lies TPR V j elements past its first.
  float sc[NS][V];
  const TS* sl = s + lane * V;
#pragma unroll
  for (int j = 0; j < NS; ++j)
    if (lane + TPR * j < nslot) load_run<TS, V>(sc[j], sl + TPR * V * j, s_vec);
  auto load_row = [&](uint4 (&v)[NS], long long r) {
    const uint4* xl = reinterpret_cast<const uint4*>(x + r * d) + lane;
#pragma unroll
    for (int j = 0; j < NS; ++j)
      if (lane + TPR * j < nslot) v[j] = xl[TPR * j];
  };
  uint4 cur[NS], next[NS];
  if (row < rows) load_row(cur, row);
  // Every thread of a block-wide row walks the same rows, so none leaves
  // the loop while others still meet the barrier in row_sum.
  for (int par = 0; row < rows; row += stride, par ^= 1) {
    if (row + stride < rows) load_row(next, row + stride);
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (lane + TPR * j < nslot) {
#pragma unroll
        for (int e = 0; e < V; ++e) ss += at<TX>(cur[j], e) * at<TX>(cur[j], e);
      }
    }
    ss = row_sum<TPR>(ss, red[par]);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    uint4* yl = reinterpret_cast<uint4*>(y + row * d) + lane;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (lane + TPR * j >= nslot) continue;
      uint4 out;
      TX* o = reinterpret_cast<TX*>(&out);
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = from_f<TX>(at<TX>(cur[j], e) * r * sc[j][e]);
      yl[TPR * j] = out;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) cur[j] = next[j];
  }
}

// Rows the registers do not take: longer than kBlockRowMaxD, or not all
// on 16 bytes. TPR threads a row (a warp, or the block) read it twice,
// once for the sum of squares and once to scale it; the second read finds
// it in L1 or L2. A row whose x and y start on 16 bytes goes in 16-byte
// vectors, its last d % V elements one by one; an unaligned row element
// by element.
template <typename TX, typename TS, int TPR>
__global__ void __launch_bounds__(kThreads)
rmsnorm_two_pass_kernel(const TX* __restrict__ x, const TS* __restrict__ s,
                        TX* __restrict__ y, long long rows, int d,
                        float eps) {
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
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = at<TX>(raw, j);
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
    uint4 out;
    TX* o = reinterpret_cast<TX*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = from_f<TX>(at<TX>(raw, j) * r * to_f(s[i * V + j]));
    reinterpret_cast<uint4*>(yr)[i] = out;
  }
  for (int i = nvec * V + lane; i < d; i += TPR)
    yr[i] = from_f<TX>(to_f(xr[i]) * r * to_f(s[i]));
}

bool on16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The register kernel's grid with TPR threads a row on a card of sms
// SMs: at most kBlocksPerSM blocks an SM, the rows split evenly over its
// row slots (each slot walks ceil(rows / slots) rows).
long long reg_blocks(long long rows, int tpr, int sms) {
  const long long rows_per_block = kThreads / tpr;
  const long long slots =
      static_cast<long long>(sms) * kBlocksPerSM * rows_per_block;
  const long long per = (rows + slots - 1) / slots;  // rows a slot walks
  return (rows + per * rows_per_block - 1) / (per * rows_per_block);
}

template <typename TX, typename TS, int TPR>
int launch_reg(const TX* x, const TS* s, TX* y, long long rows, int d,
               float eps, int sms, cudaStream_t stream) {
  const long long blocks = reg_blocks(rows, TPR, sms);
  // The scale in vector loads: 16 bytes of x's elements are 8, 16 or 32
  // bytes of scale, each on its size when s is on 16 bytes.
  rmsnorm_reg_kernel<TX, TS, TPR><<<static_cast<unsigned>(blocks), kThreads,
                                    0, stream>>>(x, s, y, rows, d, eps,
                                                 on16(s));
  return 0;
}

template <typename TX, typename TS, int TPR>
int launch_two_pass(const TX* x, const TS* s, TX* y, long long rows, int d,
                    float eps, cudaStream_t stream) {
  constexpr long long kRowsPerBlock = kThreads / TPR;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return -1;
  rmsnorm_two_pass_kernel<TX, TS, TPR><<<static_cast<unsigned>(blocks),
                                         kThreads, 0, stream>>>(x, s, y, rows,
                                                                d, eps);
  return 0;
}

// Threads a row (32 or kThreads) and whether the register kernel takes
// the rows (else the two-pass kernel) at d, rows all on 16 bytes or not.
int threads_a_row(int d) { return d <= kWarpRowMaxD ? 32 : kThreads; }
bool in_registers(int d, bool aligned) {
  return aligned && d <= kBlockRowMaxD;
}

template <typename TX, typename TS>
int launch(const void* x, const void* s, void* y, long long rows, int d,
           float eps, int sms, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TS* sp = static_cast<const TS*>(s);
  TX* yp = static_cast<TX*>(y);
  const bool aligned = d % (16 / sizeof(TX)) == 0 && on16(x) && on16(y);
  if (threads_a_row(d) == 32)
    return in_registers(d, aligned)
               ? launch_reg<TX, TS, 32>(xp, sp, yp, rows, d, eps, sms, stream)
               : launch_two_pass<TX, TS, 32>(xp, sp, yp, rows, d, eps,
                                             stream);
  if (in_registers(d, aligned))
    return launch_reg<TX, TS, kThreads>(xp, sp, yp, rows, d, eps, sms,
                                        stream);
  return launch_two_pass<TX, TS, kThreads>(xp, sp, yp, rows, d, eps, stream);
}

}  // namespace

// Returns 0 on success, -1 for a shape or type this kernel does not take,
// else the cudaError_t of the launch. x_dtype, s_dtype: 0 fp32, 1 bf16;
// y has x's type. x and y are contiguous (rows, d), scale (d,). sms is
// the card's SM count, which sets the register kernel's grid.
extern "C" int rmsnorm(const void* x, const void* scale, void* y,
                       long long rows, int d, int x_dtype, int s_dtype,
                       float eps, int sms, void* stream) {
  if (rows < 1 || d < 1 || !x || !scale || !y || sms < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (x_dtype == 0 && s_dtype == 0)
    rc = launch<float, float>(x, scale, y, rows, d, eps, sms, st);
  else if (x_dtype == 0 && s_dtype == 1)
    rc = launch<float, __nv_bfloat16>(x, scale, y, rows, d, eps, sms, st);
  else if (x_dtype == 1 && s_dtype == 0)
    rc = launch<__nv_bfloat16, float>(x, scale, y, rows, d, eps, sms, st);
  else if (x_dtype == 1 && s_dtype == 1)
    rc = launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d, eps, sms,
                                               st);
  else
    return -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The grid a launch at (rows, d) takes on a card of sms SMs (launches
// nothing): the register kernel's blocks, or the two-pass kernel's (a
// row a warp or a block) where the rows are not all on 16 bytes
// (aligned 0) or longer than 8192; -1 for arguments the kernel does not
// take.
extern "C" long long rmsnorm_grid(long long rows, int d, int aligned,
                                  int sms) {
  if (rows < 1 || d < 1 || sms < 1) return -1;
  const int tpr = threads_a_row(d);
  if (in_registers(d, aligned != 0)) return reg_blocks(rows, tpr, sms);
  return (rows + kThreads / tpr - 1) / (kThreads / tpr);
}
