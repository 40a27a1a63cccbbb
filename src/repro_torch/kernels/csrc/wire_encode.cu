// Wire encode for Hopper (sm_90a): one fp32 (rows, d) block of fusion
// outputs -> its codec payload, in one launch, with or without the EF21
// epilogue.
//
// Replaces the TPU kernels wire_encode and wire_encode_ef
// (src/repro/kernels/wire_fused.py:370 and :389, through _encode_call /
// _encode_kernel, pallas_call at :347). It computes the same functions,
// for the four wire schemes of wire_fused.py:133-253. The per-row code,
// its schemes and its numerics (integer codes bitwise equal to the plain
// version, e' within a few ulps) are in wire_row.cuh, which the fused
// projection kernels (fusion_proj.cu) share.
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

#include "wire_row.cuh"

namespace {

using namespace wire;

struct Args {
  const float* __restrict__ z;
  const float* __restrict__ e;
  Params p;
};

template <int S, bool EF>
__global__ void __launch_bounds__(kThreads)
wire_encode_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const size_t off = row * a.p.d;
  encode_row<S, EF>(a.p, a.z + off, EF ? a.e + off : nullptr, smem,
                    smem + a.p.d, red, row);
}

template <int S, bool EF>
int launch(const Args& p, int rows, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (p.p.d + scratch_floats(S, p.p.d, p.p.n));
  if (smem > kOptInAbove) {
    const cudaError_t rc = cudaFuncSetAttribute(
        wire_encode_kernel<S, EF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  wire_encode_kernel<S, EF><<<rows, kThreads, smem, stream>>>(p);
  return 0;
}

template <bool EF>
int launch_scheme(int scheme, const Args& p, int rows, cudaStream_t s) {
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
  Args p{z, e, {d, n, inv_qmax, qmax, clip, max_ratio, sign, inv_counts,
                hash, order, ptr, out0, out1, e_out}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = ef ? launch_scheme<true>(scheme, p, rows, s)
                    : launch_scheme<false>(scheme, p, rows, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
