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
// What bounds it on the card: bytes (each z, e element is read once and
// each payload and e' element written once, a few flops each) at large
// row counts; at the IFL path's shape, (32, 432) per client per round,
// 32 rows of 70-170 KB of traffic in all, the latency of one row's chain
// of loads, reductions and stores.
//
// Layout. A row is encoded by a team (wire_row.cuh Team) that holds the
// whole row of c in shared memory (d <= 8192 floats, MAX_FUSED_D of the
// reference), with top-k's sort keys or the sketch's bucket sums beside
// it. Two teams, the caller's choice (ops.encode_warps, a function of
// the rows, d and the scheme):
//  * a block of 256 threads a row: each pass over the row is 2 elements a
//    thread, so a row's chain of loads, reductions and stores is short;
//    at few rows, as the path's 32, that chain is the time;
//  * a warp a row, `warps` rows a block, each warp with its own buffers:
//    no block barrier, but a warp runs a row's passes 14 elements a lane
//    at d 432, so it wins only where many rows keep the SMs busy (4096
//    rows; top-k from 1024, its sort narrowed by a radix select) and
//    rows are short (d <= 512).
// Both give the same bits: a warp plays the block's 256 threads in the
// row's sums. The TPU kernel's row blocks of 256 rows and zero-padded row
// counts are gone: the grid covers any row count.

#include "wire_row.cuh"

namespace {

using namespace wire;

constexpr size_t kSmemMax = 227 * 1024;

struct Args {
  const float* __restrict__ z;
  const float* __restrict__ e;
  int rows;
  int team;  // team_floats of one row
  Params p;
};

// A block of kThreads a row.
template <int S, bool EF>
__global__ void __launch_bounds__(kThreads) wire_encode_block(Args a) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32];
  const size_t row = blockIdx.x;
  const size_t off = row * a.p.d;
  encode_row<S, EF>(a.p, a.z + off, EF ? a.e + off : nullptr, smem,
                    smem + pad4(a.p.d), red, row);
}

// A warp a row, blockDim.x / 32 rows a block.
template <int S, bool EF>
__global__ void __launch_bounds__(kThreads) wire_encode_warps(Args a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const size_t row = static_cast<size_t>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (row >= static_cast<size_t>(a.rows)) return;  // whole warps only
  float* c = smem + static_cast<size_t>(warp) * a.team;
  const size_t off = row * a.p.d;
  encode_row<S, EF, 32>(a.p, a.z + off, EF ? a.e + off : nullptr, c,
                        c + pad4(a.p.d), nullptr, row);
}

// Shared bytes of a block of `warps` teams (0: one block team) of `team`
// floats each.
size_t block_smem(int team, int warps) {
  const size_t bytes = sizeof(float) * team;
  return warps ? warps * bytes : bytes;
}

bool team_ok(int warps) {
  return warps == 0 || warps == 1 || warps == 2 || warps == 4 || warps == 8;
}

template <int S, bool EF>
int launch(const Args& a, int warps, cudaStream_t stream) {
  const size_t smem = block_smem(a.team, warps);
  if (smem > kSmemMax) return -1;
  auto kernel = warps ? wire_encode_warps<S, EF> : wire_encode_block<S, EF>;
  if (smem > (warps ? 48 * 1024 : kOptInAbove)) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int grid = warps ? (a.rows + warps - 1) / warps : a.rows;
  kernel<<<grid, warps ? 32 * warps : kThreads, smem, stream>>>(a);
  return 0;
}

template <bool EF>
int launch_scheme(int scheme, const Args& a, int warps, cudaStream_t s) {
  switch (scheme) {
    case kInt8Row: return launch<kInt8Row, EF>(a, warps, s);
    case kInt4: return launch<kInt4, EF>(a, warps, s);
    case kTopK: return launch<kTopK, EF>(a, warps, s);
    case kSketch: return launch<kSketch, EF>(a, warps, s);
    default: return -1;
  }
}

}  // namespace

// Returns 0 on success, -1 for a scheme, shape or team this kernel does
// not take, else the cudaError_t of the launch. scheme: 0 int8_row, 1
// int4, 2 topk, 3 sketch. ef != 0 runs the EF21 epilogue (e and e_out
// needed). n is k (topk) or w (sketch). The sketch tables may be null
// otherwise. warps: 1, 2, 4 or 8 rows a block, a warp a row; 0 a block a
// row.
extern "C" int wire_encode(int scheme, int ef, const float* z, const float* e,
                           int rows, int d, int n, float inv_qmax, float qmax,
                           int clip, float max_ratio, const float* sign,
                           const float* inv_counts, const int* hash,
                           const int* order, const int* ptr, void* out0,
                           void* out1, float* e_out, int warps, void* stream) {
  if (rows < 1 || d < 1 || d > kMaxD) return -1;
  if ((scheme == kTopK || scheme == kSketch) && (n < 1 || n > d)) return -1;
  if (scheme == kSketch && (!sign || !inv_counts || !hash || !order || !ptr))
    return -1;
  if (ef && (!e || !e_out)) return -1;
  if (!team_ok(warps)) return -1;
  const Args a{z, e, rows, static_cast<int>(team_floats(scheme, d, n)),
               {d, n, inv_qmax, qmax, clip, max_ratio, sign, inv_counts, hash,
                order, ptr, out0, out1, e_out}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = ef ? launch_scheme<true>(scheme, a, warps, s)
                    : launch_scheme<false>(scheme, a, warps, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// 1 where a launch takes the team `warps` at (d, n) under scheme, its
// rows' buffers within shared memory; else 0. Launches nothing.
extern "C" int wire_encode_takes(int scheme, int d, int n, int warps) {
  if (d < 1 || d > kMaxD || scheme < kInt8Row || scheme > kSketch ||
      !team_ok(warps))
    return 0;
  const int team = static_cast<int>(team_floats(scheme, d, n));
  return block_smem(team, warps) <= kSmemMax ? 1 : 0;
}
