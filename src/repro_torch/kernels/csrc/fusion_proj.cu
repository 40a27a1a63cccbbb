// The fused wire path at the client boundary for Hopper (sm_90a): the
// fusion layer's projection y = act(x @ w + b), alone, with the wire
// encode (and EF21) in its epilogue, and the modular block's first FC
// with the wire decode in its prologue.
//
// Replaces four TPU kernels:
//  * fusion_proj (src/repro/kernels/fusion_proj.py:80, pallas_call :112):
//    act(x @ w + b), act in {none, relu, silu}, output in x's dtype.
//  * fusion_proj_quant (:144, pallas_call :192): the same with the int8_row
//    encode in the epilogue -> (q int8 (M, N), scale fp32 (M, 1)).
//  * fusion_proj_encode (:262, pallas_call :332): the same with any wire
//    scheme's encode (int8_row, int4, topk, sketch), and with e the EF21
//    step c = y + e, encode(c), e' = clip(c - decode(payload)).
//  * decode_proj (src/repro/kernels/wire_fused.py:445, pallas_call :487):
//    act(decode(payload) @ w + b), fp32 out, the decoded rows kept in
//    shared memory.
//
// One rule makes the four agree bit for bit. Every output element is
// one fmaf chain over k = 0 .. K-1 in ascending order, starting from
// +0.0, whatever the tile; the bias and activation come after it, in
// one function (bias_act); the encode is wire_row.cuh's encode_row, the
// code wire_encode.cu runs; the decode is its decode_row, with the
// codec's roundings. So on the card:
//   fusion_proj_encode(x, w, b, act) == wire_encode(fusion_proj(x, w, b, act))
//   fusion_proj_quant(x, w, b, act)  == the int8_row payload of the same
//   decode_proj(p, w, b, act)        == fusion_proj(codec.decode(p), w, b, act)
// for fp32 x and w, e' of the EF step included. Against the plain
// version, which runs cuBLAS, the floats agree within rounding and an
// integer code may flip by one step where y sits on a rounding edge.
//
// Layout. Every tile has 256 threads in RL row lanes x 256 / RL column
// lanes; a thread owns TM rows x TN adjacent columns (Cfg below). k
// advances in steps of 16: each thread loads its share of the x (or
// decoded-row) tile and the w tile into registers, the next step's loads
// in flight while this step's products run, and stores them to shared
// memory as fp32 (bf16 inputs are widened on the load). The projection
// tiles (M, N) freely: 64 x 256, 16 x 256 or 4 x 256 tiles, the largest
// that still gives 132 blocks. The fused encode gives a block whole rows
// (16, or 4 at small M, in one 512-wide column tile for N <= 512): it
// keeps the finished y (BM x N fp32, up to N = 8192 with the opt-in above
// 48 KB) in shared memory and then encodes the rows one by one with the
// whole block. decode_proj decodes its BM payload rows into a (d x BM)
// shared tile and multiplies it by w's column tile. The TPU kernels'
// (8, 128) tiling, padded rows and the N % bn rule are gone: partial
// tiles are masked, so any M, K and N work.
//
// What bounds it on the card. At the IFL path's shapes (M 32, K up to
// 1568, N 432) the bytes of w: ~2.7 MB for 0.9 us at 3.35 TB/s. A
// full-row epilogue leaves M / BM blocks to read them (8 at M 32), each
// block all of w, with one k-step's loads in flight at a time: the
// kernels wait on memory latency, far from the bound. At large M the
// fp32 operations (67 TFLOP/s). These are simple SIMT kernels: no tensor
// cores, no TMA, no split-K, no thread-block clusters; bf16 inputs run on
// the same fp32 FMAs.

#include <cuda_bf16.h>

#include "wire_row.cuh"

namespace {

using namespace wire;

constexpr int kBK = 16;  // k per staged step
constexpr int kSmemLimit = 227 * 1024 - 1024;
constexpr int kSMs = 132;  // H100 SXM: a grid this large fills the card once
enum Act { kNone = 0, kRelu = 1, kSilu = 2 };
enum DType { kF32 = 0, kBF16 = 1 };

// A tile's thread layout: RL row lanes x (256 / RL) column lanes, each
// thread TM rows x TN adjacent columns; a tile is BM x BN. A warp shares
// its row lane, so the rows' values are one broadcast read.
template <int RL_, int TM_, int TN_>
struct Cfg {
  static constexpr int RL = RL_, TM = TM_, TN = TN_;
  static constexpr int CL = kThreads / RL;
  static constexpr int BM = RL * TM, BN = CL * TN;
};
using Big = Cfg<4, 16, 4>;    // 64 x 256: large M
using Mid = Cfg<4, 4, 4>;     // 16 x 256
using Small = Cfg<1, 4, 1>;   // 4 x 256: M 32 and the like
using Wide = Cfg<1, 4, 2>;    // 4 x 512: a 432-wide fusion row in one tile

// The epilogue every kernel here shares: bias, then the activation.
__device__ __forceinline__ float bias_act(float acc, const float* b, int n,
                                          int act) {
  float y = b ? __fadd_rn(acc, b[n]) : acc;
  if (act == kRelu) {
    y = fmaxf(y, 0.f);
  } else if (act == kSilu) {
    y = __fdiv_rn(y, __fadd_rn(1.f, expf(-y)));
  }
  return y;
}

template <bool BF16>
__device__ __forceinline__ float ld(const void* p, size_t i) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  } else {
    return static_cast<const float*>(p)[i];
  }
}

template <int N>
__device__ __forceinline__ void read_vec(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// One k-step's share of the x tile (rows [m0, m0 + BM) x k [k0, k0 + 16))
// and the w tile (k x columns [n0, n0 + BN)) in registers: every load is
// issued before any is stored, and the next step's loads are in flight
// while this step's products run. Zero outside x and w.
template <class C>
struct Stage {
  static constexpr int kX = (C::BM * kBK + kThreads - 1) / kThreads;
  static constexpr int kW = kBK * C::BN / kThreads;
  float xs[kX];
  float ws[kW];

  template <bool BF16>
  __device__ void load(const void* x, const void* w, int M, int K, int N,
                       int m0, int n0, int k0) {
    const int kn = min(kBK, K - k0);
    if (x) {
#pragma unroll
      for (int t = 0; t < kX; ++t) {
        const int idx = threadIdx.x + t * kThreads;
        const int r = idx / kBK, kk = idx % kBK;
        xs[t] = (idx < C::BM * kBK && m0 + r < M && kk < kn)
            ? ld<BF16>(x, static_cast<size_t>(m0 + r) * K + k0 + kk)
            : 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < kW; ++t) {
      const int idx = threadIdx.x + t * kThreads;
      const int kk = idx / C::BN, n = n0 + idx % C::BN;
      ws[t] = (kk < kn && n < N)
          ? ld<BF16>(w, static_cast<size_t>(k0 + kk) * N + n) : 0.f;
    }
  }

  __device__ void store(bool with_x, float* As, float* Bs) const {
    if (with_x) {
#pragma unroll
      for (int t = 0; t < kX; ++t) {
        const int idx = threadIdx.x + t * kThreads;
        if (idx < C::BM * kBK) As[(idx % kBK) * C::BM + idx / kBK] = xs[t];
      }
    }
#pragma unroll
    for (int t = 0; t < kW; ++t) Bs[threadIdx.x + t * kThreads] = ws[t];
  }
};

// acc[i][j] = fmaf(A[kk][rl TM + i], B[kk][cl TN + j], acc[i][j]) for
// kk = 0 .. kn-1, in order.
template <class C>
__device__ __forceinline__ void fma_steps(float (&acc)[C::TM][C::TN],
                                          const float* As, const float* Bs,
                                          int kn) {
  const int cl = threadIdx.x % C::CL, rl = threadIdx.x / C::CL;
  for (int kk = 0; kk < kn; ++kk) {
    float a[C::TM], b[C::TN];
    read_vec(a, As + kk * C::BM + rl * C::TM);
    read_vec(b, Bs + kk * C::BN + cl * C::TN);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// One (BM x BN) tile of A @ w over the whole of K. A is x (M, K), staged
// into As, or, with `zt`, a (K x BM) shared tile already in place.
template <class C>
__device__ void gemm_tile(float (&acc)[C::TM][C::TN], const void* x,
                          const float* zt, const void* w, int dtype, int M,
                          int K, int N, int m0, int n0, float* As,
                          float* Bs) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;
  Stage<C> st;
  const void* xs = zt ? nullptr : x;
  // One branch on the dtype per step, so each step's loads issue together.
  auto load = [&](int k0) {
    if (dtype == kBF16) {
      st.template load<true>(xs, w, M, K, N, m0, n0, k0);
    } else {
      st.template load<false>(xs, w, M, K, N, m0, n0, k0);
    }
  };
  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous step's readers are done
    st.store(xs != nullptr, As, Bs);
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);
    fma_steps<C>(acc, zt ? zt + static_cast<size_t>(k0) * C::BM : As, Bs,
                 min(kBK, K - k0));
  }
}

template <class C>
constexpr size_t tile_floats() {
  return kBK * C::BM + kBK * C::BN;
}

// ---------------------------------------------------------------- #4

struct ProjArgs {
  const void* x;
  const void* w;
  const float* b;
  void* y;
  int M, K, N, dtype, act;
};

template <class C>
__global__ void __launch_bounds__(kThreads) fusion_proj_kernel(ProjArgs a) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = smem + kBK * C::BM;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  float acc[C::TM][C::TN];
  gemm_tile<C>(acc, a.x, nullptr, a.w, a.dtype, a.M, a.K, a.N, m0, n0, As,
               Bs);
  const int cl = threadIdx.x % C::CL, rl = threadIdx.x / C::CL;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int m = m0 + rl * C::TM + i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int n = n0 + cl * C::TN + j;
      if (n >= a.N) continue;
      const float y = bias_act(acc[i][j], a.b, n, a.act);
      const size_t o = static_cast<size_t>(m) * a.N + n;
      if (a.dtype == kBF16) {
        static_cast<__nv_bfloat16*>(a.y)[o] = __float2bfloat16_rn(y);
      } else {
        static_cast<float*>(a.y)[o] = y;
      }
    }
  }
}

// ------------------------------------------------------------ #5, #6

struct EncArgs {
  const void* x;
  const void* w;
  const float* b;
  const float* e;
  int M, K, dtype, act;
  Params p;  // p.d is N
};

// Shared floats of the fused encode: y (BM x N), then one region that
// holds the staged tiles during the matmul and the row c with its
// scratch during the encode.
template <class C>
size_t encode_smem_floats(int S, int N, int n) {
  const size_t row = N + scratch_floats(S, N, n);
  return static_cast<size_t>(C::BM) * N +
         (tile_floats<C>() > row ? tile_floats<C>() : row);
}

// encode_row as a called function: inlined, its registers would count
// against the matmul loop's (232 with spills where it was).
template <int S, bool EF>
__device__ __noinline__ void encode_row_call(const Params& p, const float* z,
                                             const float* e, float* c,
                                             float* scratch, float* red,
                                             size_t row) {
  encode_row<S, EF>(p, z, e, c, scratch, red, row);
}

template <class C, int S, bool EF>
__global__ void __launch_bounds__(kThreads) proj_encode_kernel(EncArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32];
  const int N = a.p.d;
  float* y = smem;                                       // BM x N
  float* region = smem + static_cast<size_t>(C::BM) * N; // tiles | c, scratch
  const int m0 = blockIdx.x * C::BM;
  const int cl = threadIdx.x % C::CL, rl = threadIdx.x / C::CL;
  for (int n0 = 0; n0 < N; n0 += C::BN) {
    float acc[C::TM][C::TN];
    gemm_tile<C>(acc, a.x, nullptr, a.w, a.dtype, a.M, a.K, N, m0, n0,
                 region, region + kBK * C::BM);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const int n = n0 + cl * C::TN + j;
        if (n < N)
          y[(rl * C::TM + i) * N + n] = bias_act(acc[i][j], a.b, n, a.act);
      }
  }
  const int rows = min(C::BM, a.M - m0);
  for (int r = 0; r < rows; ++r) {
    const size_t row = static_cast<size_t>(m0) + r;
    encode_row_call<S, EF>(a.p, y + static_cast<size_t>(r) * N,
                      EF ? a.e + row * N : nullptr, region, region + N, red,
                      row);
  }
}

// ---------------------------------------------------------------- #3

struct DecArgs {
  const void* in0;
  const void* in1;
  const void* w;
  const float* b;
  float* y;
  int M, N, dtype, act;
  Params p;  // p.d is the payload's fusion dim, the K of the product
};

template <class C, int S>
__global__ void __launch_bounds__(kThreads) decode_proj_kernel(DecArgs a) {
  extern __shared__ float smem[];
  constexpr int BM = C::BM;
  const int d = a.p.d;
  float* zt = smem;                                  // d x BM, k-major
  float* Bs = smem + static_cast<size_t>(d) * BM;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * C::BN;
  const int rows = min(BM, a.M - m0);
  if (S == kTopK || rows < BM) {  // scatter targets and missing rows: zero
    for (int i = threadIdx.x; i < d * BM; i += kThreads) zt[i] = 0.f;
    __syncthreads();
  }
  for (int r = 0; r < rows; ++r)
    decode_row<S>(a.p, a.in0, a.in1, static_cast<size_t>(m0) + r, zt + r, BM);
  float acc[C::TM][C::TN];
  gemm_tile<C>(acc, nullptr, zt, a.w, a.dtype, a.M, d, a.N, m0, n0, nullptr,
               Bs);
  const int cl = threadIdx.x % C::CL, rl = threadIdx.x / C::CL;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int m = m0 + rl * C::TM + i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int n = n0 + cl * C::TN + j;
      if (n < a.N)
        a.y[static_cast<size_t>(m) * a.N + n] = bias_act(acc[i][j], a.b, n, a.act);
    }
  }
}

// ------------------------------------------------------------- launch

template <class C>
dim3 grid_of(int M, int N) {
  return dim3((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN);
}

template <class C>
bool fills_card(int M, int N) {
  const dim3 g = grid_of<C>(M, N);
  return static_cast<long>(g.x) * g.y >= kSMs;
}

template <class Kernel, class A>
int launch(Kernel kernel, dim3 grid, size_t smem, const A& args,
           cudaStream_t s) {
  if (smem > static_cast<size_t>(kSmemLimit)) return -1;
  if (smem > kOptInAbove) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<grid, kThreads, smem, s>>>(args);
  return 0;
}

// The fused encode with Mid tiles (16 rows a block) where that still
// gives a full wave of blocks and fits, else Wide (4 rows, the 432-wide
// row in one column tile: 8 blocks at M 32).
template <int S, bool EF>
int launch_encode(const EncArgs& a, cudaStream_t s) {
  const int N = a.p.d;
  const size_t mid = sizeof(float) * encode_smem_floats<Mid>(S, N, a.p.n);
  if (fills_card<Mid>(a.M, 1) && mid <= static_cast<size_t>(kSmemLimit))
    return launch(proj_encode_kernel<Mid, S, EF>, grid_of<Mid>(a.M, 1), mid,
                  a, s);
  return launch(proj_encode_kernel<Wide, S, EF>, grid_of<Wide>(a.M, 1),
                sizeof(float) * encode_smem_floats<Wide>(S, N, a.p.n), a, s);
}

template <bool EF>
int launch_encode_scheme(int scheme, const EncArgs& a, cudaStream_t s) {
  switch (scheme) {
    case kInt8Row: return launch_encode<kInt8Row, EF>(a, s);
    case kInt4: return launch_encode<kInt4, EF>(a, s);
    case kTopK: return launch_encode<kTopK, EF>(a, s);
    case kSketch: return launch_encode<kSketch, EF>(a, s);
    default: return -1;
  }
}

template <int S>
int launch_decode(const DecArgs& a, cudaStream_t s) {
  const size_t d = a.p.d;
  const size_t mid = sizeof(float) * (d * Mid::BM + kBK * Mid::BN);
  if (fills_card<Mid>(a.M, a.N) && mid <= static_cast<size_t>(kSmemLimit))
    return launch(decode_proj_kernel<Mid, S>, grid_of<Mid>(a.M, a.N), mid, a,
                  s);
  return launch(decode_proj_kernel<Small, S>, grid_of<Small>(a.M, a.N),
                sizeof(float) * (d * Small::BM + kBK * Small::BN), a, s);
}

bool bad_common(int M, int K, int N, int dtype, int act) {
  return M < 1 || K < 1 || N < 1 || (dtype != kF32 && dtype != kBF16) ||
         act < kNone || act > kSilu;
}

}  // namespace

// Each entry returns 0 on success, -1 for arguments the kernel does not
// take, else the cudaError_t of the launch. dtype: 0 fp32, 1 bf16 (x and
// w, and y for fusion_proj); act: 0 none, 1 relu, 2 silu; b (fp32, N)
// may be null. scheme: 0 int8_row, 1 int4, 2 topk, 3 sketch; n is k
// (topk) or w (sketch). Everything runs on `stream`; nothing syncs.

// y (M, N) = act(x (M, K) @ w (K, N) + b), in x's dtype.
extern "C" int fusion_proj(const void* x, const void* w, const float* b,
                           void* y, int M, int K, int N, int dtype, int act,
                           void* stream) {
  if (bad_common(M, K, N, dtype, act)) return -1;
  const ProjArgs a{x, w, b, y, M, K, N, dtype, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (fills_card<Big>(M, N)) {
    rc = launch(fusion_proj_kernel<Big>, grid_of<Big>(M, N),
                sizeof(float) * tile_floats<Big>(), a, s);
  } else if (fills_card<Mid>(M, N)) {
    rc = launch(fusion_proj_kernel<Mid>, grid_of<Mid>(M, N),
                sizeof(float) * tile_floats<Mid>(), a, s);
  } else {
    rc = launch(fusion_proj_kernel<Small>, grid_of<Small>(M, N),
                sizeof(float) * tile_floats<Small>(), a, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The projection with wire_row.cuh's encode of each row of y (N = the
// fusion dim <= 8192) into out0/out1; with ef, c = y + e and e' into
// e_out. The sketch tables may be null for the other schemes.
extern "C" int fusion_proj_encode(int scheme, int ef, const void* x,
                                  const void* w, const float* b,
                                  const float* e, int M, int K, int N, int n,
                                  int dtype, int act, float inv_qmax,
                                  float qmax, int clip, float max_ratio,
                                  const float* sign, const float* inv_counts,
                                  const int* hash, const int* order,
                                  const int* ptr, void* out0, void* out1,
                                  float* e_out, void* stream) {
  if (bad_common(M, K, N, dtype, act) || N > kMaxD) return -1;
  if ((scheme == kTopK || scheme == kSketch) && (n < 1 || n > N)) return -1;
  if (scheme == kSketch && (!sign || !inv_counts || !hash || !order || !ptr))
    return -1;
  if (ef && (!e || !e_out)) return -1;
  const EncArgs a{x, w, b, e, M, K, dtype, act,
                  {N, n, inv_qmax, qmax, clip, max_ratio, sign, inv_counts,
                   hash, order, ptr, out0, out1, e_out}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = ef ? launch_encode_scheme<true>(scheme, a, s)
                    : launch_encode_scheme<false>(scheme, a, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The projection with the int8_row encode: q int8 (M, N), scale fp32
// (M, 1). The template of fusion_proj_encode at int8_row, its own entry.
extern "C" int fusion_proj_quant(const void* x, const void* w, const float* b,
                                 int M, int K, int N, int dtype, int act,
                                 float inv_qmax, void* q, float* scale,
                                 void* stream) {
  if (bad_common(M, K, N, dtype, act) || N > kMaxD) return -1;
  const EncArgs a{x, w, b, nullptr, M, K, dtype, act,
                  {N, 0, inv_qmax, 127.f, 0, 0.f, nullptr, nullptr, nullptr,
                   nullptr, nullptr, q, scale, nullptr}};
  const int rc = launch_encode<kInt8Row, false>(a, static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// y (M, N) fp32 = act(decode(payload rows) (M, d) @ w (d, N) + b). in0 /
// in1 are the payload leaves in the scheme's order (q/scale, q4/scale,
// values/indices, sketch); the sketch needs sign, inv_counts and hash.
extern "C" int decode_proj(int scheme, const void* in0, const void* in1,
                           const void* w, const float* b, float* y, int M,
                           int d, int N, int n, int dtype, int act,
                           const float* sign, const float* inv_counts,
                           const int* hash, void* stream) {
  if (bad_common(M, d, N, dtype, act) || d > kMaxD) return -1;
  if ((scheme == kTopK || scheme == kSketch) && (n < 1 || n > d)) return -1;
  if (scheme == kSketch && (!sign || !inv_counts || !hash)) return -1;
  const DecArgs a{in0, in1, w, b, y, M, N, dtype, act,
                  {d, n, 0.f, 0.f, 0, 0.f, sign, inv_counts, hash, nullptr,
                   nullptr, nullptr, nullptr, nullptr}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (scheme) {
    case kInt8Row: rc = launch_decode<kInt8Row>(a, s); break;
    case kInt4: rc = launch_decode<kInt4>(a, s); break;
    case kTopK: rc = launch_decode<kTopK>(a, s); break;
    case kSketch: rc = launch_decode<kSketch>(a, s); break;
    default: return -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
