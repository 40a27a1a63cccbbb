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
// code wire_encode.cu runs; the decode is its decode_at, with the
// codec's roundings. So on the card:
//   fusion_proj_encode(x, w, b, act) == wire_encode(fusion_proj(x, w, b, act))
//   fusion_proj_quant(x, w, b, act)  == the int8_row payload of the same
//   decode_proj(p, w, b, act)        == fusion_proj(codec.decode(p), w, b, act)
// for fp32 x and w, e' of the EF step included. Against the plain
// version, which runs cuBLAS, the floats agree within rounding and an
// integer code may flip by one step where y sits on a rounding edge.
//
// One fp32 main loop (f32_tile) serves all three SIMT paths: #4, the
// fused encode (#5, #6) and the decode projection (#3). It keeps the chain
// rule, so the identities hold; what differs is where A comes from (a
// source: x by cp.async, or the decoded payload rows).
//
// #4, what bounds it and what the design does, by regime:
//  * fp32 at small M (the Table-II boundary: M 32, K 64..1568, N 10..
//    1024). The bytes are few (w: 2.7 MB, 0.8 us at 3.35 TB/s), and the
//    chain rule forbids split-K, so each output is a chain of K
//    dependent FMAs (~4 cycles each, ~3.5 us at K 1568). On the card
//    what bounds it is the shared-memory loads that feed the chains: a
//    warp issues one every few cycles. So the tile is small (8 x 16
//    outputs, 64 threads, 2 chains a thread, 108..256 blocks at M 32)
//    and x is staged as it lies, so one float4 read gives 4 k of a row
//    and a k step costs 1.25 loads (x's quarter and w's float2) for 2
//    FMAs; 4 stages of 64 k stay in flight in a cp.async ring, one
//    barrier a stage. Every copy is 16 bytes where K and N allow.
//  * fp32 at large M (the LM shape (4096, 4096, 2048)): the fp32 FMAs
//    (67 TFLOP/s). A register-tiled SIMT GEMM: 128 x 128 tiles, 8 x 8
//    outputs a thread in two 4-wide runs each way, float4 reads of the
//    staged tiles (x transposed by 4-byte copies, w by 16-byte ones,
//    rows padded), a 3-stage ring of 16 k. 64 x 64 tiles where 128 x
//    128 would not fill the card but 64 x 64 give half a wave.
//  * bf16: the tensor cores. Every product is mma.sync m16n8k16 bf16
//    with fp32 accumulation; x and w tiles stay bf16 in a 16-byte
//    cp.async ring (4..8 stages of 32 k), rows padded 16 bytes so the
//    ldmatrix fragment loads (A from x's rows, B by .trans from w's k
//    rows) are conflict-free; 128 x 128 tiles of 8 warps at large M,
//    32 x 32 or 16 x 32 where those would not fill the card.
//    The epilogue is bias_act in fp32, then one rounding to bf16. The
//    tensor cores sum in their own order, so bf16 #4 is not bitwise
//    equal to the SIMT #3 on the same bf16 inputs (nor is it compared
//    so); the fp32 identities above are untouched.
// A launch takes the first tile of its list that gives enough blocks
// for the card (its SM count, which the caller reads from the card once
// and passes in). A tuned launch plan (ops.wire_plan) may name another
// tile of the list for the fused encode (#5, #6) and the decode (#3): in
// fp32 the chain rule below keeps every output's bits whatever the tile.
// Tiles stage by 16-byte copies where rows and starts allow (fp32: K
// and N % 4 == 0; bf16: % 8; x, w and y on 16 bytes), else by 4-byte
// copies (fp32) or element loads (bf16): one kernel, chosen per launch.
// Partial tiles are zero-filled; an fp32 chain still stops at K, adding
// no term past it.
//
// #5, #6 (the fused encode). At the Table-II boundary (M 32, K 1568, N
// 432) the bytes are few (w: 2.7 MB, 0.87 us); what bounds it is #4's
// chain of K dependent FMAs an output, then the encode of each row. So
// y is computed in #4's main loop: fp32 in #4's 8 x 16 tile at small M
// (108 blocks at (32, 432)), or in a 16 x 64 tile of the same loop where
// that gives a wave of blocks (at large M the encode of a row group, not
// the product, sets the time, so groups stay small); bf16 in #4's 16 x 32
// mma.sync tile, the fp32 bias_act value encoded, not its bf16 rounding. Each fp32 output is #4's
// one fmaf chain, so y is #4's y bitwise. Each block writes its y tile to
// an fp32 scratch y (L2-resident: 55 KB at (32, 432)) and counts its
// arrival on its row group's counter (__threadfence, then atomicAdd; the
// last block resets it to 0). The last of the group's N / BN column tiles
// to arrive encodes the group's rows, reading y back through L2, with
// encode_row a row a warp on the warps of its block that have room in
// shared memory for a row's buffers. A warp plays wire_encode.cu's 256
// threads in encode_row's sums, so the payload and e' are its bits. Any
// M, N <= 8192.
//
// #3 (the decode projection). At the Table-II boundary (a payload of
// (32, 432) into a first modular FC of N 10..256) the bytes are few (w:
// 0.44 MB at N 256); what bounds it, as #4 at M 32, is the chain of d
// dependent FMAs an output fed from shared memory, after the decode. So it
// runs #4's main loop and tiles with the decoded rows as A: a block
// decodes its BM payload rows once, with all of its threads over the rows
// together, into a resident tile laid out as the loop reads a stage (rows
// of d padded to 16 bytes plus 4 floats on 8 x 16 tiles; k rows of BM + 4
// on the larger ones), while the first ST - 1 stages of w land; only w
// streams through the cp.async ring, and stage t reads A at k offset
// t BK. A top-k row is zeroed, then scattered (a barrier between). The
// tile is #4's rule with one more condition: the first of its tiles that
// fills the card and whose decoded rows fit in shared memory beside the
// ring; else the 8 x 16 tile, its rows resident where they fit, else
// (d beyond 6,588) decoded a stage's k slice at a time into the A slot
// of the ring, a top-k row scattered a slice at a time from its pairs.
// Under 16 columns (the boundary's N 10) a 16 x 8 tile of the same loop
// takes its place where its rows fit (d up to 3,420).
// bf16 w stays bf16 in the ring and is widened on the shared-memory read,
// so its products keep the fp32 chain too. Partial tiles are masked: any
// M, d <= 8192 and N.

#include <cuda_bf16.h>

#include "mma_sm90.cuh"
#include "wire_row.cuh"

namespace {

using namespace sm90;
using namespace wire;

constexpr int kSmemLimit = 227 * 1024 - 1024;
// The card's SM count (a grid this large fills it once) comes with every
// launch, as `sms`: the caller reads it from the card once.
enum Act { kNone = 0, kRelu = 1, kSilu = 2 };
enum DType { kF32 = 0, kBF16 = 1 };

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

// bf16 values widened to fp32 (exactly), two at a time.
template <int N>
__device__ __forceinline__ void read_vec(float (&v)[N], const __nv_bfloat16* p) {
  static_assert(N % 2 == 0, "a thread's runs of columns are even");
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const float2 t =
        __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[q]);
    v[2 * q] = t.x;
    v[2 * q + 1] = t.y;
  }
}

// ---------------------------------------------------------------- #4
//
// The projection alone has its own main loop. Tiles are staged by
// cp.async into a ring of ST stages in shared memory, ST - 1 stages in
// flight while the block multiplies the oldest, one barrier a stage. fp32
// keeps the chain rule above on SIMT FMAs; bf16 runs on the tensor cores.

struct ProjArgs {
  const void* x;
  const void* w;
  const float* b;
  void* y;
  int M, K, N, dtype, act;
};

// An fp32 tile: BM x BN outputs, BK of k a stage, ST stages. A thread owns
// TM rows x TN columns, in runs of RV = min(TM, 4) rows (CV columns) that
// lie RT RV rows (CT CV columns) apart, so a warp's reads of the staged
// tiles are broadcasts or distinct consecutive words. w is staged as it
// lies (k rows of BN). x is staged either transposed (k rows of BM, by
// 4-byte copies; KX false: one float4 read gives 4 rows of one k) or as
// it lies (rows of BK, by 16-byte copies; KX true: one float4 read gives
// 4 k of one row). Rows are padded by 4 floats.
template <int BM_, int BN_, int TM_, int TN_, int BK_, int ST_, int MINB_,
          bool KX_>
struct F32Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr int ST = ST_, MINB = MINB_;
  static constexpr bool KX = KX_, kBf16 = false;
  // A launch takes this tile from a wave of blocks, one an SM (the last
  // tile of a list takes any); measured, 64 x 64 tiles beat the small
  // ones from half a wave on, as at (1024, 432, 432) (wave_of).
  static constexpr bool kHalfWave = BM < 128;
  static constexpr int RV = TM < 4 ? TM : 4, CV = TN < 4 ? TN : 4;
  static constexpr int RT = BM / TM, CT = BN / TN;  // threads along M, N
  static constexpr int kThreads = RT * CT;
  static constexpr int LDA = KX ? BK + 4 : BM + 4, LDB = BN + 4;
  static constexpr int kA = KX ? BM * LDA : BK * LDA;  // floats a stage
  static constexpr int kB = BK * LDB;
  static constexpr size_t smem = sizeof(float) * ST * (kA + kB);
  static_assert(BM * BK % (4 * kThreads) == 0 &&
                    BK * BN % (4 * kThreads) == 0 && BK % 4 == 0,
                "a stage's copies split evenly over the threads");
};
// Large M: 8 x 8 outputs a thread, x transposed.
using F32Big = F32Tile<128, 128, 8, 8, 16, 3, 2, false>;  // 256 threads
using F32Mid = F32Tile<64, 64, 4, 4, 16, 4, 1, false>;    // 256
// Small M: a thread 1 row x 2 columns (two chains), 4 k of its row in one
// read; a warp 4 rows x 16 columns, so a k row of w is 8 distinct float2.
// 64 k a stage: the fewer barriers and stage switches, the faster.
using F32Row = F32Tile<8, 16, 1, 2, 64, 4, 1, true>;  // 64
// #3 under 16 columns (the boundary's N 10): half the w copies of
// F32Row's 16-wide tile (measured on the H100: 7.37 us against 8.19 at
// (32, 432) -> 10; 8 x 8 took 8.93, 32 x 8 7.45).
using F32Narrow = F32Tile<16, 8, 1, 2, 64, 4, 1, true>;  // 64
// The fused encode at large M: 16-row groups, so the last block's eight
// warps encode two rows each; a thread 2 x 2 outputs, 2 stages of 64 k.
using F32Enc = F32Tile<16, 64, 2, 2, 64, 2, 1, false>;  // 256

// The w ring of an fp32 tile T with w of type WT as it lies (fp32, or
// bf16 for #3, widened on the read): k rows of BN padded by 16 bytes.
template <class T, class WT>
struct WRing {
  static constexpr int LD = T::BN + 16 / static_cast<int>(sizeof(WT));
  static constexpr int kSlot = T::BK * LD;  // elements a stage
  static constexpr size_t bytes = sizeof(WT) * T::ST * kSlot;
};

// x's part of stage t into ring slot t % ST: x[m0 + m][k0 + kk] at
// As[kk][m] (or As[m][kk] with KX), zeros outside x. VEC: 16-byte copies
// where rows run along the copy.
template <class T, bool VEC>
__device__ __forceinline__ void stage_x(float* As, const ProjArgs& a, int m0,
                                        int t) {
  const int k0 = t * T::BK;
  As += (t % T::ST) * T::kA;
  const float* x = static_cast<const float*>(a.x);
  if constexpr (T::KX && VEC) {
#pragma unroll
    for (int i = 0; i < T::BM * T::BK / (4 * T::kThreads); ++i) {
      const int idx = threadIdx.x + i * T::kThreads;
      const int m = idx / (T::BK / 4), kk = idx % (T::BK / 4) * 4;
      const bool ok = m0 + m < a.M && k0 + kk < a.K;
      cp_async_16(As + m * T::LDA + kk,
                  ok ? x + static_cast<size_t>(m0 + m) * a.K + k0 + kk : x,
                  ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < T::BM * T::BK / T::kThreads; ++i) {
      const int idx = threadIdx.x + i * T::kThreads;
      const int kk = idx % T::BK, m = idx / T::BK;  // lanes along k: coalesced
      const bool ok = m0 + m < a.M && k0 + kk < a.K;
      cp_async_4(As + (T::KX ? m * T::LDA + kk : kk * T::LDA + m),
                 ok ? x + static_cast<size_t>(m0 + m) * a.K + k0 + kk : x, ok);
    }
  }
}

// w's part of stage t into ring slot t % ST: w[k0 + kk][n0 + n] at
// Bs[kk][n], zeros outside w. VEC: 16-byte copies (rows of N on 16
// bytes); else 4-byte copies (fp32) or element loads (bf16).
template <class T, bool VEC, class WT>
__device__ __forceinline__ void stage_w(WT* Bs, const void* wp, int K, int N,
                                        int n0, int t) {
  using R = WRing<T, WT>;
  constexpr int E = 16 / sizeof(WT);  // elements a 16-byte copy
  const int k0 = t * T::BK;
  Bs += (t % T::ST) * R::kSlot;
  const WT* w = static_cast<const WT*>(wp);
  if constexpr (VEC) {
    constexpr int kCopies = T::BK * T::BN / E;
#pragma unroll
    for (int i = 0; i < (kCopies + T::kThreads - 1) / T::kThreads; ++i) {
      const int idx = threadIdx.x + i * T::kThreads;
      if (kCopies % T::kThreads != 0 && idx >= kCopies) break;
      const int kk = idx / (T::BN / E), n = idx % (T::BN / E) * E;
      const bool ok = k0 + kk < K && n0 + n < N;
      cp_async_16(Bs + kk * R::LD + n,
                  ok ? w + static_cast<size_t>(k0 + kk) * N + n0 + n : w, ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < T::BK * T::BN / T::kThreads; ++i) {
      const int idx = threadIdx.x + i * T::kThreads;
      const int kk = idx / T::BN, n = idx % T::BN;
      const bool ok = k0 + kk < K && n0 + n < N;
      if constexpr (sizeof(WT) == 4) {
        cp_async_4(Bs + kk * R::LD + n,
                   ok ? w + static_cast<size_t>(k0 + kk) * N + n0 + n : w, ok);
      } else {
        Bs[kk * R::LD + n] = ok ? w[static_cast<size_t>(k0 + kk) * N + n0 + n]
                                : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// acc[i][j] = fmaf(A[row i][k], w[k][col j], acc[i][j]) for the stage's k
// in ascending order; a partial last stage stops at kn, adding no term.
// A lies as T::KX says, its rows (KX) or k rows (else) lda apart; B is the
// stage's slot of the w ring.
template <class T, class WT>
__device__ __forceinline__ void steps_f32(float (&acc)[T::TM][T::TN],
                                          const float* As, int lda,
                                          const WT* Bs, int kn) {
  constexpr int LDB = WRing<T, WT>::LD;
  constexpr int RG = T::TM / T::RV, CG = T::TN / T::CV;  // runs a thread
  const int tx = threadIdx.x % T::CT, ty = threadIdx.x / T::CT;
  auto row = [&](int i) { return (i / T::RV * T::RT + ty) * T::RV + i % T::RV; };
  const WT* bc = Bs + tx * T::CV;  // this thread's first column
  // av[g][r] is row g RT RV + ty RV + r at k row kk.
  auto fma_k = [&](const float (&av)[RG][T::RV], int kk) {
    float bv[CG][T::CV];
#pragma unroll
    for (int h = 0; h < CG; ++h)
      read_vec(bv[h], bc + kk * LDB + h * T::CT * T::CV);
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j)
        acc[i][j] = fmaf(av[i / T::RV][i % T::RV], bv[j / T::CV][j % T::CV],
                         acc[i][j]);
  };
  auto step = [&](int kk) {
    float av[RG][T::RV];
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
      av[i / T::RV][i % T::RV] =
          T::KX ? As[row(i) * lda + kk] : As[kk * lda + row(i)];
    fma_k(av, kk);
  };
  if (kn != T::BK) {
    for (int kk = 0; kk < kn; ++kk) step(kk);
  } else if constexpr (T::KX) {
    // 4 k of each row in one read, then those 4 k in order.
#pragma unroll
    for (int k4 = 0; k4 < T::BK; k4 += 4) {
      float a4[T::TM][4];
#pragma unroll
      for (int i = 0; i < T::TM; ++i) read_vec(a4[i], As + row(i) * lda + k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float av[RG][T::RV];
#pragma unroll
        for (int i = 0; i < T::TM; ++i) av[i / T::RV][i % T::RV] = a4[i][q];
        fma_k(av, k4 + q);
      }
    }
  } else {
    const float* ar = As + ty * T::RV;  // this thread's first row
#pragma unroll
    for (int kk = 0; kk < T::BK; ++kk) {
      float av[RG][T::RV];
#pragma unroll
      for (int g = 0; g < RG; ++g)
        read_vec(av[g], ar + kk * lda + g * T::RT * T::RV);
      fma_k(av, kk);
    }
  }
}

// The fp32 main loop and epilogue: one tile, (blockIdx.x, blockIdx.y), of
// y = act(A @ w + b) into a.y (fp32), over K = a.K. `src` says where
// stage t's tiles come from: src.stage(t) fills ring slot t % ST (cp.async
// copies, which land by the barrier of step t); src.prologue() runs once
// the first ST - 1 stages are in flight; src.a_at(t), src.lda() and
// src.b_at(t) give stage t's A, its stride and its w slot. With IDLE the
// block has more threads than the tile (the fused encode's 256): those
// keep the barriers and nothing else. vec_y: float4 stores (N % 4 == 0, y
// on 16 bytes).
template <class T, bool IDLE, class Src>
__device__ __forceinline__ void f32_tile(const ProjArgs& a, const Src& src,
                                         bool vec_y) {
  const bool work = !IDLE || threadIdx.x < T::kThreads;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int nk = (a.K + T::BK - 1) / T::BK;
#pragma unroll
  for (int t = 0; t < T::ST - 1; ++t) {
    if (work && t < nk) src.stage(t);
    cp_async_commit();
  }
  src.prologue();
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<T::ST - 2>();  // stage t has landed (this thread's copies)
    __syncthreads();             // ... everyone's; slot (t - 1) % ST is free
    if (work && t + T::ST - 1 < nk) src.stage(t + T::ST - 1);
    cp_async_commit();
    if (work)
      steps_f32<T>(acc, src.a_at(t), src.lda(), src.b_at(t),
                   min(T::BK, a.K - t * T::BK));
  }
  if (!work) return;
  const int tx = threadIdx.x % T::CT, ty = threadIdx.x / T::CT;
  float* y = static_cast<float*>(a.y);
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int m = m0 + (i / T::RV * T::RT + ty) * T::RV + i % T::RV;
    if (m >= a.M) continue;
#pragma unroll
    for (int h = 0; h < T::TN / T::CV; ++h) {
      const int n = n0 + (h * T::CT + tx) * T::CV;
      float v[T::CV];
#pragma unroll
      for (int j = 0; j < T::CV; ++j)
        v[j] = n + j < a.N ? bias_act(acc[i][h * T::CV + j], a.b, n + j, a.act)
                           : 0.f;
      float* o = y + static_cast<size_t>(m) * a.N + n;
      if constexpr (T::CV == 4) {
        if (vec_y) {  // N % 4 == 0: all four or none
          if (n < a.N)
            *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < T::CV; ++j)
        if (n + j < a.N) o[j] = v[j];
    }
  }
}

// #4's source: x and w both through the ring.
template <class T, bool VEC>
struct XRing {
  const ProjArgs& a;
  float* As;  // ST x kA
  float* Bs;  // ST x kB
  int m0, n0;
  __device__ void stage(int t) const {
    stage_x<T, VEC>(As, a, m0, t);
    stage_w<T, VEC>(Bs, a.w, a.K, a.N, n0, t);
  }
  __device__ void prologue() const {}
  __device__ const float* a_at(int t) const { return As + t % T::ST * T::kA; }
  __device__ int lda() const { return T::LDA; }
  __device__ const float* b_at(int t) const { return Bs + t % T::ST * T::kB; }
};

// One fp32 tile of y = act(x @ w + b) from the ring; IDLE as in f32_tile.
template <class T, bool VEC, bool IDLE>
__device__ __forceinline__ void proj_f32_tile(const ProjArgs& a, float* smem) {
  const XRing<T, VEC> src{a, smem, smem + T::ST * T::kA,
                          static_cast<int>(blockIdx.x) * T::BM,
                          static_cast<int>(blockIdx.y) * T::BN};
  f32_tile<T, IDLE>(a, src, VEC);
}

template <class T, bool VEC>
__global__ void __launch_bounds__(T::kThreads, T::MINB)
    proj_f32_kernel(ProjArgs a) {
  extern __shared__ float smem[];
  proj_f32_tile<T, VEC, false>(a, smem);
}

// A bf16 tile: BM x BN outputs of WM x WN warps, BK 32 of k a stage, ST
// stages. A warp owns MI m16 blocks x 2 NJ n8 blocks of mma.sync
// m16n8k16 with fp32 accumulators. x (BM x BK) and w (BK x BN) are staged
// as they lie, rows padded by 16 bytes so ldmatrix is conflict-free: the A
// fragments by ldmatrix.x4 from x's rows, the B fragments by
// ldmatrix.x4.trans from w's k rows (w is k x n row-major, as V is in
// attention's P V).
template <int BM_, int BN_, int WM_, int WN_, int ST_, int MINB_>
struct BfTile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, ST = ST_;
  static constexpr int MINB = MINB_, BK = 32;
  static constexpr bool kBf16 = true;
  static constexpr bool kHalfWave = false;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int MI = BM / WM / 16, NJ = BN / WN / 16;
  static constexpr int LDA = BK + 8, LDB = BN + 8;
  static constexpr size_t smem =
      sizeof(__nv_bfloat16) * ST * (BM * LDA + BK * LDB);
  static_assert(MI >= 1 && NJ >= 1, "a warp owns whole 16 x 16 blocks");
  static_assert(BM * BK % (8 * kThreads) == 0 && BK * BN % (8 * kThreads) == 0,
                "a stage's 16-byte copies split evenly over the threads");
};
using BfBig = BfTile<128, 128, 2, 4, 4, 2>;  // 256 threads, a warp 64 x 32
using BfRow32 = BfTile<32, 32, 2, 2, 6, 1>;  // 128, a warp 16 x 16
using BfRow16 = BfTile<16, 32, 1, 2, 8, 1>;  // 64, a warp 16 x 16

// Stage t of the bf16 tile into ring slot t % ST: As[m][kk] = x[m0 + m]
// [k0 + kk], Bs[kk][n] = w[k0 + kk][n0 + n], zeros outside x and w. VEC:
// 16-byte copies (K and N multiples of 8, x and w on 16 bytes); else one
// element at a time through registers.
template <class T, bool VEC>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* As,
                                           __nv_bfloat16* Bs,
                                           const ProjArgs& a, int m0, int n0,
                                           int t) {
  const int k0 = t * T::BK;
  As += (t % T::ST) * T::BM * T::LDA;
  Bs += (t % T::ST) * T::BK * T::LDB;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < T::BM * T::BK / (8 * T::kThreads); ++i) {
      const int idx = threadIdx.x + i * T::kThreads;
      const int m = idx / (T::BK / 8), kk = idx % (T::BK / 8) * 8;
      const bool ok = m0 + m < a.M && k0 + kk < a.K;
      cp_async_16(As + m * T::LDA + kk,
                  ok ? x + static_cast<size_t>(m0 + m) * a.K + k0 + kk : x,
                  ok);
    }
#pragma unroll
    for (int i = 0; i < T::BK * T::BN / (8 * T::kThreads); ++i) {
      const int idx = threadIdx.x + i * T::kThreads;
      const int kk = idx / (T::BN / 8), n = idx % (T::BN / 8) * 8;
      const bool ok = k0 + kk < a.K && n0 + n < a.N;
      cp_async_16(Bs + kk * T::LDB + n,
                  ok ? w + static_cast<size_t>(k0 + kk) * a.N + n0 + n : w,
                  ok);
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int idx = threadIdx.x; idx < T::BM * T::BK; idx += T::kThreads) {
      const int m = idx / T::BK, kk = idx % T::BK;
      As[m * T::LDA + kk] =
          m0 + m < a.M && k0 + kk < a.K
              ? x[static_cast<size_t>(m0 + m) * a.K + k0 + kk] : zero;
    }
    for (int idx = threadIdx.x; idx < T::BK * T::BN; idx += T::kThreads) {
      const int kk = idx / T::BN, n = idx % T::BN;
      Bs[kk * T::LDB + n] =
          k0 + kk < a.K && n0 + n < a.N
              ? w[static_cast<size_t>(k0 + kk) * a.N + n0 + n] : zero;
    }
  }
}

// One bf16 tile of y into a.y: bf16, or with F32 the fp32 bias_act value
// before its rounding (the fused encode's y). IDLE as in proj_f32_tile.
template <class T, bool VEC, bool F32, bool IDLE>
__device__ __forceinline__ void proj_bf16_tile(const ProjArgs& a, float* smem) {
  const bool work = !IDLE || threadIdx.x < T::kThreads;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // ST x BM x LDA
  __nv_bfloat16* Bs = As + T::ST * T::BM * T::LDA;             // ST x BK x LDB
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wr = warp / T::WN * T::MI * 16;  // the warp's first row, column
  const int wc = warp % T::WN * T::NJ * 16;
  const int nk = (a.K + T::BK - 1) / T::BK;
#pragma unroll
  for (int t = 0; t < T::ST - 1; ++t) {
    if (work && t < nk) stage_bf16<T, VEC>(As, Bs, a, m0, n0, t);
    cp_async_commit();
  }
  float acc[T::MI][2 * T::NJ][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < 2 * T::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<T::ST - 2>();
    __syncthreads();
    if (work && t + T::ST - 1 < nk)
      stage_bf16<T, VEC>(As, Bs, a, m0, n0, t + T::ST - 1);
    cp_async_commit();
    if (!work) continue;
    const __nv_bfloat16* as = As + (t % T::ST) * T::BM * T::LDA;
    const __nv_bfloat16* bs = Bs + (t % T::ST) * T::BK * T::LDB;
#pragma unroll
    for (int kb = 0; kb < T::BK; kb += 16) {
      uint32_t af[T::MI][4];
#pragma unroll
      for (int i = 0; i < T::MI; ++i)
        ldmatrix_x4(af[i], as + (wr + i * 16 + (lane & 15)) * T::LDA + kb +
                               (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < T::NJ; ++j) {
        uint32_t bf[4];  // n8 blocks wc + 16 j and wc + 16 j + 8, k kb..kb+15
        ldmatrix_x4_trans(bf, bs + (kb + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                       T::LDB +
                                   wc + j * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < T::MI; ++i) {
          mma_bf16(acc[i][2 * j], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  if (!work) return;
  // Lane 4 g + q holds rows g and g + 8, columns 2 q and 2 q + 1 of each
  // 16 x 8 accumulator.
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < T::MI; ++i)
#pragma unroll
    for (int j = 0; j < 2 * T::NJ; ++j) {
      const int n = n0 + wc + j * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wr + i * 16 + g + 8 * h;
        if (m >= a.M || n >= a.N) continue;
        const float v0 = bias_act(acc[i][j][2 * h], a.b, n, a.act);
        const size_t off = static_cast<size_t>(m) * a.N + n;
        if constexpr (F32) {
          float* o = static_cast<float*>(a.y) + off;
          o[0] = v0;
          if (n + 1 < a.N) o[1] = bias_act(acc[i][j][2 * h + 1], a.b, n + 1, a.act);
        } else {
          __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.y) + off;
          if (n + 1 < a.N && a.N % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(
                v0, bias_act(acc[i][j][2 * h + 1], a.b, n + 1, a.act));
          } else {
            o[0] = __float2bfloat16_rn(v0);
            if (n + 1 < a.N)
              o[1] = __float2bfloat16_rn(
                  bias_act(acc[i][j][2 * h + 1], a.b, n + 1, a.act));
          }
        }
      }
    }
}

template <class T, bool VEC>
__global__ void __launch_bounds__(T::kThreads, T::MINB)
    proj_bf16_kernel(ProjArgs a) {
  extern __shared__ float smem[];
  proj_bf16_tile<T, VEC, false, false>(a, smem);
}

// ------------------------------------------------------------ #5, #6
//
// y in #4's tiles and main loop, written to an fp32 scratch y; the last of
// a row group's N / BN column tiles to arrive encodes the group's rows
// with encode_row, a row a warp, on as many of its warps as have room for
// a row's buffers (a.teams). Blocks have 256 threads, so 8 rows of a
// group are encoded at once; a smaller tile's own threads run #4's main
// loop, the others only keep its barriers.

struct EncArgs {
  const void* x;
  const void* w;
  const float* b;
  const float* e;
  float* y;      // (M, N) fp32 scratch
  int* count;    // a counter per row group, 0 between calls
  int M, K, dtype, act;
  int teams;     // warps that encode, each with its c and scratch
  Params p;      // p.d is N
};

template <class T, bool VEC, int S, bool EF>
__global__ void __launch_bounds__(kThreads, 1) proj_encode_kernel(EncArgs a) {
  extern __shared__ float smem[];
  __shared__ int last;
  const int N = a.p.d;
  const ProjArgs pa{a.x, a.w, a.b, a.y, a.M, a.K, N, a.dtype, a.act};
  if constexpr (T::kBf16) {
    proj_bf16_tile<T, VEC, true, true>(pa, smem);
  } else {
    proj_f32_tile<T, VEC, true>(pa, smem);
  }
  __threadfence();  // this tile of y is visible before it arrives
  __syncthreads();
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(a.count + blockIdx.x, 1);
    last = prev == static_cast<int>(gridDim.y) - 1;
    if (last) a.count[blockIdx.x] = 0;  // ready for the next call on this stream
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Every tile of the group has landed; the ring is free for the rows' c
  // and scratch.
  const int warp = threadIdx.x / 32;
  if (warp >= a.teams) return;
  const int m0 = blockIdx.x * T::BM;
  const int rows = min(T::BM, a.M - m0);
  float* c = smem + warp * team_floats(S, N, a.p.n);
  for (int r = warp; r < rows; r += a.teams) {
    const size_t row = static_cast<size_t>(m0) + r;
    encode_row<S, EF, 32>(a.p, a.y + row * N, EF ? a.e + row * N : nullptr,
                          c, c + pad4(N), nullptr, row);
  }
}

// ---------------------------------------------------------------- #3
//
// #4's main loop with the block's decoded payload rows as A: resident
// (RES: decoded once, in the prologue) or, where they do not fit, a
// stage's k slice decoded into the A slot of the ring.

struct DecArgs {
  const void* in0;
  const void* in1;
  const void* w;
  const float* b;
  float* y;
  int M, N, act;
  bool vec_w;  // 16-byte w copies: N a multiple of 16 bytes' elements, w on 16
  bool vec_y;  // float4 y stores: N % 4 == 0, y on 16 bytes
  Params p;    // p.d is the payload's fusion dim, the K of the product
};

// The stride of a resident row on a KX tile: d padded to 16 bytes, plus
// the 4 floats that pad a stage's rows.
__host__ __device__ inline int dec_ld(int d) { return static_cast<int>(pad4(d)) + 4; }

// A's shared floats: the resident rows (BM rows of dec_ld on KX tiles, d
// k rows of LDA on the others) or the A ring.
template <class T, bool RES>
__host__ __device__ inline size_t dec_a_floats(int d) {
  if (!RES) return static_cast<size_t>(T::ST) * T::kA;
  return T::KX ? static_cast<size_t>(T::BM) * dec_ld(d)
               : static_cast<size_t>(d) * T::LDA;
}

template <class T, class WT, bool RES>
size_t dec_smem(int d) {
  return sizeof(float) * dec_a_floats<T, RES>(d) + WRing<T, WT>::bytes;
}

// Where element (m, k) of a block's A lies: rows of ld (KX) or k rows of
// T::LDA.
template <class T>
__device__ __forceinline__ int a_pos(int m, int k, int ld) {
  return T::KX ? m * ld + k : k * T::LDA + m;
}

// The block's rows m0 .. m0 + BM - 1 of the payload, decoded into the
// resident A (rows past M zero), all threads over the rows together. A
// top-k row is zeroed, then scattered from its pairs; int8_row and int4
// rows whose bytes split into 8-byte words are read a word a thread, 8
// words in flight.
template <class T, int S>
__device__ void decode_rows(const DecArgs& a, float* As, int ld, int m0) {
  const int d = a.p.d, rows = min(T::BM, a.M - m0);
  const int t = threadIdx.x;
  constexpr int NT = T::kThreads;
  // Item j of a rows x n walk: along the rows' n (KX: a warp's stores go
  // along a row) or down the rows (else: along a k row of A), so the
  // stores to shared memory are conflict-free either way.
  auto row_of = [&](int j, int n) { return T::KX ? j / n : j % rows; };
  auto col_of = [&](int j, int n) { return T::KX ? j % n : j / rows; };
  if (S == kTopK || rows < T::BM) {
    float4* a4 = reinterpret_cast<float4*>(As);
    const int n4 = static_cast<int>(dec_a_floats<T, true>(d) / 4);
    for (int i = t; i < n4; i += NT) a4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }
  if constexpr (S == kTopK) {
    const int k = a.p.n;
    const float* vals = static_cast<const float*>(a.in0) + static_cast<size_t>(m0) * k;
    const int* idx = static_cast<const int*>(a.in1) + static_cast<size_t>(m0) * k;
#pragma unroll 4
    for (int j = t; j < rows * k; j += NT) {
      const int i = __ldg(idx + j);
      if (i >= 0 && i < d) As[a_pos<T>(j / k, i, ld)] = __ldg(vals + j);
    }
    return;
  } else {
    constexpr bool kCodes = S == kInt8Row || S == kInt4;
    const int bytes = S == kInt4 ? (d + 1) / 2 : d;  // a code row's
    if (kCodes && bytes % 8 == 0 &&
        (reinterpret_cast<uintptr_t>(a.in0) & 7) == 0) {
      const int per = bytes / 8;  // words a row
      const uint2* q = reinterpret_cast<const uint2*>(
          static_cast<const uint8_t*>(a.in0) + static_cast<size_t>(m0) * bytes);
      const float* sc = static_cast<const float*>(a.in1) + m0;
      constexpr int U = 8;
      for (int j0 = t; j0 < rows * per; j0 += U * NT) {
        uint2 u[U];
        float s[U];
#pragma unroll
        for (int v = 0; v < U; ++v) {
          const int j = j0 + v * NT, r = row_of(j, per), c = col_of(j, per);
          if (j < rows * per) {
            u[v] = __ldg(q + static_cast<size_t>(r) * per + c);
            s[v] = __ldg(sc + r);
          }
        }
#pragma unroll
        for (int v = 0; v < U; ++v) {
          const int j = j0 + v * NT;
          if (j >= rows * per) break;
          const int r = row_of(j, per), c = col_of(j, per);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const unsigned byte = ((e < 4 ? u[v].x : u[v].y) >> (8 * (e & 3))) & 0xFFu;
            if constexpr (S == kInt8Row) {
              As[a_pos<T>(r, 8 * c + e, ld)] =
                  dequant(static_cast<int8_t>(byte), s[v]);
            } else {
              const int i = 16 * c + 2 * e;  // the low nibble's column
              As[a_pos<T>(r, i, ld)] = dequant(static_cast<int>(byte & 0xF) - 8, s[v]);
              if (i + 1 < d)  // an odd d's pad nibble is dropped
                As[a_pos<T>(r, i + 1, ld)] = dequant(static_cast<int>(byte >> 4) - 8, s[v]);
            }
          }
        }
      }
    } else {
#pragma unroll 4
      for (int j = t; j < rows * d; j += NT) {
        const int r = row_of(j, d), i = col_of(j, d);
        As[a_pos<T>(r, i, ld)] =
            decode_at<S>(a.p, a.in0, a.in1, static_cast<size_t>(m0) + r, i);
      }
    }
  }
}

// Stage t's k slice of the block's rows, decoded into A ring slot t % ST
// (zero outside the payload). A top-k slice is zeroed, then the rows'
// pairs whose index falls in it are scattered (a barrier between).
template <class T, int S>
__device__ void decode_slice(const DecArgs& a, float* As, int m0, int t) {
  const int d = a.p.d, k0 = t * T::BK, rows = min(T::BM, a.M - m0);
  As += (t % T::ST) * T::kA;
  if constexpr (S == kTopK) {
    for (int j = threadIdx.x; j < T::BM * T::BK; j += T::kThreads)
      As[a_pos<T>(j / T::BK, j % T::BK, T::LDA)] = 0.f;
    __syncthreads();
    const int k = a.p.n;
    const float* vals = static_cast<const float*>(a.in0) + static_cast<size_t>(m0) * k;
    const int* idx = static_cast<const int*>(a.in1) + static_cast<size_t>(m0) * k;
#pragma unroll 4
    for (int j = threadIdx.x; j < rows * k; j += T::kThreads) {
      const int i = __ldg(idx + j);
      if (i >= k0 && i < k0 + T::BK && i < d)
        As[a_pos<T>(j / k, i - k0, T::LDA)] = __ldg(vals + j);
    }
  } else {
#pragma unroll 4
    for (int j = threadIdx.x; j < T::BM * T::BK; j += T::kThreads) {
      const int m = j / T::BK, kk = j % T::BK;
      As[a_pos<T>(m, kk, T::LDA)] =
          m < rows && k0 + kk < d
              ? decode_at<S>(a.p, a.in0, a.in1, static_cast<size_t>(m0) + m, k0 + kk)
              : 0.f;
    }
  }
}

// #3's source: A the decoded rows, w (fp32 or bf16) through the ring.
template <class T, int S, class WT, bool RES>
struct DecSrc {
  const DecArgs& a;
  float* As;
  WT* Bs;
  int m0, n0, ld;
  __device__ void stage(int t) const {
    if (a.vec_w) {
      stage_w<T, true>(Bs, a.w, a.p.d, a.N, n0, t);
    } else {
      stage_w<T, false>(Bs, a.w, a.p.d, a.N, n0, t);
    }
    if constexpr (!RES) decode_slice<T, S>(a, As, m0, t);
  }
  __device__ void prologue() const {
    if constexpr (RES) decode_rows<T, S>(a, As, ld, m0);
  }
  __device__ const float* a_at(int t) const {
    if constexpr (!RES) return As + t % T::ST * T::kA;
    return As + (T::KX ? t * T::BK : t * T::BK * T::LDA);
  }
  __device__ int lda() const { return RES && T::KX ? ld : T::LDA; }
  __device__ const WT* b_at(int t) const {
    return Bs + t % T::ST * WRing<T, WT>::kSlot;
  }
};

template <class T, int S, class WT, bool RES>
__global__ void __launch_bounds__(T::kThreads, T::MINB)
    decode_proj_kernel(DecArgs a) {
  extern __shared__ float smem[];
  const int d = a.p.d;
  const DecSrc<T, S, WT, RES> src{
      a, smem, reinterpret_cast<WT*>(smem + dec_a_floats<T, RES>(d)),
      static_cast<int>(blockIdx.x) * T::BM, static_cast<int>(blockIdx.y) * T::BN,
      dec_ld(d)};
  const ProjArgs pa{nullptr, a.w, a.b, a.y, a.M, d, a.N, kF32, a.act};
  f32_tile<T, false>(pa, src, a.vec_y);
}

// ------------------------------------------------------------- launch

template <class C>
dim3 grid_of(int M, int N) {
  return dim3((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN);
}

// A grid of tile C at (M, N) gives one block to each of the card's sms
// SMs.
template <class C>
bool fills_card(int M, int N, int sms) {
  const dim3 g = grid_of<C>(M, N);
  return static_cast<long>(g.x) * g.y >= sms;
}

// A grid of tile C at (M, N) reaches the wave from which a launch takes
// C: the card's sms blocks, half of them for tiles under 128 rows.
template <class C>
bool reaches_wave(int M, int N, int sms) {
  const dim3 g = grid_of<C>(M, N);
  return static_cast<long>(g.x) * g.y >= (C::kHalfWave ? sms / 2 : sms);
}

template <class Kernel, class A>
int launch(Kernel kernel, dim3 grid, size_t smem, const A& args,
           cudaStream_t s, int threads = kThreads) {
  if (smem > static_cast<size_t>(kSmemLimit)) return -1;
  if (smem > 48 * 1024 - 256) {  // the default limit counts static arrays too
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<grid, threads, smem, s>>>(args);
  return 0;
}

// #4 with the tile T and 16-byte copies where vec holds.
template <class T>
int launch_proj(const ProjArgs& a, bool vec, cudaStream_t s) {
  const dim3 grid = grid_of<T>(a.M, a.N);
  if constexpr (T::kBf16) {
    return vec ? launch(proj_bf16_kernel<T, true>, grid, T::smem, a, s,
                        T::kThreads)
               : launch(proj_bf16_kernel<T, false>, grid, T::smem, a, s,
                        T::kThreads);
  } else {
    return vec ? launch(proj_f32_kernel<T, true>, grid, T::smem, a, s,
                        T::kThreads)
               : launch(proj_f32_kernel<T, false>, grid, T::smem, a, s,
                        T::kThreads);
  }
}

// The index in a list of tiles (largest first) of the first whose grid
// reaches its wave, else of the last.
template <class T, class... Rest>
int first_in_wave(int M, int N, int sms, int i) {
  if constexpr (sizeof...(Rest) == 0) {
    return i;
  } else {
    return reaches_wave<T>(M, N, sms) ? i
                                      : first_in_wave<Rest...>(M, N, sms, i + 1);
  }
}

// #4's tile: its index in the dtype's list.
int proj_tile(int M, int N, int dtype, int sms) {
  return dtype == kBF16 ? first_in_wave<BfBig, BfRow32, BfRow16>(M, N, sms, 0)
                        : first_in_wave<F32Big, F32Mid, F32Row>(M, N, sms, 0);
}

// #4 on tile i of a list.
template <class T, class... Rest>
int launch_proj_at(int i, const ProjArgs& a, bool vec, cudaStream_t s) {
  if constexpr (sizeof...(Rest) == 0) {
    return launch_proj<T>(a, vec, s);
  } else {
    return i == 0 ? launch_proj<T>(a, vec, s)
                  : launch_proj_at<Rest...>(i - 1, a, vec, s);
  }
}

// The fused encode on the tile T, 16-byte copies where vec holds. All 8
// warps encode where their rows' buffers fit in T's ring or in 48 KB,
// else as many as fit (at least one).
template <class T, int S, bool EF>
int launch_encode_tile(EncArgs a, bool vec, cudaStream_t s) {
  const size_t team = sizeof(float) * team_floats(S, a.p.d, a.p.n);
  const size_t room = T::smem > 48 * 1024 ? T::smem : 48 * 1024;
  const size_t fit = room / team;
  a.teams = static_cast<int>(fit < 1 ? 1 : fit > kThreads / 32 ? kThreads / 32 : fit);
  const size_t enc = a.teams * team;
  const size_t smem = enc > T::smem ? enc : T::smem;
  const dim3 grid = grid_of<T>(a.M, a.p.d);
  return vec ? launch(proj_encode_kernel<T, true, S, EF>, grid, smem, a, s)
             : launch(proj_encode_kernel<T, false, S, EF>, grid, smem, a, s);
}

// The encode's tiles: bf16 #4's 16 x 32 mma.sync tile (0, its only one);
// fp32 a 16 x 64 tile (0) where that fills the card, else #4's 8 x 16 tile
// (1) (16-row groups: the encode of a group, not the product, sets the
// time at large M). tile >= 0 asks for that tile (a tuned launch plan);
// -1 where the launch does not take it.
int encode_tile(int M, int N, int dtype, int tile, int sms) {
  if (dtype == kBF16) return tile <= 0 ? 0 : -1;
  if (tile >= 0) return tile <= 1 ? tile : -1;
  return fills_card<F32Enc>(M, N, sms) ? 0 : 1;
}

template <int S, bool EF>
int launch_encode(const EncArgs& a, int tile, int sms, cudaStream_t s) {
  auto on16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int K = a.K, N = a.p.d;
  const int t = encode_tile(a.M, N, a.dtype, tile, sms);
  if (t < 0) return -1;
  if (a.dtype == kBF16)
    return launch_encode_tile<BfRow16, S, EF>(
        a, K % 8 == 0 && N % 8 == 0 && on16(a.x) && on16(a.w), s);
  const bool vec = K % 4 == 0 && N % 4 == 0 && on16(a.x) && on16(a.w) && on16(a.y);
  return t == 0 ? launch_encode_tile<F32Enc, S, EF>(a, vec, s)
                : launch_encode_tile<F32Row, S, EF>(a, vec, s);
}

template <bool EF>
int launch_encode_scheme(int scheme, const EncArgs& a, int tile, int sms,
                         cudaStream_t s) {
  switch (scheme) {
    case kInt8Row: return launch_encode<kInt8Row, EF>(a, tile, sms, s);
    case kInt4: return launch_encode<kInt4, EF>(a, tile, sms, s);
    case kTopK: return launch_encode<kTopK, EF>(a, tile, sms, s);
    case kSketch: return launch_encode<kSketch, EF>(a, tile, sms, s);
    default: return -1;
  }
}

template <class T, int S, class WT, bool RES>
int launch_dec(const DecArgs& a, cudaStream_t s) {
  return launch(decode_proj_kernel<T, S, WT, RES>, grid_of<T>(a.M, a.N),
                dec_smem<T, WT, RES>(a.p.d), a, s, T::kThreads);
}

// Tile T holds a block's decoded rows of d beside its ring.
template <class T, class WT>
bool dec_fits(int d) {
  return dec_smem<T, WT, true>(d) <= static_cast<size_t>(kSmemLimit);
}

// #3's tiles: #4's list (0 F32Big, 1 F32Mid, 2 F32Row) and F32Narrow (3).
// The rule (tile -1): under 16 columns F32Narrow where its rows fit; else
// the first of #4's list whose grid reaches its wave and whose decoded
// rows fit beside its ring; else F32Row, its rows resident where they
// fit, else decoded a stage at a time. tile >= 0 asks for that tile (a
// tuned launch plan), which must hold its rows (F32Row need not); -1
// where the launch does not take it.
template <class WT>
int decode_tile(int M, int d, int N, int tile, int sms) {
  const bool fit[4] = {dec_fits<F32Big, WT>(d), dec_fits<F32Mid, WT>(d),
                       true, dec_fits<F32Narrow, WT>(d)};
  if (tile >= 0) return tile <= 3 && fit[tile] ? tile : -1;
  if (N < F32Row::BN && fit[3]) return 3;
  if (fit[0] && reaches_wave<F32Big>(M, N, sms)) return 0;
  if (fit[1] && reaches_wave<F32Mid>(M, N, sms)) return 1;
  return 2;
}

template <int S, class WT>
int launch_decode_tiles(const DecArgs& a, int tile, int sms, cudaStream_t s) {
  switch (decode_tile<WT>(a.M, a.p.d, a.N, tile, sms)) {
    case 0: return launch_dec<F32Big, S, WT, true>(a, s);
    case 1: return launch_dec<F32Mid, S, WT, true>(a, s);
    case 2: return dec_fits<F32Row, WT>(a.p.d)
                       ? launch_dec<F32Row, S, WT, true>(a, s)
                       : launch_dec<F32Row, S, WT, false>(a, s);
    case 3: return launch_dec<F32Narrow, S, WT, true>(a, s);
    default: return -1;
  }
}

template <class WT>
int launch_decode_scheme(int scheme, const DecArgs& a, int tile, int sms,
                         cudaStream_t s) {
  switch (scheme) {
    case kInt8Row: return launch_decode_tiles<kInt8Row, WT>(a, tile, sms, s);
    case kInt4: return launch_decode_tiles<kInt4, WT>(a, tile, sms, s);
    case kTopK: return launch_decode_tiles<kTopK, WT>(a, tile, sms, s);
    case kSketch: return launch_decode_tiles<kSketch, WT>(a, tile, sms, s);
    default: return -1;
  }
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
// (topk) or w (sketch). sms is the card's SM count, which sets the tile
// rule; tile (the fused encode's and the decode's) picks a tile of the
// kernel's list (fusion_proj_tile), -1 the rule. Everything runs on
// `stream`; nothing syncs.

// y (M, N) = act(x (M, K) @ w (K, N) + b), in x's dtype.
extern "C" int fusion_proj(const void* x, const void* w, const float* b,
                           void* y, int M, int K, int N, int dtype, int act,
                           int sms, void* stream) {
  if (bad_common(M, K, N, dtype, act) || sms < 1) return -1;
  const ProjArgs a{x, w, b, y, M, K, N, dtype, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto on16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int t = proj_tile(M, N, dtype, sms);
  int rc;
  if (dtype == kBF16) {
    const bool vec = K % 8 == 0 && N % 8 == 0 && on16(x) && on16(w);
    rc = launch_proj_at<BfBig, BfRow32, BfRow16>(t, a, vec, s);
  } else {
    const bool vec = K % 4 == 0 && N % 4 == 0 && on16(x) && on16(w) && on16(y);
    rc = launch_proj_at<F32Big, F32Mid, F32Row>(t, a, vec, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The projection with wire_row.cuh's encode of each row of y (N = the
// fusion dim <= 8192) into out0/out1; with ef, c = y + e and e' into
// e_out. The sketch tables may be null for the other schemes. y (M x N
// fp32) and count (ncount >= ceil(M / 8) ints, all 0; the kernel leaves
// them 0) are scratch.
extern "C" int fusion_proj_encode(int scheme, int ef, const void* x,
                                  const void* w, const float* b,
                                  const float* e, float* y, int* count,
                                  int ncount, int M, int K, int N, int n,
                                  int dtype, int act, float inv_qmax,
                                  float qmax, int clip, float max_ratio,
                                  const float* sign, const float* inv_counts,
                                  const int* hash, const int* order,
                                  const int* ptr, void* out0, void* out1,
                                  float* e_out, int tile, int sms,
                                  void* stream) {
  if (bad_common(M, K, N, dtype, act) || N > kMaxD || sms < 1) return -1;
  if (!y || !count || ncount < (M + F32Row::BM - 1) / F32Row::BM) return -1;
  if ((scheme == kTopK || scheme == kSketch) && (n < 1 || n > N)) return -1;
  if (scheme == kSketch && (!sign || !inv_counts || !hash || !order || !ptr))
    return -1;
  if (ef && (!e || !e_out)) return -1;
  const EncArgs a{x, w, b, e, y, count, M, K, dtype, act, 0,
                  {N, n, inv_qmax, qmax, clip, max_ratio, sign, inv_counts,
                   hash, order, ptr, out0, out1, e_out}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = ef ? launch_encode_scheme<true>(scheme, a, tile, sms, s)
                    : launch_encode_scheme<false>(scheme, a, tile, sms, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The projection with the int8_row encode: q int8 (M, N), scale fp32
// (M, 1). The template of fusion_proj_encode at int8_row, its own entry;
// y and count as there.
extern "C" int fusion_proj_quant(const void* x, const void* w, const float* b,
                                 float* y, int* count, int ncount, int M,
                                 int K, int N, int dtype, int act,
                                 float inv_qmax, void* q, float* scale,
                                 int tile, int sms, void* stream) {
  if (bad_common(M, K, N, dtype, act) || N > kMaxD || sms < 1) return -1;
  if (!y || !count || ncount < (M + F32Row::BM - 1) / F32Row::BM) return -1;
  const EncArgs a{x, w, b, nullptr, y, count, M, K, dtype, act, 0,
                  {N, 0, inv_qmax, 127.f, 0, 0.f, nullptr, nullptr, nullptr,
                   nullptr, nullptr, q, scale, nullptr}};
  const int rc = launch_encode<kInt8Row, false>(
      a, tile, sms, static_cast<cudaStream_t>(stream));
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
                           const int* hash, int tile, int sms,
                           void* stream) {
  if (bad_common(M, d, N, dtype, act) || d > kMaxD || sms < 1) return -1;
  if ((scheme == kTopK || scheme == kSketch) && (n < 1 || n > d)) return -1;
  if (scheme == kSketch && (!sign || !inv_counts || !hash)) return -1;
  auto on16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const DecArgs a{in0, in1, w, b, y, M, N, act,
                  N % (dtype == kBF16 ? 8 : 4) == 0 && on16(w),
                  N % 4 == 0 && on16(y),
                  {d, n, 0.f, 0.f, 0, 0.f, sign, inv_counts, hash, nullptr,
                   nullptr, nullptr, nullptr, nullptr}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      dtype == kBF16
          ? launch_decode_scheme<__nv_bfloat16>(scheme, a, tile, sms, s)
          : launch_decode_scheme<float>(scheme, a, tile, sms, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The tile a launch takes, as its index in the kernel's list, or -1
// where it takes none (launches nothing): op 0 fusion_proj (tile -1
// only), 1 the fused encode (N the fusion dim), 2 decode_proj (K the
// fusion dim d, dtype w's).
extern "C" int fusion_proj_tile(int op, int M, int K, int N, int dtype,
                                int tile, int sms) {
  if (bad_common(M, K, N, dtype, kNone) || sms < 1) return -1;
  switch (op) {
    case 0: return tile == -1 ? proj_tile(M, N, dtype, sms) : -1;
    case 1: return N > kMaxD ? -1 : encode_tile(M, N, dtype, tile, sms);
    case 2:
      if (K > kMaxD) return -1;
      return dtype == kBF16 ? decode_tile<__nv_bfloat16>(M, K, N, tile, sms)
                            : decode_tile<float>(M, K, N, tile, sms);
    default: return -1;
  }
}
