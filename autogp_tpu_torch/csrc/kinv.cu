// L^-1 by block forward substitution, with beta = L^-T alpha, ||L^-1||_F^2
// and (optionally) the lower block-rows of K^-1 = L^-T L^-1 or L^-1 itself.
//
// Replaces: autogp_tpu/ops/kinv_pallas.py, _kernel, in all of its
// launches: _launch(want_kinv=False, wd=...) behind linv_stats_wd (noise
// HMC), _launch_strips behind kinv_beta_strips (every LML gradient),
// _launch(want_v=True) behind linv_beta (the in-tape L^-1 backend of the
// LML gradient), and the Wd-less entries kinv_beta and linv_stats, whose
// Wd the wrapper computes first (ops/kinv.py). One kernel family serves
// all; the strips form is the in-place factor L written by ops/chol.py's
// driver.
//
// What it computes, per particle p with N = nb * B (B = min(N, 128)):
//   X = L^-1, column block j at a time: X[j, j] = Wd[j] (kernel 2's
//   Lkk^-1) and, for k > j, X[k, j] = -Wd[k] * sum_{j<=m<k} L[k, m] X[m, j]
//   (column block j of L^-1 depends only on column block j of the
//   identity); beta[c] = sum_r X[r, c] alpha[r]; fro = sum X^2 over the
//   lower triangle; and, with K^-1 wanted, block (bi, bj <= bi) of K^-1 as
//   sum_{k >= bi} X[k, bi]^T X[k, bj], strictly-upper blocks written as 0
//   (diagonal blocks dense, as gp_math.kinv_from_linv(lower_only=True),
//   except that the upper triangle of a diagonal block may differ from its
//   mirror by rounding: element (i, j) takes column i as the tensor cores'
//   A operand, (j, i) takes it as B, and nothing reads above the
//   diagonal). X lives in a [P, N, N] scratch the wrapper allocates; only
//   its lower block triangle is ever written or read.
//   With L^-1 wanted (autogp_linv_beta), X is the output V instead, and
//   each block also writes the exact zeros of its strip's strict upper
//   part (the blocks above the diagonal block and the upper triangle of
//   Wd[j]): the in-tape K^-1 tiles of cov_tape_bwd.cu contract whole
//   columns of V and rely on them. beta and fro are computed by the same
//   code as without it, so the two agree bit for bit.
//
// What bounds it on this card: operations. At [64, 1024, 1024] the
// substitution is N^3/3 flops per particle (22.9 GFLOP in all; the blocked
// form does ~1.4x that, the diagonal blocks' Wd products included) and
// K^-1 another N^3/3 (the blocked form: 120 products of 2 x 128^3, 32.2
// GFLOP). Both run on the tensor cores in 3xTF32 (three TF32 products per
// FP32 product, tf32x3.cuh), so each is bound at 3 x 22.9 GFLOP over 495
// TFLOP/s, 0.14 ms. Traffic is ~0.57 GB (0.17 ms at 3.35 TB/s). A
// substitution is a dependent chain: column block j of L^-1
// needs X[k, j] before X[k + 1, j], so a block's time is its strip's
// chain, and strip j's chain grows with nb - 1 - j.
//
// What the design does about it:
// - One block per (particle, strip pair): strip j walks k = j+1 .. nb-1
//   with the left-looking products S = sum_{j<=m<k} L[k, m] X[m, j]
//   (depth (k - j) B, parked in X[k, j]) and X[k, j] = -Wd[k] S, then
//   strip nb-1-j does the same, so each block holds a long and a short
//   chain (at nb = 8 the slowest block is 1.25x the mean; one strip per
//   block would be 2.5x). Blocks are numbered particle-fastest, so all
//   longest pairs are scheduled first.
// - Each 128 x 128 output tile is a product on the tensor cores: 8 warps,
//   each a 64 x 32 tile of mma.sync.m16n8k8 TF32 products with FP32
//   accumulators, in 3xTF32 (tf32x3.cuh's mma_3xtf32).
// - The operands stream through a 5-stage cp.async ring of 32-deep slabs
//   (A 128 x 32, B 32 x 128, 35 KB a stage, 175 KB in all): the next four
//   slabs load while the current one multiplies, one barrier per slab.
//   Shared-memory rows are padded (36 and 136 floats), so every fragment
//   load touches 32 different banks. The strip's Wd copy and its beta and
//   fro sums keep 16 loads in flight per thread.
// - Strips of B < 128 (N = 32, 64) are single blocks, N = B: there is no
//   product, only the Wd copy and the statistics.
// - K^-1 is a second kernel on the tensor cores (kinv_lower_kernel): one
//   block per particle and lower block (bi, bj <= bi), nb (nb + 1) / 2 of
//   them (36 at nb = 8); each strictly-lower block also writes the zeros
//   of its mirror above the diagonal, so no block only writes zeros. Its
//   16 warps each own a 32 x 32 tile (B = 128; 16 x 16 at B = 64, 16 x 8
//   on 8 warps at B = 32) through mma_3xtf32, element (i, j) with column i
//   of X as the A operand: both operands stream from X as [32 rows][B
//   columns] slabs (the A slab read transposed from shared memory),
//   through a 3-stage cp.async ring (104 KB at B = 128), one barrier per
//   slab; a diagonal block stages its one strip once. A fragment's chain
//   starts at its first row (the rows above are zeros of X), 8 rows a
//   chunk in ascending order; each slab's chunks go into a partial from
//   +0 that is then added to the FP32 sum (tf32x3.cuh: the tensor cores'
//   accumulation truncates, and one chain over all rows lost 2.8e-5 at N
//   = 1024). Kernel 5c's in-tape K^-1 tile (cov_tape_bwd.cu) forms every
//   element the same way, so the two gradient backends stay bitwise
//   equal. The two accumulator sets take 64 registers a thread: 16 warps
//   of 32 x 32 tiles keep them under 128, one block per SM. Blocks are
//   numbered particle-fastest in ascending bi, so the longest
//   contractions of the whole batch (small bi, up to 8x the shortest) run
//   first; numbering a particle's blocks together instead (its 4 MB of X
//   in L2 while they run) left a tail of long blocks and ran 9% slower at
//   N = 1024.
// - beta and fro are reduced over each strip in a fixed order (beta by
//   FP32 FMA, fro in double), then a one-warp pass sums the nb strip
//   partials of each particle in order, so results repeat bit for bit and
//   every entry's beta and fro are the same bits.
//
// The scratch X is written and re-read inside one block, ordered by
// __syncthreads (block-scope visibility of global writes, cp.async reads
// included); its pointer is never __restrict__.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using namespace autogp;

constexpr int kThreads = 256;

// ---- 3xTF32 tensor-core tile product (linv_kernel, B = 128) --------------
constexpr int kTB = 128;                  // output tile
constexpr int kSlab = 32;                 // K-depth of one pipeline stage
constexpr int kStages = 5;
constexpr int kLdA = kSlab + 4;           // A slab [128][36]
constexpr int kLdB = kTB + 8;             // B slab [32][136]
constexpr int kStageFloats = kTB * kLdA + kSlab * kLdB;
constexpr int kTcSmem = kStages * kStageFloats * (int)sizeof(float);
constexpr int kU = 16;  // loads in flight per thread in the strip's copy and sums

// Warp w owns rows 64 (w / 4) .. +64 and columns 32 (w % 4) .. +32 of the
// tile: 4 x 4 mma tiles of 16 x 8, 4 accumulators each per thread.
using TcAcc = float[4][4][4];

// Slab k (32 deep) of A [128 x K] (row-major, lda) and Bm [K x 128]
// (row-major, ldb) into one stage: 2 x 1024 16-byte copies, 8 per thread.
__device__ __forceinline__ void load_slab(float* stage, const float* A,
                                          long long lda, const float* Bm,
                                          long long ldb, int k) {
  float* sA = stage;
  float* sB = stage + kTB * kLdA;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int q = threadIdx.x + u * kThreads;
    const int r = q >> 3, c = (q & 7) * 4;
    cp_async16(sA + r * kLdA + c, A + (long long)r * lda + k + c);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int q = threadIdx.x + u * kThreads;
    const int r = q >> 5, c = (q & 31) * 4;
    cp_async16(sB + r * kLdB + c, Bm + (long long)(k + r) * ldb + c);
  }
}

__device__ __forceinline__ void mma_slab(const float* stage, TcAcc& acc) {
  const float* sA = stage;
  const float* sB = stage + kTB * kLdA;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int k8 = 0; k8 < kSlab; k8 += 8) {
    unsigned ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float* a = sA + (wm + mt * 16 + g) * kLdA + k8 + t;
      split_tf32(a[0], ah[mt][0], al[mt][0]);
      split_tf32(a[8 * kLdA], ah[mt][1], al[mt][1]);
      split_tf32(a[4], ah[mt][2], al[mt][2]);
      split_tf32(a[8 * kLdA + 4], ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      frag_b_kn(sB + k8 * kLdB + wn + nt * 8, kLdB, bh[nt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_3xtf32(acc[mt][nt], ah[mt], al[mt], bh[nt], bl[nt]);
  }
}

// acc = A [128 x K] * Bm [K x 128], K a multiple of 32, through the
// kStages-deep cp.async ring in smem. Ends with every copy landed and a
// barrier, so the caller may overwrite what A and Bm point to.
__device__ void gemm_tc(const float* A, long long lda, const float* Bm,
                        long long ldb, int K, TcAcc& acc, float* smem) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  const int nk = K / kSlab;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_slab(smem + s * kStageFloats, A, lda, Bm, ldb, s * kSlab);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();  // slab kt landed for all; slab kt - 1 consumed by all
    const int nxt = kt + kStages - 1;
    if (nxt < nk)
      load_slab(smem + (nxt % kStages) * kStageFloats, A, lda, Bm, ldb,
                nxt * kSlab);
    cp_commit();
    mma_slab(smem + (kt % kStages) * kStageFloats, acc);
  }
  cp_wait<0>();
  __syncthreads();
}

// dst[r][c] = sign * acc for the 128 x 128 tile at dst (leading dim ld).
__device__ __forceinline__ void store_tc(float* dst, long long ld,
                                         const TcAcc& acc, float sign) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* d = dst + (long long)(wm + mt * 16 + g) * ld + wn + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(d) =
          make_float2(sign * acc[mt][nt][0], sign * acc[mt][nt][1]);
      *reinterpret_cast<float2*>(d + 8 * ld) =
          make_float2(sign * acc[mt][nt][2], sign * acc[mt][nt][3]);
    }
}

// Column strip j of particle p: X[:, j] by substitution, then beta over the
// strip's B columns and the strip's share of fro. kWantV: X is the output
// L^-1, and the strip's strict upper part is written as exact zeros.
template <int B, bool kWantV>
__device__ void linv_strip(const float* __restrict__ L,
                           const float* __restrict__ Wd,
                           const float* __restrict__ alpha, float* X,
                           float* __restrict__ beta,
                           double* __restrict__ fro_part, int N, int p, int j,
                           float* smem, float* sbeta, double* sfro) {
  const int nb = N / B;
  const long long NN = (long long)N * N;
  const float* Lp = L + p * NN;
  const float* Wp = Wd + (long long)p * nb * B * B;
  float* Xp = X + p * NN;
  const int c0 = j * B;

  // X[j, j] = Wd[j] (lower triangular; its zeros above come along), kU
  // loads in flight per thread.
  for (int e0 = threadIdx.x; e0 < B * B; e0 += kU * kThreads) {
    float w[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kThreads;
      w[u] = e < B * B ? Wp[(long long)j * B * B + e] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kThreads;
      if (e < B * B)
        Xp[(long long)(c0 + e / B) * N + c0 + e % B] =
            (kWantV && e % B > e / B) ? 0.0f : w[u];
    }
  }
  if (kWantV)
    for (int e = threadIdx.x; e < c0 * B; e += kThreads)
      Xp[(long long)(e / B) * N + c0 + e % B] = 0.0f;
  __syncthreads();

  if constexpr (B == kTB) {
    TcAcc acc;
    for (int k = j + 1; k < nb; ++k) {
      float* Xkj = Xp + (long long)k * B * N + c0;
      // S = sum_{j<=m<k} L[k, m] X[m, j], parked in X[k, j] ...
      gemm_tc(Lp + (long long)k * B * N + c0, N, Xp + (long long)c0 * N + c0,
              N, (k - j) * B, acc, smem);
      store_tc(Xkj, N, acc, 1.0f);
      __syncthreads();
      // ... then X[k, j] = -Wd[k] S (gemm_tc has read all of S on return).
      gemm_tc(Wp + (long long)k * B * B, B, Xkj, N, B, acc, smem);
      store_tc(Xkj, N, acc, -1.0f);
      __syncthreads();
    }
  }

  // beta[c] = sum_{r >= c0} X[r, c] alpha[r]; fro over the strip.
  constexpr int G = kThreads / B;  // row groups per column
  const int c = threadIdx.x % B, g = threadIdx.x / B;
  const float* ap = alpha + (long long)p * N;
  float bacc = 0.0f;
  double facc = 0.0;
  // Rows r = c0 + g, c0 + g + G, ... in order, kU loads in flight.
  int r = c0 + g;
  for (; r + (kU - 1) * G < N; r += kU * G) {
    float v[kU], al[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      v[u] = Xp[(long long)(r + u * G) * N + c0 + c];
      al[u] = ap[r + u * G];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      bacc = fmaf(v[u], al[u], bacc);
      facc += (double)v[u] * (double)v[u];
    }
  }
  for (; r < N; r += G) {
    const float v = Xp[(long long)r * N + c0 + c];
    bacc = fmaf(v, ap[r], bacc);
    facc += (double)v * (double)v;
  }
  sbeta[threadIdx.x] = bacc;
  for (int o = 16; o > 0; o >>= 1)
    facc += __shfl_xor_sync(0xffffffffu, facc, o);
  if (threadIdx.x % 32 == 0) sfro[threadIdx.x / 32] = facc;
  __syncthreads();
  if (threadIdx.x < B) {
    float s = sbeta[threadIdx.x];
    for (int gg = 1; gg < G; ++gg) s += sbeta[gg * B + threadIdx.x];
    beta[(long long)p * N + c0 + threadIdx.x] = s;
  }
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += sfro[w];
    fro_part[(long long)p * nb + j] = s;
  }
}

// One block per (particle p = blockIdx.x, strip pair q = blockIdx.y):
// strip q, then strip nb-1-q (the middle strip of an odd nb alone).
template <int B, bool kWantV>
__global__ void __launch_bounds__(kThreads, 1)
linv_kernel(const float* __restrict__ L, const float* __restrict__ Wd,
            const float* __restrict__ alpha, float* X,
            float* __restrict__ beta, double* __restrict__ fro_part,
            int N) {
  extern __shared__ __align__(16) float smem[];  // gemm_tc's ring (B = 128)
  __shared__ float sbeta[kThreads];
  __shared__ double sfro[kThreads / 32];
  const int nb = N / B;
  const int p = blockIdx.x, q = blockIdx.y;
  linv_strip<B, kWantV>(L, Wd, alpha, X, beta, fro_part, N, p, q, smem, sbeta,
                        sfro);
  if (nb - 1 - q != q)
    linv_strip<B, kWantV>(L, Wd, alpha, X, beta, fro_part, N, p, nb - 1 - q,
                          smem, sbeta, sfro);
}

// ---- K^-1 = X^T X on the lower blocks (kinv_lower_kernel) ---------------
constexpr int kKThreads = 512;  // 16 warps
constexpr int kKStages = 3;     // its cp.async ring

// Block (bi, bj <= bi) of B x B: the warps as a WGM x WGN grid over it,
// warp w a WM x WN tile of MT x NT fragments of 16 x 8 (32 x 32 at B =
// 128; at B = 32 eight warps hold its eight fragments and the others only
// copy). Both operands stream as [32 rows r][B columns] slabs of X (the A
// operand transposed in place: element (i, r) at sA[r][i]), rows padded
// to B + 8 floats (8 mod 32: a fragment load touches 32 banks).
template <int B>
struct KinvTile {
  static constexpr int WGM = B == 32 ? 2 : 4, WGN = 4;
  static constexpr int kWarpsUsed = WGM * WGN;
  static constexpr int WM = B / WGM, WN = B / WGN;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int LD = B + 8;
  static constexpr int kSlabFloats = kSlab * LD;
  static constexpr int kStageFloats = 2 * kSlabFloats;
  static constexpr int kSmem = kKStages * kStageFloats * (int)sizeof(float);
};

// Rows row .. row + 31 of X's columns a0 .. a0 + B - 1 and b0 .. b0 + B - 1
// into one stage (only the first when `diag`: the two are the same).
template <int B>
__device__ __forceinline__ void kinv_load(float* stage, const float* Xp,
                                          int N, int row, int a0, int b0,
                                          bool diag) {
  using G = KinvTile<B>;
  constexpr int kRowChunks = B / 4;  // 16-byte copies per row
  constexpr int kChunks = kSlab * kRowChunks;
#pragma unroll
  for (int q0 = 0; q0 < kChunks; q0 += kKThreads) {
    const int q = q0 + threadIdx.x;
    if (kChunks % kKThreads != 0 && q >= kChunks) break;
    const int r = q / kRowChunks, c = (q % kRowChunks) * 4;
    const float* src = Xp + (long long)(row + r) * N;
    cp_async16(stage + r * G::LD + c, src + a0 + c);
    if (!diag)
      cp_async16(stage + G::kSlabFloats + r * G::LD + c, src + b0 + c);
  }
}

// acc += the slab's products, formed as one partial sum from +0 per
// fragment (mma_3xtf32, 8 rows a chunk) and then added in FP32. `rel` is
// the slab's first row less the block's first row B bi. The chain of a
// fragment starts at its own first row m0 = 16 floor(i / 16): X is lower
// triangular, so the rows above hold zeros of every column i of it.
template <int B>
__device__ __forceinline__ void kinv_slab(
    const float* sA, const float* sB, int rel,
    float (&acc)[KinvTile<B>::MT][KinvTile<B>::NT][4]) {
  using G = KinvTile<B>;
  const int warp = threadIdx.x >> 5;
  if (warp >= G::kWarpsUsed) return;
  const int wm = warp / G::WGN * G::WM, wn = warp % G::WGN * G::WN;
  float part[G::MT][G::NT][4] = {};
#pragma unroll
  for (int k8 = 0; k8 < kSlab; k8 += 8) {
    unsigned bh[G::NT][2], bl[G::NT][2];
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
      frag_b_kn(sB + k8 * G::LD + wn + nt * 8, G::LD, bh[nt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      if (rel + k8 < wm + mt * 16) continue;
      unsigned ah[4], al[4];
      frag_a_km(sA + k8 * G::LD + wm + mt * 16, G::LD, ah, al);
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt)
        mma_3xtf32(part[mt][nt], ah, al, bh[nt], bl[nt]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
}

// One block per (particle, lower block (bi, bj <= bi)): K^-1[bi, bj] =
// sum_{r >= B bi} X[r, bi cols]^T X[r, bj cols] on the tensor cores, and,
// for bj < bi, the zeros of the strictly-upper block (bj, bi). Blocks are
// numbered particle-fastest, lower blocks in ascending bi: the longest
// contractions of the whole batch first.
template <int B>
__global__ void __launch_bounds__(kKThreads, 1)
kinv_lower_kernel(const float* X, float* __restrict__ Kinv, int N, int P) {
  using G = KinvTile<B>;
  extern __shared__ __align__(16) float smem[];
  const int q = blockIdx.x / P, p = blockIdx.x % P;
  int bi = (int)((sqrtf(8.0f * (float)q + 1.0f) - 1.0f) * 0.5f);
  while ((bi + 1) * (bi + 2) / 2 <= q) ++bi;
  while (bi * (bi + 1) / 2 > q) --bi;
  const int bj = q - bi * (bi + 1) / 2;
  const bool diag = bj == bi;
  const long long NN = (long long)N * N;
  const float* Xp = X + p * NN;
  const int row0 = bi * B, nk = (N - row0) / kSlab;

  float acc[G::MT][G::NT][4] = {};
#pragma unroll
  for (int s = 0; s < kKStages - 1; ++s) {
    if (s < nk)
      kinv_load<B>(smem + s * G::kStageFloats, Xp, N, row0 + s * kSlab,
                   bi * B, bj * B, diag);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kKStages - 2>();
    __syncthreads();  // slab kt landed for all; slab kt - 1 consumed by all
    const int nxt = kt + kKStages - 1;
    if (nxt < nk)
      kinv_load<B>(smem + (nxt % kKStages) * G::kStageFloats, Xp, N,
                   row0 + nxt * kSlab, bi * B, bj * B, diag);
    cp_commit();
    const float* st = smem + (kt % kKStages) * G::kStageFloats;
    kinv_slab<B>(st, diag ? st : st + G::kSlabFloats, kt * kSlab, acc);
  }
  cp_wait<0>();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < G::kWarpsUsed) {
    const int g = lane >> 2, t = lane & 3;
    const int wm = warp / G::WGN * G::WM, wn = warp % G::WGN * G::WN;
    float* out = Kinv + p * NN + (long long)row0 * N + bj * B;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        float* d =
            out + (long long)(wm + mt * 16 + g) * N + wn + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(d) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(d + 8 * N) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  }
  if (!diag) {
    float* z = Kinv + p * NN + (long long)bj * B * N + bi * B;
    for (int e = threadIdx.x; e < B * B / 4; e += kKThreads)
      *reinterpret_cast<float4*>(z + (long long)(e / (B / 4)) * N +
                                 e % (B / 4) * 4) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// fro[p] = sum_j fro_part[p, j], in order.
__global__ void fro_sum_kernel(const double* __restrict__ fro_part,
                               float* __restrict__ fro, int P, int nb) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  double s = 0.0;
  for (int j = 0; j < nb; ++j) s += fro_part[(long long)p * nb + j];
  fro[p] = (float)s;
}

template <int B, bool kWantV>
int launch(const float* L, const float* wd, const float* alpha, float* X,
           float* beta, double* fro_part, float* fro, float* kinv, int P,
           int N, cudaStream_t stream) {
  const int nb = N / B;
  const int smem = B == kTB ? kTcSmem : 0;
  cudaError_t err = cudaFuncSetAttribute(
      linv_kernel<B, kWantV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  linv_kernel<B, kWantV><<<dim3(P, (nb + 1) / 2), kThreads, smem, stream>>>(
      L, wd, alpha, X, beta, fro_part, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (kinv != nullptr) {
    constexpr int ksmem = KinvTile<B>::kSmem;
    err = cudaFuncSetAttribute(kinv_lower_kernel<B>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ksmem);
    if (err != cudaSuccess) return (int)err;
    kinv_lower_kernel<B><<<P * (nb * (nb + 1) / 2), kKThreads, ksmem,
                           stream>>>(X, kinv, N, P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  fro_sum_kernel<<<(P + 127) / 128, 128, 0, stream>>>(fro_part, fro, P, nb);
  return (int)cudaGetLastError();
}

template <bool kWantV>
int dispatch(const void* L, const void* wd, const void* alpha, void* X,
             void* beta, void* fro_part, void* fro, void* kinv, int P, int N,
             void* stream) {
  const int B = N < kTB ? N : kTB;
  // B < 128 only for N = B: one strip, no tile product.
  if (P < 1 || N % B != 0 || (B < kTB && N != B))
    return (int)cudaErrorInvalidValue;
  const float* l = (const float*)L;
  const float* w = (const float*)wd;
  const float* a = (const float*)alpha;
  float* x = (float*)X;
  float* b = (float*)beta;
  double* fp = (double*)fro_part;
  float* f = (float*)fro;
  float* k = (float*)kinv;
  auto s = (cudaStream_t)stream;
  switch (B) {
    case 32: return launch<32, kWantV>(l, w, a, x, b, fp, f, k, P, N, s);
    case 64: return launch<64, kWantV>(l, w, a, x, b, fp, f, k, P, N, s);
    case 128: return launch<128, kWantV>(l, w, a, x, b, fp, f, k, P, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// L [P, N, N] lower factor, wd [P, nb, B, B], alpha [P, N]; scratch X
// [P, N, N] f32 and fro_part [P, nb] f64; outputs beta [P, N], fro [P]
// and, when kinv is not null, K^-1 [P, N, N] lower-only. B = min(N, 128)
// must divide N and be 32, 64 or 128.
extern "C" int autogp_kinv(const void* L, const void* wd, const void* alpha,
                           void* X, void* beta, void* fro_part, void* fro,
                           void* kinv, int P, int N, void* stream) {
  return dispatch<false>(L, wd, alpha, X, beta, fro_part, fro, kinv, P, N,
                         stream);
}

// The same inputs and scratch fro_part; outputs V = L^-1 [P, N, N] with
// exact zeros above the diagonal, beta [P, N] and fro [P].
extern "C" int autogp_linv_beta(const void* L, const void* wd,
                                const void* alpha, void* V, void* beta,
                                void* fro_part, void* fro, int P, int N,
                                void* stream) {
  return dispatch<true>(L, wd, alpha, V, beta, fro_part, fro, nullptr, P, N,
                        stream);
}
