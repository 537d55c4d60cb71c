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
//   (diagonal blocks dense-symmetric, as gp_math.kinv_from_linv(
//   lower_only=True)). X lives in a [P, N, N] scratch the wrapper
//   allocates; only its lower block triangle is ever written or read.
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
// K^-1 another N^3/3. The substitution's tile products run on the tensor
// cores in 3xTF32 (three TF32 products per FP32 product, below), so its
// bound is 3 x 22.9 GFLOP over 495 TFLOP/s, 0.14 ms; K^-1 stays on the
// FP32 pipe, 0.34 ms at 67 TFLOP/s. Traffic is ~0.57 GB (0.17 ms at 3.35
// TB/s). A substitution is a dependent chain: column block j of L^-1
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
//   accumulators. Every operand x is split into hi = tf32(x) (round to
//   nearest) and lo = tf32(x - hi), and the tile takes lo*hi' + hi*lo' +
//   hi*hi' (3xTF32): the dropped lo*lo' term is ~2^-22 of the product, so
//   the result is FP32-class (~1e-6 relative), finer than the reference's
//   bf16x3 (dot3). Plain 1xTF32 (about three digits) is never used.
// - The operands stream through a 5-stage cp.async ring of 32-deep slabs
//   (A 128 x 32, B 32 x 128, 35 KB a stage, 175 KB in all): the next four
//   slabs load while the current one multiplies, one barrier per slab.
//   Shared-memory rows are padded (36 and 136 floats), so every fragment
//   load touches 32 different banks. The strip's Wd copy and its beta and
//   fro sums keep 16 loads in flight per thread.
// - Strips of B < 128 (N = 32, 64) are single blocks, N = B: there is no
//   product, only the Wd copy and the statistics.
// - K^-1 is a second kernel on FP32 CUDA cores (kinv_lower_kernel, one
//   block per (particle, output block), a (B/16)^2 register tile per
//   thread); its row order is the one kernel 5c's in-tape K^-1 tile
//   repeats, so the two gradient backends stay bitwise equal.
// - beta and fro are reduced over each strip in a fixed order (beta by
//   FP32 FMA, fro in double), then a one-warp pass sums the nb strip
//   partials of each particle in order, so results repeat bit for bit and
//   every entry's beta and fro are the same bits.
//
// The scratch X is written and re-read inside one block, ordered by
// __syncthreads (block-scope visibility of global writes, cp.async reads
// included); its pointer is never __restrict__.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBK = 16;        // K-step of the tiled product

// acc += A * Bm for one B x B output tile, A [B x K], Bm [K x B], both
// row-major with leading dimensions lda/ldb. kTransA reads A^T instead:
// element (r, k) of the product's left factor is A[k * lda + r]. Thread
// (ty, tx) of the 16 x 16 block owns rows ty + 16 i and columns tx + 16 j.
template <int B, bool kTransA>
__device__ void gemm_acc(const float* A, long long lda, const float* Bm,
                         long long ldb, int K, float (&acc)[B / 16][B / 16],
                         float* sA, float* sB) {
  constexpr int TM = B / 16;
  constexpr int LD = B + 1;  // padded: column walks touch distinct banks
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < B * kBK; e += kThreads) {
      if (kTransA) {
        const int kk = e / B, r = e % B;
        sA[kk * LD + r] = A[(long long)(k0 + kk) * lda + r];
      } else {
        const int r = e / kBK, kk = e % kBK;
        sA[kk * LD + r] = A[(long long)r * lda + k0 + kk];
      }
      const int kb = e / B, c = e % B;
      sB[kb * LD + c] = Bm[(long long)(k0 + kb) * ldb + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sA[kk * LD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TM; ++j) b[j] = sB[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <int B>
__device__ __forceinline__ void zero(float (&acc)[B / 16][B / 16]) {
#pragma unroll
  for (int i = 0; i < B / 16; ++i)
#pragma unroll
    for (int j = 0; j < B / 16; ++j) acc[i][j] = 0.0f;
}

// Store sign * acc into the B x B block at dst (leading dimension ld).
template <int B>
__device__ __forceinline__ void store(float* dst, long long ld,
                                      const float (&acc)[B / 16][B / 16],
                                      float sign) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < B / 16; ++i)
#pragma unroll
    for (int j = 0; j < B / 16; ++j)
      dst[(long long)(ty + 16 * i) * ld + tx + 16 * j] = sign * acc[i][j];
}

// ---- 3xTF32 tensor-core tile product (linv_kernel, B = 128) --------------
constexpr int kTB = 128;                  // output tile
constexpr int kSlab = 32;                 // K-depth of one pipeline stage
constexpr int kStages = 5;
constexpr int kLdA = kSlab + 4;           // A slab [128][36]
constexpr int kLdB = kTB + 8;             // B slab [32][136]
constexpr int kStageFloats = kTB * kLdA + kSlab * kLdB;
constexpr int kTcSmem = kStages * kStageFloats * (int)sizeof(float);
constexpr int kU = 16;  // loads in flight per thread in the strip's copy and sums

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// x = hi + lo + (a remainder ~2^-22 |x|), hi and lo TF32 (round to nearest).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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
    for (int nt = 0; nt < 4; ++nt) {
      const float* b = sB + (k8 + t) * kLdB + wn + nt * 8 + g;
      split_tf32(b[0], bh[nt][0], bl[nt][0]);
      split_tf32(b[4 * kLdB], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma_tf32(acc[mt][nt], al[mt], bh[nt]);
        mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
        mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
      }
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

// One block per (bj, bi, particle): K^-1[bi, bj] = sum_{k >= bi}
// X[k, bi]^T X[k, bj] for bj <= bi, zeros for bj > bi.
template <int B>
__global__ void __launch_bounds__(kThreads)
kinv_lower_kernel(const float* X, float* __restrict__ Kinv, int N) {
  __shared__ float sA[kBK * (B + 1)];
  __shared__ float sB[kBK * (B + 1)];
  const int bj = blockIdx.x, bi = blockIdx.y, p = blockIdx.z;
  const long long NN = (long long)N * N;
  float* out = Kinv + p * NN + (long long)bi * B * N + bj * B;
  float acc[B / 16][B / 16];
  zero<B>(acc);
  if (bj <= bi) {
    const float* Xp = X + p * NN + (long long)bi * B * N;
    gemm_acc<B, true>(Xp + bi * B, N, Xp + bj * B, N, N - bi * B, acc, sA,
                      sB);
  }
  store<B>(out, N, acc, 1.0f);
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
    kinv_lower_kernel<B><<<dim3(nb, nb, P), kThreads, 0, stream>>>(X, kinv,
                                                                    N);
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
