// L^-1 by block forward substitution, with beta = L^-T alpha, ||L^-1||_F^2
// and (optionally) the lower block-rows of K^-1 = L^-T L^-1.
//
// Replaces: autogp_tpu/ops/kinv_pallas.py, _kernel, in both of its
// launches on the HMC path: _launch(want_kinv=False, wd=...) behind
// linv_stats_wd (noise HMC) and _launch_strips behind kinv_beta_strips
// (every LML gradient). One kernel family serves both; the strips form is
// the in-place factor L written by ops/chol.py's driver.
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
//
// What bounds it on this card: FP32 operations. At [64, 1024, 1024] the
// substitution is ~N^3/3 and K^-1 another ~N^3/3 multiply-adds per
// particle: 45.8 GFLOP with K^-1 (22.9 without) against 67 TFLOP/s, i.e.
// 0.68 ms (0.34 ms), above the ~0.57 GB of traffic (0.17 ms at 3.35 TB/s).
//
// What the design does about it: the TPU kernel kept a whole particle's
// factor in VMEM (4 MB at N = 1024); a Hopper block has 227 KB, so instead
// every (particle, column block j) gets its own block -- 512 blocks at
// N = 1024, P = 64 -- that walks k = j .. nb-1 with a shared-memory tiled
// FP32 FMA product (16 x 16 threads, a (B/16)^2 register tile per thread,
// K-steps of 16). K^-1 is a second tiled kernel, one block per (particle,
// output block). Contractions are IEEE FP32 FMA, finer than the TPU's
// bf16x3 (dot3); no TF32 tensor cores here. beta and fro are reduced over
// each block's own column strip in a fixed order (fro in double), then a
// one-warp pass sums the nb strip partials of each particle in order, so
// results repeat bit for bit.
//
// The scratch X is written and re-read inside one block, ordered by
// __syncthreads (block-scope visibility of global writes); its pointer is
// never __restrict__, so no load of it takes the read-only cache path.

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

// One block per (column block j, particle p): X[:, j] by substitution,
// then beta over the strip's B columns and the strip's share of fro.
template <int B>
__global__ void __launch_bounds__(kThreads)
linv_kernel(const float* __restrict__ L, const float* __restrict__ Wd,
            const float* __restrict__ alpha, float* X,
            float* __restrict__ beta, double* __restrict__ fro_part,
            int N) {
  __shared__ float sA[kBK * (B + 1)];
  __shared__ float sB[kBK * (B + 1)];
  __shared__ float sbeta[kThreads];
  __shared__ double sfro[kThreads / 32];
  const int nb = N / B;
  const int j = blockIdx.x, p = blockIdx.y;
  const long long NN = (long long)N * N;
  const float* Lp = L + p * NN;
  const float* Wp = Wd + (long long)p * nb * B * B;
  float* Xp = X + p * NN;
  const int c0 = j * B;

  // X[j, j] = Wd[j] (lower triangular; its zeros above come along).
  for (int e = threadIdx.x; e < B * B; e += kThreads)
    Xp[(long long)(c0 + e / B) * N + c0 + e % B] = Wp[(long long)j * B * B + e];
  __syncthreads();

  float acc[B / 16][B / 16];
  for (int k = j + 1; k < nb; ++k) {
    const int r0 = k * B;
    // S = sum_{j<=m<k} L[k, m] X[m, j], parked in X[k, j] ...
    zero<B>(acc);
    gemm_acc<B, false>(Lp + (long long)r0 * N + c0, N,
                       Xp + (long long)c0 * N + c0, N, r0 - c0, acc, sA,
                       sB);
    store<B>(Xp + (long long)r0 * N + c0, N, acc, 1.0f);
    __syncthreads();
    // ... then X[k, j] = -Wd[k] S (all reads of S end before the store).
    zero<B>(acc);
    gemm_acc<B, false>(Wp + (long long)k * B * B, B,
                       Xp + (long long)r0 * N + c0, N, B, acc, sA, sB);
    store<B>(Xp + (long long)r0 * N + c0, N, acc, -1.0f);
    __syncthreads();
  }

  // beta[c] = sum_{r >= c0} X[r, c] alpha[r]; fro over the strip.
  constexpr int G = kThreads / B;  // row groups per column
  const int c = threadIdx.x % B, g = threadIdx.x / B;
  const float* ap = alpha + (long long)p * N;
  float bacc = 0.0f;
  double facc = 0.0;
  for (int r = c0 + g; r < N; r += G) {
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

template <int B>
int launch(const float* L, const float* wd, const float* alpha, float* X,
           float* beta, double* fro_part, float* fro, float* kinv, int P,
           int N, cudaStream_t stream) {
  const int nb = N / B;
  linv_kernel<B><<<dim3(nb, P), kThreads, 0, stream>>>(L, wd, alpha, X,
                                                       beta, fro_part, N);
  cudaError_t err = cudaGetLastError();
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

}  // namespace

// L [P, N, N] lower factor, wd [P, nb, B, B], alpha [P, N]; scratch X
// [P, N, N] f32 and fro_part [P, nb] f64; outputs beta [P, N], fro [P]
// and, when kinv is not null, K^-1 [P, N, N] lower-only. B = min(N, 128)
// must divide N and be 32, 64 or 128.
extern "C" int autogp_kinv(const void* L, const void* wd, const void* alpha,
                           void* X, void* beta, void* fro_part, void* fro,
                           void* kinv, int P, int N, void* stream) {
  const int B = N < 128 ? N : 128;
  if (P < 1 || N % B != 0) return (int)cudaErrorInvalidValue;
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
    case 32: return launch<32>(l, w, a, x, b, fp, f, k, P, N, s);
    case 64: return launch<64>(l, w, a, x, b, fp, f, k, P, N, s);
    case 128: return launch<128>(l, w, a, x, b, fp, f, k, P, N, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
