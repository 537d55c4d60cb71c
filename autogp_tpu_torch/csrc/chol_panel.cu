// Cholesky factor and triangular inverse of one diagonal panel per particle.
//
// Replaces: autogp_tpu/ops/chol_pallas.py, _panel_kernel (launched there by
// _panel_factor inside _factor_driver), together with the tri_inv_blocked
// call the driver made right after it (the per-panel Wd = Lkk^-1).
//
// What it computes: for each particle p, the lower Cholesky factor L of the
// B x B block A[p] (1 <= B <= 128; only the lower triangle of A is read,
// since the lower_only assembly leaves zeros above it) and W = L^-1, both
// written lower-triangular with exact zeros above the diagonal. The
// blocked driver in ops/chol.py does the rest with plain IEEE-f32 matmuls,
// as the JAX package did in XLA: L21 = A21 W^T, the trailing update and
// the forward solve alpha = L^-1 x.
//
// Failure is NaN, never a clamp: a pivot that is not > 0 (or is NaN) gives
// a NaN diagonal, which propagates into every later column, into W and from
// there into the driver's diag(L) and alpha. The SMC initialisation retry
// and the reweight clamp rely on that NaN.
//
// What bounds it on this card: latency, not flops or bytes (~B^3/3 flops
// and 192 KB per particle at B = 128; 64 particles fill 64 of 132 SMs). A
// Cholesky factor is a chain of B dependent pivots, and its inverse
// another chain behind them; a column at a time, each pivot costs block
// barriers, and a row-by-row inverse is a serial chain of ~B^2/2 steps.
// Depth: nothing here depends on the trees (it factors their grams).
//
// What the design does about it: a blocked recurrence over sub-panels of
// kW = 16 columns, as the reference's own panel kernel used sub-panels
// (chol_pallas.py:79-110), with the inverse folded into the same sweep.
// For sub-panel k (columns k0 .. k0 + w), three barrier-separated phases:
//   A. warp 0 factors the w x w diagonal block in registers (lane i holds
//      row i, lane 16 + i column i of its inverse; pivots and columns
//      travel by shuffles, one shuffle per pivot in the chain, 1 / L[j][j]
//      by rsqrt and a Newton step: no division, no branch and no block
//      barrier in it); meanwhile
//      the other 15 warps form T = L[k0:k0+w, 0:k0] W[0:k0, 0:k0] for the
//      inverse's block row k, in 2 x 4 register tiles;
//   B. the rows below are solved against the diagonal block, L21 = A21
//      Winv^T (a product, not a substitution), into LT, the transposed
//      factor; W's block row k = -Winv T; L's finished rows go out;
//   C. L21 goes back into the panel and the trailing lower triangle takes
//      the rank-w update, each thread a 4 x 4 register tile fed by float4
//      reads of LT; W's finished rows go out.
// That is 3 barriers per 16 columns (24 at B = 128), and the pivot chain
// is one warp's. The warp index reaches the branch through a shuffle, so
// the compiler knows it is uniform and warp 0's shuffles stay plain SHFLs.
// All products are IEEE f32 FMA on CUDA cores: they are too small for
// tensor cores, and the value path keeps f32 (backend.py). One block per
// particle keeps the panel, L^T, W and the strips in shared memory (207 KB
// at B = 128, above the 48 KB default, so the launch opts in with
// cudaFuncSetAttribute), every row 132 floats: rows are read and written as
// float4s, 8 lanes of a warp on 8 rows touch 32 different banks. The panel
// is loaded by cp.async (every load in flight at once) and the outputs are
// stored as their rows finish. Every
// sum runs in a fixed order and there are no atomics: results repeat bit
// for bit. A B that is not a multiple of kW (or is below it) ends on a
// narrower sub-panel, which warp 0 factors as the w x w block bordered by
// the identity.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxB = 128;
constexpr int kW = 16;             // sub-panel width
constexpr int kThreads = 512;      // 16 warps
constexpr int kLdT = kMaxB + 4;    // row stride of every array (16-byte rows)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// Rows r0 .. r1 - 1 of the lower triangle of M (row stride ldm) to out
// [B][B], zeros above the diagonal: warp w takes rows r0 + w, r0 + w + 16,
// ..., its lanes the columns.
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float* M, int ldm, int B,
                                           int r0, int r1) {
  for (int r = r0 + threadIdx.x / 32; r < r1; r += kThreads / 32)
    for (int c = threadIdx.x % 32; c < B; c += 32)
      out[(size_t)r * B + c] = (c <= r) ? M[r * ldm + c] : 0.0f;
}

// Warp 0: factor and invert the w x w diagonal block at (k0, k0) of S,
// writing L into S, Winv into W (all w x w entries, the exact zeros above
// the diagonal included) and Winv^T into WiT [kW][kW]. Lane i < 16 holds
// row i of the block, lane 16 + i column i of Winv (x = L^-1 e_i); a
// block narrower than kW is bordered by the identity.
__device__ void factor_diag_block(float* S, float* W, float* WiT,
                                  int k0, int w) {
  const int lane = threadIdx.x & 31;
  const int i = lane & (kW - 1);
  const bool is_row = lane < kW;
  float v[kW];
  const float* row = S + (size_t)(k0 + i) * kLdT + k0;
#pragma unroll
  for (int c = 0; c < kW; ++c)
    v[c] = (is_row && i < w && c < w) ? (c <= i ? row[c] : 0.0f)
                                      : (c == i ? 1.0f : 0.0f);
  // Right-looking Cholesky of the rows and, in the same sweep, the
  // right-looking substitution of the columns of Winv, which takes the
  // same shuffled column of L at each step: both are v[c] -= v[j] L[c][j].
  // rs = 1 / L[j][j] from rsqrt and one Newton step: no division and no
  // branch in the chain. What lands above a row's diagonal is never read
  // (a row's column j is read from lanes >= j only).
  float piv = __shfl_sync(kFull, v[0], 0);
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    float rs = rsqrtf(piv);
    rs = rs * fmaf(-0.5f * piv * rs, rs, 1.5f);
    rs = piv > 0.0f ? rs : qnan();
    v[j] = (lane == j) ? piv * rs : v[j] * rs;
    // The next pivot, lane j + 1's v[j + 1] after this step's update,
    // fetched before the update runs: one shuffle per step in the chain.
    if (j + 1 < kW)
      piv = __shfl_sync(kFull, fmaf(-v[j], v[j], v[j + 1]), j + 1);
#pragma unroll
    for (int c = j + 1; c < kW; ++c)
      v[c] = fmaf(-v[j], __shfl_sync(kFull, v[j], c), v[c]);
  }
  if (i < w) {
    if (is_row) {
      float* out = S + (size_t)(k0 + i) * kLdT + k0;
#pragma unroll
      for (int c = 0; c < kW; ++c)
        if (c <= i) out[c] = v[c];
    } else {
#pragma unroll
      for (int r = 0; r < kW; ++r)
        if (r < w) {
          W[(size_t)(k0 + r) * kLdT + k0 + i] = v[r];
          WiT[i * kW + r] = v[r];
        }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
chol_panel_kernel(const float* __restrict__ A, long long batch_stride,
                  long long row_stride, float* __restrict__ Lout,
                  float* __restrict__ Wout, int B) {
  extern __shared__ __align__(16) float smem[];
  float* LT = smem;                 // [B][kLdT]: LT[m][r] = L[r][m], r below
                                    //   m's diagonal block
  float* W = LT + B * kLdT;         // [B][kLdT]: L^-1
  float* T = W + B * kLdT;          // [kW][kLdT]: T[i][c], c < k0
  float* WiT = T + kW * kLdT;       // [kW][kW]: Winv^T of the current block
  float* S = WiT + kW * kW;         // [B][kLdT]: the panel, then its factor L

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const float* Ap = A + (size_t)p * batch_stride;
  float* Lp = Lout + (size_t)p * B * B;
  float* Wp = Wout + (size_t)p * B * B;

  // Load the lower triangle (nothing above it is ever read) by 4-byte
  // cp.async copies, all in flight at once (A may be any strided view):
  // warp w takes rows w, w + 16, ..., its lanes the columns.
  // The warp index through a shuffle: the compiler then knows it is
  // uniform across the warp, and warp 0's shuffles below compile to plain
  // SHFLs instead of the divergence-safe collective sequence.
  const int warp = __shfl_sync(kFull, tid / 32, 0), lane = tid % 32;
  for (int r = warp; r < B; r += kThreads / 32)
    for (int c = lane; c <= r; c += 32)
      cp_async4(S + r * kLdT + c, Ap + (size_t)r * row_stride + c);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int k0 = 0; k0 < B; k0 += kW) {
    const int w = min(kW, B - k0);
    const int t0 = k0 + w;          // first row below the diagonal block
    const int nr = B - t0;          // rows below

    // ---- A: the diagonal block (warp 0) and T (warps 1..15) ----------
    if (warp == 0) {
      factor_diag_block(S, W, WiT, k0, w);
    } else {
      // T[i][c] = sum_{c <= m < k0} L[k0 + i][m] W[m][c] in 2 x 4 tiles
      // (rows 2 ig, 2 ig + 1; columns 4 cg ..); W[m][c] = 0 for m < c.
      // Rows i >= w of a narrow last block are computed and never used.
      for (int e = tid - 32; e < 2 * k0; e += kThreads - 32) {
        const int ig = e % 8, c0 = 4 * (e / 8);
        float acc[2][4] = {};
#pragma unroll 4
        for (int m = c0; m < k0; ++m) {
          const float2 l = *reinterpret_cast<const float2*>(
              LT + m * kLdT + k0 + 2 * ig);
          const float4 wv = *reinterpret_cast<const float4*>(W + m * kLdT + c0);
          const float lv[2] = {l.x, l.y};
          const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(lv[u], wc[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
          *reinterpret_cast<float4*>(T + (2 * ig + u) * kLdT + c0) =
              make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      }
    }
    __syncthreads();

    // ---- B: the rows below, and W's block row -------------------------
    // (rows k0 .. t0 of L are final: they go out now)
    store_rows(Lp, S, kLdT, B, k0, t0);
    const float* Wkk = W + (size_t)k0 * kLdT + k0;
    const int n1 = nr * (kW / 4);
    for (int e = tid; e < n1 + w * (k0 / 4); e += kThreads) {
      if (e < n1) {
        // LT[k0 + j][r] = sum_{m <= j} A[r][k0 + m] Winv[j][m], j = 4 jg ..;
        // the terms m > j add Winv's exact zeros, so every item runs the
        // same unrolled kW-deep loop. Rows below mean w = kW.
        const int jg = e / nr, r = t0 + e % nr;
        float av[kW];
#pragma unroll
        for (int q = 0; q < kW / 4; ++q) {
          const float4 a4 = *reinterpret_cast<const float4*>(
              S + (size_t)r * kLdT + k0 + 4 * q);
          av[4 * q] = a4.x;
          av[4 * q + 1] = a4.y;
          av[4 * q + 2] = a4.z;
          av[4 * q + 3] = a4.w;
        }
        float acc[4] = {};
#pragma unroll
        for (int m = 0; m < kW; ++m) {
          const float4 wv = *reinterpret_cast<const float4*>(WiT + m * kW + 4 * jg);
          acc[0] = fmaf(av[m], wv.x, acc[0]);
          acc[1] = fmaf(av[m], wv.y, acc[1]);
          acc[2] = fmaf(av[m], wv.z, acc[2]);
          acc[3] = fmaf(av[m], wv.w, acc[3]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) LT[(k0 + 4 * jg + u) * kLdT + r] = acc[u];
      } else {
        // W[k0 + i][c] = -sum_{m <= i} Winv[i][m] T[m][c], c = 4 cg ..;
        // for a full block the terms m > i add Winv's exact zeros (one
        // unrolled kW-deep loop), past a narrow last block they stop.
        const int e2 = e - n1;
        const int i = e2 / (k0 / 4), c0 = 4 * (e2 % (k0 / 4));
        float acc[4] = {};
        auto term = [&](int m) {
          const float wv = Wkk[i * kLdT + m];
          const float4 tv = *reinterpret_cast<const float4*>(T + m * kLdT + c0);
          acc[0] = fmaf(wv, tv.x, acc[0]);
          acc[1] = fmaf(wv, tv.y, acc[1]);
          acc[2] = fmaf(wv, tv.z, acc[2]);
          acc[3] = fmaf(wv, tv.w, acc[3]);
        };
        if (w == kW) {
#pragma unroll
          for (int m = 0; m < kW; ++m) term(m);
        } else {
          for (int m = 0; m <= i; ++m) term(m);
        }
        *reinterpret_cast<float4*>(W + (size_t)(k0 + i) * kLdT + c0) =
            make_float4(-acc[0], -acc[1], -acc[2], -acc[3]);
      }
    }
    if (nr == 0) break;             // the last sub-panel: nothing below
    __syncthreads();

    // ---- C: L21 into the panel, the trailing rank-kW update ------------
    // (rows k0 .. t0 of W are final: they go out now)
    store_rows(Wp, W, kLdT, B, k0, t0);
    for (int e = tid; e < (kW / 4) * nr; e += kThreads) {
      const int q = e / nr, r = t0 + e % nr;
      const float* lt = LT + (k0 + 4 * q) * kLdT + r;
      *reinterpret_cast<float4*>(S + (size_t)r * kLdT + k0 + 4 * q) =
          make_float4(lt[0], lt[kLdT], lt[2 * kLdT], lt[3 * kLdT]);
    }
    // 4 x 4 tiles (ti, tj <= ti) of the trailing lower triangle; rows and
    // columns at or past B are computed from unused LT entries and dropped.
    const float* Lt = LT + k0 * kLdT;
    const int nt = (nr + 3) / 4;
    for (int e = tid; e < nt * (nt + 1) / 2; e += kThreads) {
      int ti = (int)((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
      while (ti * (ti + 1) / 2 > e) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= e) ++ti;
      const int tj = e - ti * (ti + 1) / 2;
      const int r0 = t0 + 4 * ti, c0 = t0 + 4 * tj;
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 s4 = r0 + u < B ? *reinterpret_cast<const float4*>(
                                           S + (size_t)(r0 + u) * kLdT + c0)
                                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        acc[u][0] = s4.x;
        acc[u][1] = s4.y;
        acc[u][2] = s4.z;
        acc[u][3] = s4.w;
      }
#pragma unroll
      for (int m = 0; m < kW; ++m) {
        const float4 lr = *reinterpret_cast<const float4*>(Lt + m * kLdT + r0);
        const float4 lc = *reinterpret_cast<const float4*>(Lt + m * kLdT + c0);
        const float rv[4] = {lr.x, lr.y, lr.z, lr.w};
        const float cv[4] = {lc.x, lc.y, lc.z, lc.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(-rv[u], cv[v], acc[u][v]);
      }
      // Whole float4 rows: what lands above the diagonal (or in the row's
      // padding) is never read.
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r0 + u < B)
          *reinterpret_cast<float4*>(S + (size_t)(r0 + u) * kLdT + c0) =
              make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
    __syncthreads();
  }
  __syncthreads();
  // The last sub-panel's rows of W.
  store_rows(Wp, W, kLdT, B, (B - 1) / kW * kW, B);
}

}  // namespace

extern "C" int autogp_chol_panel(const void* A, long long batch_stride,
                                 long long row_stride, void* L, void* W,
                                 int P, int B, void* stream) {
  if (B < 1 || B > kMaxB) return (int)cudaErrorInvalidValue;
  const int smem =
      (3 * B * kLdT + kW * kLdT + kW * kW) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chol_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chol_panel_kernel<<<P, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)A, batch_stride, row_stride, (float*)L, (float*)W, B);
  return (int)cudaGetLastError();
}
