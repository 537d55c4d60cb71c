// Backward of the tape-driven covariance assembly: the gradient with
// respect to the transformed node parameters [M, 3] and the noise of each
// particle. Three entries, one kernel:
//
// - fused with the MVN cotangent, over the lower triangle (the LML
//   gradient, autogp_cov_tape_bwd);
// - the same with the K^-1 tiles formed in the kernel from L^-1 (the LML
//   gradient's in-tape L^-1 backend, autogp_cov_tape_bwd_linv);
// - unfused, for a given cotangent Kbar [P, N, N] of the assembled matrix
//   (autogp_cov_tape_bwd_unfused, the backward of cov_matrix_diff).
//
// Replaces: autogp_tpu/ops/cov_pallas_vjp.py, _bwd_kernel_tape, launched
// there by _cov_grads_tape: fused=True, sym=True under lml_tape_fused's
// backward (with linv=True when INTAPE_LINV is set), and beta=None
// (kbar_ref holds the cotangent) under cov_matrix_diff's.
//
// What it computes: for particle p with tape (slot, type, lpos, rpos, len)
// from ops/cov.py build_tape, every element (i, j) of a lower tile forms
// its cotangent
//   kbar = 0.5 g (beta_i beta_j - Kinv_ij) m_i m_j w_ij,
//   w = 2 below the diagonal, 1 on it, 0 above
// (Kinv lower-only, from the kinv kernel), runs the tape forward to store
// every position's value, then backward in reverse post-order (parents
// before children) to propagate adjoints and add each leaf's and
// ChangePoint's d K_ij / d theta, times its adjoint, into theta's slot;
// kbar on the diagonal goes to the noise. out[p] = [pbar (M x 3), nbar].
// The formulas are the reference's guarded ones (cov_pallas_vjp.py:
// 313-523): GammaExponential and Periodic recover their exponent from the
// stored value with a clamped log, ChangePoint is a sigmoid, and pi / p is
// a true division (cov_formulas.cuh, shared with the per-slot backward
// cov_slot_bwd.cu).
//
// The in-tape L^-1 entry takes V = L^-1 [P, N, N] (exact zeros above the
// diagonal, kinv.cu's autogp_linv_beta) in place of K^-1. Before its
// sweeps each block forms the K^-1 elements its threads own, K^-1[i, j] =
// sum_{r >= 32 ti} V[r, i] V[r, j] (exact: V[r, i] = 0 for r < i), from
// the two column strips V[32 ti:, ti-tile] and V[32 ti:, tj-tile] staged
// through shared memory in K-steps of 32 rows, with IEEE FP32 FMA in
// ascending r (kinv.cu's kinv_lower_kernel adds the same products in the
// same order, so the two K^-1 agree bit for bit); the cotangent is then
// formed as in the fused entry. K^-1 never exists in device memory. The
// contraction costs 2 * 32^2 * (N - 32 ti) FP32 operations per tile, ~0.39
// GFLOP per particle at N = 1024 (25 GFLOP at P = 64, 0.37 ms at 67
// TFLOP/s), against 4 MB of V per particle read once: this entry is bound
// by those operations. The staging strips reuse the memory of the value
// and adjoint stacks, idle until the sweeps, and the K^-1 tile takes 4 KB
// more, so a block's shared memory and occupancy stay the fused entry's
// (97 KB at M = 31, two blocks per SM). Each thread keeps 32 / RY partial
// sums in registers (Q, a template argument picked from blockDim.y).
//
// The unfused entry reads kbar = Kbar_ij (times m_i m_j when `masked`)
// from its input instead: no symmetry is assumed, every tile of the matrix
// is visited with weight 1, and N need not be a multiple of the tile (edge
// threads run on a clamped element with cotangent 0, so that every warp
// reduction stays full).
//
// What bounds it on this card: FP32 arithmetic and transcendentals, not
// memory. Each lower element reads 4 bytes of Kinv and runs two sweeps of
// the tape (~5-15 instructions, each a few exp/log/sin plus a warp
// reduction per gradient term); at [64, 1024, 1024] that is 33.6 M
// elements, ~134 MB read.
//
// What the design does about it: one block per (particle, lower 32 x 32
// tile) -- tiles wholly above the diagonal are never launched -- and one
// thread per element column, RY rows of threads each stepping over 32 / RY
// rows. The tape and parameters sit in shared memory, so every instruction
// is a broadcast read and its accumulator index slot * 3 + k is uniform
// across the block. Values (float) and adjoints (double) live in shared
// memory laid out [tape position][thread] (no bank conflicts, no
// dynamically indexed per-thread arrays in local memory): M * 12 * 256 B
// = 93 KB at M = 31, above the 48 KB default, so the launch opts in. Each
// gradient term is summed over the warp by xor shuffles and added by lane 0
// into the warp's row of a double accumulator, warps are summed in order
// into per-tile partials [P, n_tiles, 3M + 1], and a second small pass sums
// the tiles of each particle in order. No atomics: gradients repeat bit
// for bit from run to run.
//
// Precision: the gradient is a sum of ~5e5 terms per particle at N = 1024
// that cancel heavily when the gram is ill-conditioned (beta beta^T and
// K^-1 are both large where their difference is not). So the cotangent is
// formed in double from the float32 inputs (the product of two floats is
// exact in double), adjoints are carried in double, and every sum is in
// double; only the tree's values and derivative factors are float32, each
// with its own relative rounding.

#include "cov_formulas.cuh"

namespace {

using namespace autogp;

// Bytes of the value and adjoint stacks [M][T]; with LINV at least the
// two 32 x 32 staging strips of the K^-1 contraction, which run before the
// sweeps and share that memory.
__host__ __device__ inline int stack_bytes(int M, int T, bool linv) {
  const int stacks = M * T * 12;
  const int staging = 2 * kTile * kTile * (int)sizeof(float);
  return (linv && stacks < staging) ? staging : stacks;
}

// K^-1[i, j] = sum_{r >= 32 ti} V[r, i] V[r, j] for the Q rows i = 32 ti +
// ty + (32 / Q) q of thread (ty, tx) and column j = 32 tj + tx, into
// kinv_t[i - 32 ti][tx]. V's strips pass through sa and sb, 32 rows at a
// time; the products are added in ascending r by fmaf.
template <int Q>
__device__ void kinv_tile(const float* __restrict__ vp, int N, int ti,
                          int tj, float* sa, float* sb, float* kinv_t) {
  constexpr int RY = kTile / Q;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  float acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = 0.0f;
  for (int r0 = ti * kTile; r0 < N; r0 += kTile) {
    for (int e = tid; e < kTile * kTile; e += kTile * RY) {
      const long long row = (long long)(r0 + e / kTile) * N + e % kTile;
      sa[e] = vp[row + ti * kTile];
      sb[e] = vp[row + tj * kTile];
    }
    __syncthreads();
    for (int k = 0; k < kTile; ++k) {
      const float b = sb[k * kTile + tx];
#pragma unroll
      for (int q = 0; q < Q; ++q)
        acc[q] = fmaf(sa[k * kTile + ty + RY * q], b, acc[q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) kinv_t[(ty + RY * q) * kTile + tx] = acc[q];
}

// Threads of a block are (32 columns) x RY rows; the thread count T and
// the warp count come from blockDim. FUSED: `kmat` is the lower-only K^-1
// (with LINV: V = L^-1) and the grid's x runs over the lower tiles;
// otherwise `kmat` is the cotangent itself and x runs over all (N / 32
// rounded up)^2 tiles.
template <bool FUSED, bool LINV>
__global__ void cov_tape_bwd_kernel(
    const int* __restrict__ tslot, const int* __restrict__ ttype,
    const int* __restrict__ tlpos, const int* __restrict__ trpos,
    const int* __restrict__ tlen, const float* __restrict__ params,
    const float* __restrict__ ts, const float* __restrict__ mask,
    const float* __restrict__ kmat, const float* __restrict__ beta,
    const float* __restrict__ gscale, double* __restrict__ partial, int M,
    int N, int masked) {
  extern __shared__ double smem_d[];
  const int T = blockDim.x * blockDim.y;
  const int nwarps = T / 32;
  const int n_acc = 3 * M + 1;
  double* wacc = smem_d;                                  // [nwarps][n_acc]
  double* adj = wacc + nwarps * n_acc;                    // [M][T]
  float* val = reinterpret_cast<float*>(adj + M * T);     // [M][T]
  float* s_par = reinterpret_cast<float*>(                // [3M]
      reinterpret_cast<char*>(adj) + stack_bytes(M, T, LINV));
  int* s_slot = reinterpret_cast<int*>(s_par + 3 * M);    // [M] each
  int* s_type = s_slot + M;
  int* s_l = s_type + M;
  int* s_r = s_l + M;
  float* kinv_t = reinterpret_cast<float*>(s_r + M);      // LINV: [32][32]

  const int p = blockIdx.y;
  const int lin = blockIdx.x;
  int ti, tj;
  if (FUSED) {
    // Lower tile (ti, tj <= ti) of linear index lin = ti (ti + 1) / 2 + tj.
    ti = (int)((sqrtf(8.0f * (float)lin + 1.0f) - 1.0f) * 0.5f);
    while ((ti + 1) * (ti + 2) / 2 <= lin) ++ti;
    while (ti * (ti + 1) / 2 > lin) --ti;
    tj = lin - ti * (ti + 1) / 2;
  } else {
    const int nt = (N + kTile - 1) / kTile;
    ti = lin / nt;
    tj = lin - ti * nt;
  }

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  const int warp = tid / 32, lane = tid % 32;
  for (int k = tid; k < M; k += T) {
    s_slot[k] = tslot[(long long)p * M + k];
    s_type[k] = ttype[(long long)p * M + k];
    s_l[k] = tlpos[(long long)p * M + k];
    s_r[k] = trpos[(long long)p * M + k];
  }
  for (int k = tid; k < 3 * M; k += T)
    s_par[k] = params[(long long)p * 3 * M + k];
  for (int k = tid; k < nwarps * n_acc; k += T) wacc[k] = 0.0;
  __syncthreads();

  const int len = tlen[p];
  const float* kp = kmat + (long long)p * N * N;
  const bool diag_tile = (ti == tj);
  // The fused entry takes N a multiple of the tile, so the clamps bind in
  // the unfused entry only.
  const int j_raw = tj * kTile + tx;
  const int j = FUSED ? j_raw : min(j_raw, N - 1);
  const float t2 = ts[j];
  const float mj = mask[j];
  const WarpAcc acc{wacc + warp * n_acc, lane};

  if (LINV) {
    float* sa = reinterpret_cast<float*>(adj);   // staging, before sweeps
    float* sb = sa + kTile * kTile;
    switch (blockDim.y) {
      case 8: kinv_tile<4>(kp, N, ti, tj, sa, sb, kinv_t); break;
      case 4: kinv_tile<8>(kp, N, ti, tj, sa, sb, kinv_t); break;
      case 2: kinv_tile<16>(kp, N, ti, tj, sa, sb, kinv_t); break;
      default: kinv_tile<32>(kp, N, ti, tj, sa, sb, kinv_t); break;
    }
  }

  for (int rr = ty; rr < kTile; rr += blockDim.y) {
    const int i_raw = ti * kTile + rr;
    const int i = FUSED ? i_raw : min(i_raw, N - 1);
    const Elem e(ts[i], t2);

    // Cotangent of this element, in the reference's operation order.
    double kb;
    if (FUSED) {
      const double g = gscale[p];
      const float* bp = beta + (long long)p * N;
      const double kij =
          (i >= j) ? (LINV ? kinv_t[rr * kTile + tx] : kp[(long long)i * N + j])
                   : 0.0f;
      kb = (0.5 * g) * ((double)bp[i] * (double)bp[j] - kij);
      kb = kb * (double)(mask[i] * mj);
      const double w = (i > j) ? 2.0 : ((i == j) ? 1.0 : 0.0);
      kb = kb * w;
    } else {
      kb = (i_raw < N && j_raw < N) ? (double)kp[(long long)i * N + j] : 0.0;
      if (masked) kb = kb * (double)(mask[i] * mj);
    }
    if (diag_tile) acc(n_acc - 1, (i_raw == j_raw) ? kb : 0.0);

    // Forward sweep: the value of every tape position.
    for (int q = 0; q < len; ++q) {
      const float* pr = s_par + 3 * s_slot[q];
      const int t = s_type[q];
      val[q * T + tid] =
          is_op(t) ? ref_op_value(t, pr, val[s_l[q] * T + tid],
                                  val[s_r[q] * T + tid], e)
                   : ref_leaf_value(t, pr, e);
    }

    // Reverse sweep: adjoints, and the gradient terms.
    if (len > 0) adj[(len - 1) * T + tid] = kb;
    for (int k = 0; k < len; ++k) {
      const int q = len - 1 - k;
      const int s = s_slot[q];
      const int t = s_type[q];
      const float* pr = s_par + 3 * s;
      const double a = adj[q * T + tid];
      if (is_op(t)) {
        double al, ar;
        ref_op_adjoint(t, pr, val[s_l[q] * T + tid], val[s_r[q] * T + tid], a,
                       e, 3 * s, al, ar, acc);
        adj[s_l[q] * T + tid] = al;
        adj[s_r[q] * T + tid] = ar;
      } else {
        ref_leaf_grad(t, pr, val[q * T + tid], a, e, 3 * s, acc);
      }
    }
  }
  __syncthreads();

  // Warps in order into this tile's partial.
  double* out = partial + ((long long)p * gridDim.x + lin) * n_acc;
  for (int k = tid; k < n_acc; k += T) {
    double s = 0.0;
    for (int w = 0; w < nwarps; ++w) s += wacc[w * n_acc + k];
    out[k] = s;
  }
}

// Shared memory of one block with RY thread rows, in bytes.
int bwd_smem_bytes(int M, int ry, bool linv) {
  const int T = 32 * ry;
  const int n_acc = 3 * M + 1;
  return (ry * n_acc) * 8 + stack_bytes(M, T, linv) + 3 * M * 4 + 4 * M * 4 +
         (linv ? kTile * kTile * 4 : 0);
}

template <bool FUSED, bool LINV>
int launch(const void* tslot, const void* ttype, const void* tlpos,
           const void* trpos, const void* tlen, const void* params,
           const void* ts, const void* mask, const void* kmat,
           const void* beta, const void* g, void* partial, void* out, int P,
           int M, int N, int masked, int n_tiles, void* stream) {
  const int ry = bwd_thread_rows(M);
  const int smem = bwd_smem_bytes(M, ry, LINV);
  cudaError_t err = cudaFuncSetAttribute(
      cov_tape_bwd_kernel<FUSED, LINV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  auto s = (cudaStream_t)stream;
  cov_tape_bwd_kernel<FUSED, LINV>
      <<<dim3(n_tiles, P), dim3(32, ry), smem, s>>>(
      (const int*)tslot, (const int*)ttype, (const int*)tlpos,
      (const int*)trpos, (const int*)tlen, (const float*)params,
      (const float*)ts, (const float*)mask, (const float*)kmat,
      (const float*)beta, (const float*)g, (double*)partial, M, N, masked);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_tiles_kernel<<<P, 128, 0, s>>>((const double*)partial, (float*)out,
                                        n_tiles, 3 * M + 1);
  return (int)cudaGetLastError();
}

}  // namespace

// Tapes [P, M] int32 (slot, type, lpos, rpos) and lengths [P]; params
// [P, M, 3], ts and mask [N], kinv [P, N, N] lower-only, beta [P, N],
// g [P], all float32; partial scratch [P, n_lower_tiles, 3M + 1] float64;
// out [P, 3M + 1] float32. N must be a multiple of 32.
extern "C" int autogp_cov_tape_bwd(
    const void* tslot, const void* ttype, const void* tlpos,
    const void* trpos, const void* tlen, const void* params, const void* ts,
    const void* mask, const void* kinv, const void* beta, const void* g,
    void* partial, void* out, int P, int M, int N, void* stream) {
  if (M < 1 || M > kMaxSlots || N % kTile != 0 || P < 1)
    return (int)cudaErrorInvalidValue;
  const int nt = N / kTile;
  return launch<true, false>(tslot, ttype, tlpos, trpos, tlen, params, ts,
                             mask, kinv, beta, g, partial, out, P, M, N, 1,
                             nt * (nt + 1) / 2, stream);
}

// The arguments of autogp_cov_tape_bwd, with V = L^-1 [P, N, N] (exact
// zeros above the diagonal) in place of K^-1.
extern "C" int autogp_cov_tape_bwd_linv(
    const void* tslot, const void* ttype, const void* tlpos,
    const void* trpos, const void* tlen, const void* params, const void* ts,
    const void* mask, const void* linv, const void* beta, const void* g,
    void* partial, void* out, int P, int M, int N, void* stream) {
  if (M < 1 || M > kMaxSlots || N % kTile != 0 || P < 1)
    return (int)cudaErrorInvalidValue;
  const int nt = N / kTile;
  return launch<true, true>(tslot, ttype, tlpos, trpos, tlen, params, ts,
                            mask, linv, beta, g, partial, out, P, M, N, 1,
                            nt * (nt + 1) / 2, stream);
}

// The same tapes, params, ts and mask; kbar [P, N, N] float32, the
// cotangent of the assembled matrix, multiplied by mask_i mask_j when
// `masked`; partial scratch [P, ceil(N / 32)^2, 3M + 1] float64; out
// [P, 3M + 1] float32. Any N >= 1.
extern "C" int autogp_cov_tape_bwd_unfused(
    const void* tslot, const void* ttype, const void* tlpos,
    const void* trpos, const void* tlen, const void* params, const void* ts,
    const void* mask, const void* kbar, void* partial, void* out, int P,
    int M, int N, int masked, void* stream) {
  if (M < 1 || M > kMaxSlots || N < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  const int nt = (N + kTile - 1) / kTile;
  return launch<false, false>(tslot, ttype, tlpos, trpos, tlen, params, ts,
                              mask, kbar, nullptr, nullptr, partial, out, P,
                              M, N, masked, nt * nt, stream);
}
