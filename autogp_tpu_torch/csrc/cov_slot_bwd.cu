// Backward of the per-slot covariance assembly (cov_slot.cu): the gradient
// of sum_ij Kbar_ij K_ij with respect to the transformed node parameters
// [M, 3] and the noise of each particle, for a given cotangent Kbar.
//
// Replaces: autogp_tpu/ops/cov_pallas_vjp.py, _bwd_kernel (with its forward
// sweep _fwd_values), launched there by _cov_grads, the backward of
// cov_matrix_diff(tape=False).
//
// What it computes: for particle p with heap node_type[p] ([M] slots,
// children of s at 2s + 1 and 2s + 2, type 0 = empty), every element (i, j)
// takes kbar = Kbar_ij (times m_i m_j when `masked`), sweeps all M slots in
// the static post-order `order` storing each active slot's value, then
// sweeps them in reverse (parents before children) to propagate adjoints
// from the root (slot 0) and add each leaf's and ChangePoint's
// d K_ij / d theta, times its adjoint, into theta's slot; kbar on the
// diagonal goes to the noise. out[p] = [pbar (M x 3), nbar]. No symmetry
// of Kbar is assumed: every tile is visited with weight 1. The formulas
// are cov_formulas.cuh's, the ones the tape backward (cov_tape_bwd.cu)
// runs, so the two kernels agree to the order of their sums.
//
// What bounds it on this card: FP32 arithmetic and transcendentals, as for
// the tape backward, plus a type test for each of the M slots in both
// sweeps whether the slot is active or not; 4 bytes of Kbar read per
// element.
//
// What the design does about it: the tape backward's, indexed by heap slot
// instead of tape position. One block per (particle, 32 x 32 tile), one
// thread per element column, RY rows of threads stepping over 32 / RY rows;
// node types, parameters and the post-order in shared memory (broadcast
// reads, accumulator index uniform across the block); values (float) and
// adjoints (double) in shared memory as [slot][thread], 93 KB at M = 31
// (opted in) -- the TPU kernel's two [M, tile_i, tile] VMEM buffers and its
// row-sum accumulator become these and a per-warp double accumulator filled
// by shuffle reductions. Warps, then tiles, are summed in a fixed order: no
// atomics, bitwise repeatable. The cotangent and adjoints are carried and
// summed in double, as in the tape backward. N need not be a multiple of
// the tile: edge threads run on a clamped element with cotangent 0, so
// every warp reduction stays full.

#include "cov_formulas.cuh"

namespace {

using namespace autogp;

__global__ void cov_slot_bwd_kernel(
    const int* __restrict__ node_type, const int* __restrict__ order,
    const float* __restrict__ params, const float* __restrict__ ts,
    const float* __restrict__ mask, const float* __restrict__ kbar,
    double* __restrict__ partial, int M, int N, int masked) {
  extern __shared__ double smem_d[];
  const int T = blockDim.x * blockDim.y;
  const int nwarps = T / 32;
  const int n_acc = 3 * M + 1;
  double* wacc = smem_d;                                  // [nwarps][n_acc]
  double* adj = wacc + nwarps * n_acc;                    // [M][T]
  float* val = reinterpret_cast<float*>(adj + M * T);     // [M][T]
  float* s_par = val + M * T;                             // [3M]
  int* s_type = reinterpret_cast<int*>(s_par + 3 * M);    // [M] each
  int* s_order = s_type + M;

  const int p = blockIdx.y;
  const int lin = blockIdx.x;
  const int nt = (N + kTile - 1) / kTile;
  const int ti = lin / nt;
  const int tj = lin - ti * nt;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  const int warp = tid / 32, lane = tid % 32;
  for (int k = tid; k < M; k += T) {
    s_type[k] = node_type[(long long)p * M + k];
    s_order[k] = order[k];
  }
  for (int k = tid; k < 3 * M; k += T)
    s_par[k] = params[(long long)p * 3 * M + k];
  for (int k = tid; k < nwarps * n_acc; k += T) wacc[k] = 0.0;
  __syncthreads();

  const float* kp = kbar + (long long)p * N * N;
  const bool diag_tile = (ti == tj);
  const int j_raw = tj * kTile + tx;
  const int j = min(j_raw, N - 1);
  const float t2 = ts[j];
  const float mj = mask[j];
  const WarpAcc acc{wacc + warp * n_acc, lane};

  for (int rr = ty; rr < kTile; rr += blockDim.y) {
    const int i_raw = ti * kTile + rr;
    const int i = min(i_raw, N - 1);
    const Elem e(ts[i], t2);

    double kb = (i_raw < N && j_raw < N) ? (double)kp[(long long)i * N + j]
                                         : 0.0;
    if (masked) kb = kb * (double)(mask[i] * mj);
    if (diag_tile) acc(n_acc - 1, (i_raw == j_raw) ? kb : 0.0);

    // Forward sweep: the value of every active slot, children first.
    for (int q = 0; q < M; ++q) {
      const int s = s_order[q];
      const int t = s_type[s];
      const float* pr = s_par + 3 * s;
      if (is_op(t) && 2 * s + 2 < M) {
        val[s * T + tid] = ref_op_value(t, pr, val[(2 * s + 1) * T + tid],
                                        val[(2 * s + 2) * T + tid], e);
      } else if (t != 0) {
        val[s * T + tid] = ref_leaf_value(t, pr, e);
      }
    }

    // Reverse sweep from the root: adjoints, and the gradient terms.
    adj[tid] = kb;
    for (int q = M - 1; q >= 0; --q) {
      const int s = s_order[q];
      const int t = s_type[s];
      const float* pr = s_par + 3 * s;
      if (is_op(t) && 2 * s + 2 < M) {
        const int l = 2 * s + 1, r = 2 * s + 2;
        double al, ar;
        ref_op_adjoint(t, pr, val[l * T + tid], val[r * T + tid],
                       adj[s * T + tid], e, 3 * s, al, ar, acc);
        adj[l * T + tid] = al;
        adj[r * T + tid] = ar;
      } else if (t != 0) {
        ref_leaf_grad(t, pr, val[s * T + tid], adj[s * T + tid], e, 3 * s,
                      acc);
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

}  // namespace

// node_type [P, M] int32 heaps; order [M] int32, the post-order of the full
// heap; params [P, M, 3], ts and mask [N], kbar [P, N, N] float32; partial
// scratch [P, ceil(N / 32)^2, 3M + 1] float64; out [P, 3M + 1] float32. Any
// N >= 1. An operator at the heap's last level (no room for children)
// is skipped.
extern "C" int autogp_cov_slot_bwd(const void* node_type, const void* order,
                                   const void* params, const void* ts,
                                   const void* mask, const void* kbar,
                                   void* partial, void* out, int P, int M,
                                   int N, int masked, void* stream) {
  if (M < 1 || M > kMaxSlots || N < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  const int ry = bwd_thread_rows(M);
  const int T = 32 * ry;
  const int n_acc = 3 * M + 1;
  const int smem = ry * n_acc * 8 + M * T * 12 + 3 * M * 4 + 2 * M * 4;
  cudaError_t err = cudaFuncSetAttribute(
      cov_slot_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = (N + kTile - 1) / kTile;
  auto s = (cudaStream_t)stream;
  cov_slot_bwd_kernel<<<dim3(nt * nt, P), dim3(32, ry), smem, s>>>(
      (const int*)node_type, (const int*)order, (const float*)params,
      (const float*)ts, (const float*)mask, (const float*)kbar,
      (double*)partial, M, N, masked);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_tiles_kernel<<<P, 128, 0, s>>>((const double*)partial, (float*)out,
                                        nt * nt, n_acc);
  return (int)cudaGetLastError();
}
