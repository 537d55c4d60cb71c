// Tape-driven covariance assembly for a batch of kernel-expression trees.
//
// Replaces: autogp_tpu/ops/cov_pallas.py, _cov_kernel_tape_1p (with its
// tile evaluator _tree_eval_tape), launched there by cov_matrix_tape.
//
// What it computes: for particle p, out[p, i, j] = k_p(t_row[i], t_col[j]),
// where k_p is the tree encoded by the post-order instruction tape of
// particle p (tape slot, tape type, tape length; built by ops/cov.py
// build_tape). In gram mode (square output, one grid of times) noise[p] is
// added on the global diagonal and rows/columns with mask 0 become the
// identity, so padded pivots are exactly 1 and add log 1 = 0 to the LML.
// Outside gram mode masked entries are 0 (the predict cross-covariance).
// With lower_only, every element above the diagonal is written as 0 and
// its tree is never evaluated: the blocked Cholesky reads only the lower
// triangle.
//
// What bounds it on this card: instruction issue, then the write. The
// output is 4 bytes per element (268 MB at [64, 1024, 1024], 0.080 ms at
// 3.35 TB/s), but each evaluated element runs its tape through formulas
// whose accurate expf / logf / sinf and IEEE divisions take ~10-30
// instructions each, a few hundred instructions an element for the 18.9 M
// lower elements at that shape. The
// one-element-per-thread design this replaces (0.22 ms) kept its value
// stack in local memory (a 32-byte stack frame: a load and a store per
// tape instruction) and paid the per-instruction reads and dispatch for
// every element.
//
// What the design does about it: one thread block per (particle, 16-row x
// 128-column tile), threads (32, 8), each thread four neighbouring columns
// of two rows. The block stages its particle's tape and [M, 3] parameters
// in shared memory (broadcast reads). A thread runs the tape once per row
// for its four columns together: the value stack lives in registers as
// [depth][4] shifted at compile-time positions (pushes and pops are
// register moves; depth 5 for heaps of up to 31 slots, kMaxDepth above),
// each instruction's type and parameters are read and dispatched once for
// the four elements, their chains interleave, and the four results leave
// as one 16-byte store, so a warp writes 512 contiguous bytes per row
// (scalar stores when a row is not 16-byte aligned, N2 % 4 != 0, and on
// the ragged right edge). Only the active instructions run, not all
// 2^D - 1 heap slots. Tiles wholly above the diagonal (lower_only) and
// rows or groups of four that need no tree (masked, or above the
// diagonal) are stored without evaluating anything, and a block whose
// elements all need none skips the staging. Each element's arithmetic is
// the guarded formulas of the reference in the plain version's operation
// order (leaf_value / op_value of cov_formulas.cuh), so the output is
// bitwise that of the design it replaces. The tile body is
// cov_assemble.cuh's `assemble_tile`, which the per-slot kernel
// (cov_slot.cu, kernel 6) runs on the same tape, so the two grams agree
// bit for bit.

#include "cov_assemble.cuh"

namespace {

using namespace autogp;

template <int DEPTH>
__global__ void __launch_bounds__(kTile * kRowsPerPass)
cov_tape_kernel(const int* __restrict__ tslot, const int* __restrict__ ttype,
                const int* __restrict__ tlen, const float* __restrict__ params,
                const float* __restrict__ noise,
                const float* __restrict__ t_row,
                const float* __restrict__ t_col,
                const float* __restrict__ m_row,
                const float* __restrict__ m_col, float* __restrict__ out,
                int M, int N1, int N2, int gram, int lower_only) {
  __shared__ int s_slot[kMaxSlots];
  __shared__ int s_type[kMaxSlots];
  __shared__ float s_par[3 * kMaxSlots];

  const int p = blockIdx.z;
  // The particle's tape and parameters, from the tape arrays.
  auto stage = [&]() {
    const int tid = threadIdx.y * kTile + threadIdx.x;
    const int nthreads = kTile * kRowsPerPass;
    for (int k = tid; k < M; k += nthreads) {
      s_slot[k] = tslot[(size_t)p * M + k];
      s_type[k] = ttype[(size_t)p * M + k];
    }
    for (int k = tid; k < 3 * M; k += nthreads)
      s_par[k] = params[(size_t)p * 3 * M + k];
    __syncthreads();
    return tlen[p];
  };
  assemble_tile<DEPTH>(stage, s_slot, s_type, s_par, noise[p], t_row, t_col,
                       m_row, m_col, out + (size_t)p * N1 * N2, N1, N2, gram,
                       1, lower_only);
}

}  // namespace

extern "C" int autogp_cov_tape(const void* tslot, const void* ttype,
                               const void* tlen, const void* params,
                               const void* noise, const void* t_row,
                               const void* t_col, const void* m_row,
                               const void* m_col, void* out, int P, int M,
                               int N1, int N2, int gram, int lower_only,
                               void* stream) {
  if (M > kMaxSlots) return (int)cudaErrorInvalidValue;
  dim3 block(kTile, kRowsPerPass);
  dim3 grid((N2 + kCols - 1) / kCols, (N1 + kRows - 1) / kRows, P);
  // A heap of M = 2^D - 1 slots holds trees of at most D levels.
  auto kernel = M <= 31 ? cov_tape_kernel<5> : cov_tape_kernel<kMaxDepth>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)tslot, (const int*)ttype, (const int*)tlen,
      (const float*)params, (const float*)noise, (const float*)t_row,
      (const float*)t_col, (const float*)m_row, (const float*)m_col,
      (float*)out, M, N1, N2, gram, lower_only);
  return (int)cudaGetLastError();
}

extern "C" const char* autogp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
