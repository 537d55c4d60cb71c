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
// of two rows. The block stages its particle's tape and parameters in
// shared memory (broadcast reads). A thread runs the tape once per row
// for its four columns together: the value stack lives in registers as
// [depth][4] shifted at compile-time positions (pushes and pops are
// register moves; depth 5, 8, 12 or 16 by the batch's tallest tape, local
// memory above: cov_assemble.cuh),
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
//
// What bounds it in depth: the tape, not the heap. Shared memory holds the
// batch's longest tape, L = max_len positions: the type and the three
// parameters of each (16 L bytes; the parameters gathered through the
// position's slot), so a 1023-slot heap of config 4's trees stages what a
// 31-slot one does. The longest tape a block stages is 14528 positions
// (16 bytes each in kSmemPerBlock); a longer one is refused before launch.

#include "cov_assemble.cuh"

namespace {

using namespace autogp;

// Shared memory of one block: s_par [L, 3] floats, then s_type [L] ints.
inline size_t tape_smem(int L) { return 16 * (size_t)L; }

template <int DEPTH>
__global__ void __launch_bounds__(kTile * kRowsPerPass)
cov_tape_kernel(const int* __restrict__ tslot, const int* __restrict__ ttype,
                const int* __restrict__ tlen, const float* __restrict__ params,
                const float* __restrict__ noise,
                const float* __restrict__ t_row,
                const float* __restrict__ t_col,
                const float* __restrict__ m_row,
                const float* __restrict__ m_col, float* __restrict__ out,
                int M, int L, int N1, int N2, int gram, int lower_only) {
  extern __shared__ float smem_f[];
  float* s_par = smem_f;
  int* s_type = reinterpret_cast<int*>(s_par + 3 * L);

  const int p = blockIdx.z;
  // The particle's tape (its first L positions: no-ops past its length)
  // and each position's parameters, gathered through its slot.
  auto stage = [&]() {
    const int tid = threadIdx.y * kTile + threadIdx.x;
    const int nthreads = kTile * kRowsPerPass;
    const float* pp = params + (size_t)p * 3 * M;
    for (int k = tid; k < L; k += nthreads) {
      const int s = tslot[(size_t)p * M + k];
      s_type[k] = ttype[(size_t)p * M + k];
      s_par[3 * k] = pp[3 * s];
      s_par[3 * k + 1] = pp[3 * s + 1];
      s_par[3 * k + 2] = pp[3 * s + 2];
    }
    __syncthreads();
    return tlen[p];
  };
  assemble_tile<DEPTH>(stage, s_type, s_par, noise[p], t_row, t_col,
                       m_row, m_col, out + (size_t)p * N1 * N2, N1, N2, gram,
                       1, lower_only);
}

}  // namespace

// Tapes [P, M] (slot, type) int32 and lengths [P]; params [P, M, 3], noise
// [P], t_row, m_row [N1], t_col, m_col [N2], out [P, N1, N2] float32;
// max_len and max_height: the batch's longest tape and tallest stack
// (ops/cov.py tape_maxima), which size the staging and pick the stack.
extern "C" int autogp_cov_tape(const void* tslot, const void* ttype,
                               const void* tlen, const void* params,
                               const void* noise, const void* t_row,
                               const void* t_col, const void* m_row,
                               const void* m_col, void* out, int P, int M,
                               int N1, int N2, int gram, int lower_only,
                               int max_len, int max_height, void* stream) {
  const int depth = stack_instance(max_height);
  const size_t smem = tape_smem(max_len);
  if (M < 1 || max_len < 1 || max_len > M || depth == 0 ||
      smem > (size_t)kSmemPerBlock)
    return (int)cudaErrorInvalidValue;
  auto kernel = depth == 5    ? cov_tape_kernel<5>
                : depth == 8  ? cov_tape_kernel<8>
                : depth == 12 ? cov_tape_kernel<12>
                : depth == 16 ? cov_tape_kernel<16>
                              : cov_tape_kernel<kLocalDepth>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 block(kTile, kRowsPerPass);
  dim3 grid((N2 + kCols - 1) / kCols, (N1 + kRows - 1) / kRows, P);
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int*)tslot, (const int*)ttype, (const int*)tlen,
      (const float*)params, (const float*)noise, (const float*)t_row,
      (const float*)t_col, (const float*)m_row, (const float*)m_col,
      (float*)out, M, max_len, N1, N2, gram, lower_only);
  return (int)cudaGetLastError();
}

extern "C" const char* autogp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
