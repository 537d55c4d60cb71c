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
// What bounds it on this card: arithmetic, not memory. Each element costs
// about 12 * depth flops and 2 * depth transcendentals (the Pallas cost
// estimate, cov_pallas.py:347-351) against 4 bytes written; at
// [64, 1024, 1024] that is ~0.27 GB written and ~0.4 G transcendentals.
//
// What the design does about it: one thread block per (particle, 32x32
// tile); the block stages its particle's tape and [M, 3] parameters in
// shared memory, so every instruction is a broadcast read, and each thread
// runs the whole tape for its elements with the value stack in a small
// per-thread array (depth <= kMaxDepth). Only the active instructions run
// (typically 5-9), not all 2^D - 1 heap slots. Whole tiles above the
// diagonal exit after writing zeros. The formulas are the guarded ones of
// the reference, in the same operation order as the plain version
// (cov_formulas.cuh, shared with the per-slot kernel cov_slot.cu).

#include "cov_formulas.cuh"

namespace {

using namespace autogp;

constexpr int kRowsPerPass = 8;  // blockDim = (32, 8): 4 rows per thread

__device__ float eval_tape(const int* __restrict__ slot,
                           const int* __restrict__ type, int len,
                           const float* __restrict__ par, float t1,
                           float t2) {
  float stack[kMaxDepth];
  int sp = 0;
  for (int i = 0; i < len; ++i) {
    const int t = type[i];
    const float* p = par + 3 * slot[i];
    if (is_op(t)) {
      stack[sp - 2] = op_value(t, p, stack[sp - 2], stack[sp - 1], t1, t2);
      --sp;
    } else if (t != 0) {  // inactive (type 0) never appears below the length
      stack[sp++] = leaf_value(t, p, t1, t2);
    }
  }
  return stack[0];
}

__global__ void cov_tape_kernel(const int* __restrict__ tslot,
                                const int* __restrict__ ttype,
                                const int* __restrict__ tlen,
                                const float* __restrict__ params,
                                const float* __restrict__ noise,
                                const float* __restrict__ t_row,
                                const float* __restrict__ t_col,
                                const float* __restrict__ m_row,
                                const float* __restrict__ m_col,
                                float* __restrict__ out, int M, int N1,
                                int N2, int gram, int lower_only) {
  __shared__ int s_slot[kMaxSlots];
  __shared__ int s_type[kMaxSlots];
  __shared__ float s_par[3 * kMaxSlots];

  const int p = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  float* outp = out + (size_t)p * N1 * N2;

  if (lower_only && j0 > i0 + kTile - 1) {
    // Tile entirely above the diagonal: zeros, no tree evaluation.
    for (int r = ty; r < kTile; r += kRowsPerPass) {
      const int i = i0 + r, j = j0 + tx;
      if (i < N1 && j < N2) outp[(size_t)i * N2 + j] = 0.0f;
    }
    return;
  }

  const int tid = ty * kTile + tx;
  const int nthreads = kTile * kRowsPerPass;
  for (int k = tid; k < M; k += nthreads) {
    s_slot[k] = tslot[(size_t)p * M + k];
    s_type[k] = ttype[(size_t)p * M + k];
  }
  for (int k = tid; k < 3 * M; k += nthreads)
    s_par[k] = params[(size_t)p * 3 * M + k];
  __syncthreads();

  const int len = tlen[p];
  const float nz = noise[p];
  const int j = j0 + tx;
  if (j >= N2) return;
  const float t2 = t_col[j];
  const float mj = m_col[j];
  for (int r = ty; r < kTile; r += kRowsPerPass) {
    const int i = i0 + r;
    if (i >= N1) break;
    float v;
    if (lower_only && j > i) {
      v = 0.0f;
    } else {
      const bool diag = gram && (i == j);
      const bool keep = m_row[i] * mj > 0.0f;
      if (keep) {
        v = eval_tape(s_slot, s_type, len, s_par, t_row[i], t2);
        if (diag) v = v + nz;
      } else {
        v = diag ? 1.0f : 0.0f;
      }
    }
    outp[(size_t)i * N2 + j] = v;
  }
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
  dim3 grid((N2 + kTile - 1) / kTile, (N1 + kTile - 1) / kTile, P);
  cov_tape_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)tslot, (const int*)ttype, (const int*)tlen,
      (const float*)params, (const float*)noise, (const float*)t_row,
      (const float*)t_col, (const float*)m_row, (const float*)m_col,
      (float*)out, M, N1, N2, gram, lower_only);
  return (int)cudaGetLastError();
}

extern "C" const char* autogp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
