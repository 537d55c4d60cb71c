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
// order (leaf_value / op_value of cov_formulas.cuh, shared with the
// per-slot kernel cov_slot.cu), so the output is bitwise that of the
// design it replaces and of kernel 6.

#include "cov_formulas.cuh"

namespace {

using namespace autogp;

constexpr int kRowsPerPass = 8;      // blockDim = (32, 8)
constexpr int kRowsPerThread = 2;
constexpr int kRows = kRowsPerPass * kRowsPerThread;  // rows per block
constexpr int kVec = 4;              // neighbouring columns per thread
constexpr int kCols = kTile * kVec;  // columns per block

template <int T>
__device__ __forceinline__ void leaf_vec(const float* p, float t1,
                                         const float* t2, float* v) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = leaf_value(T, p, t1, t2[e]);
}

// The tree at (t1, t2[e]), e < kVec, by the post-order tape: values pushed
// by leaves, two popped and one pushed by operators, st[0] the top. DEPTH
// bounds the stack (a tree of D levels needs D slots).
template <int DEPTH>
__device__ __forceinline__ void eval_tape_vec(const int* __restrict__ slot,
                                              const int* __restrict__ type,
                                              int len,
                                              const float* __restrict__ par,
                                              float t1, const float* t2,
                                              float* v) {
  float st[DEPTH][kVec];
#pragma unroll
  for (int k = 0; k < DEPTH; ++k)
#pragma unroll
    for (int e = 0; e < kVec; ++e) st[k][e] = 0.0f;
  for (int q = 0; q < len; ++q) {
    const int t = type[q];
    const float* p = par + 3 * slot[q];
    if (is_op(t)) {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        st[0][e] = op_value(t, p, st[1][e], st[0][e], t1, t2[e]);
#pragma unroll
      for (int k = 1; k + 1 < DEPTH; ++k)
#pragma unroll
        for (int e = 0; e < kVec; ++e) st[k][e] = st[k + 1][e];
    } else if (t != 0) {  // inactive (type 0) never appears below the length
#pragma unroll
      for (int k = DEPTH - 1; k > 0; --k)
#pragma unroll
        for (int e = 0; e < kVec; ++e) st[k][e] = st[k - 1][e];
      float lv[kVec];
      switch (t) {
        case CONSTANT: leaf_vec<CONSTANT>(p, t1, t2, lv); break;
        case LINEAR: leaf_vec<LINEAR>(p, t1, t2, lv); break;
        case SQUARED_EXPONENTIAL:
          leaf_vec<SQUARED_EXPONENTIAL>(p, t1, t2, lv);
          break;
        case GAMMA_EXPONENTIAL:
          leaf_vec<GAMMA_EXPONENTIAL>(p, t1, t2, lv);
          break;
        case PERIODIC: leaf_vec<PERIODIC>(p, t1, t2, lv); break;
        default: leaf_vec<WHITE_NOISE>(p, t1, t2, lv); break;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) st[0][e] = lv[e];
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = st[0][e];
}

// A thread's kVec = 4 neighbouring floats of a row as one 16-byte store
// (the row 16-byte aligned).
static_assert(kVec == 4, "one float4 per thread and row");
__device__ __forceinline__ void store_vec(float* row, const float* v) {
  *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
}

// Whether element (i, j) takes the tree's value: in range, not above the
// diagonal under lower_only, and unmasked.
__device__ __forceinline__ bool needs_tree(int i, int j, int N2,
                                           const float* __restrict__ m_row,
                                           const float* __restrict__ m_col,
                                           int lower_only) {
  return j < N2 && !(lower_only && j > i) && m_row[i] * m_col[j] > 0.0f;
}

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
  const int i0 = blockIdx.y * kRows;
  const int j0 = blockIdx.x * kCols;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int jt = j0 + kVec * tx;  // this thread's first column
  float* outp = out + (size_t)p * N1 * N2;
  const bool vec = (N2 % kVec == 0) && (jt + kVec <= N2);

  if (lower_only && j0 > i0 + kRows - 1) {
    // Tile entirely above the diagonal: zeros, no tree evaluation.
    for (int r = ty; r < kRows; r += kRowsPerPass) {
      const int i = i0 + r;
      if (i >= N1) break;
      float* row = outp + (size_t)i * N2 + jt;
      if (vec) {
        const float z[kVec] = {};
        store_vec(row, z);
      } else {
        for (int e = 0; e < kVec && jt + e < N2; ++e) row[e] = 0.0f;
      }
    }
    return;
  }

  // Stage the tape only if an element of the tile needs it.
  bool need = false;
  for (int r = ty; r < kRows; r += kRowsPerPass) {
    const int i = i0 + r;
    if (i >= N1) break;
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      need |= needs_tree(i, jt + e, N2, m_row, m_col, lower_only);
  }
  if (__syncthreads_or(need)) {
    const int tid = ty * kTile + tx;
    const int nthreads = kTile * kRowsPerPass;
    for (int k = tid; k < M; k += nthreads) {
      s_slot[k] = tslot[(size_t)p * M + k];
      s_type[k] = ttype[(size_t)p * M + k];
    }
    for (int k = tid; k < 3 * M; k += nthreads)
      s_par[k] = params[(size_t)p * 3 * M + k];
    __syncthreads();
  }

  const int len = tlen[p];
  const float nz = noise[p];
  float t2[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) t2[e] = t_col[min(jt + e, N2 - 1)];
  for (int r = ty; r < kRows; r += kRowsPerPass) {
    const int i = i0 + r;
    if (i >= N1) break;
    bool keep[kVec];
    bool any = false;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      keep[e] = needs_tree(i, jt + e, N2, m_row, m_col, lower_only);
      any |= keep[e];
    }
    float v[kVec];
    if (any) eval_tape_vec<DEPTH>(s_slot, s_type, len, s_par, t_row[i], t2, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const bool diag = gram && (i == jt + e);
      if (keep[e]) {
        if (diag) v[e] = v[e] + nz;
      } else {
        // Masked: the identity in gram mode, 0 outside; above the
        // diagonal (lower_only, never on it): 0.
        v[e] = diag ? 1.0f : 0.0f;
      }
    }
    float* row = outp + (size_t)i * N2 + jt;
    if (vec) {
      store_vec(row, v);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (jt + e < N2) row[e] = v[e];
    }
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
