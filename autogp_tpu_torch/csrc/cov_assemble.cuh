// The tile body of the covariance assembly, shared by the tape-driven kernel
// (cov_tape.cu) and the per-slot kernel (cov_slot.cu): both run these
// instructions on the same post-order tape, so their grams agree bit for
// bit. They differ only in where a block's tape comes from (staged from
// the tape arrays, or compacted from the heap in the block's prologue).
// The design and what bounds it: cov_tape.cu's header.
//
// Depth: the value stack's height comes from the batch's tallest tape
// (ops/cov.py tape_maxima): registers for heights of up to 5, 8, 12 or 16
// (one instance each), local memory above (kLocalDepth, which every heap
// a C int can count fits). Every instance runs the same arithmetic on the
// same values, so a tree's output is bitwise the same in each.

#pragma once

#include "cov_formulas.cuh"

namespace autogp {

constexpr int kRowsPerPass = 8;      // blockDim = (32, 8)
constexpr int kRowsPerThread = 2;
constexpr int kRows = kRowsPerPass * kRowsPerThread;  // rows per block
constexpr int kVec = 4;              // neighbouring columns per thread
constexpr int kCols = kTile * kVec;  // columns per block
constexpr int kLocalDepth = 32;      // the stack in local memory

// The value-stack instance for a batch whose tallest tape holds `height`
// values at once (0 if none fits).
__host__ __device__ inline int stack_instance(int height) {
  return height <= 5    ? 5
         : height <= 8  ? 8
         : height <= 12 ? 12
         : height <= 16 ? 16
         : height <= kLocalDepth ? kLocalDepth : 0;
}

template <int T>
__device__ __forceinline__ void leaf_vec(const float* p, float t1,
                                         const float* t2, float* v) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = leaf_value(T, p, t1, t2[e]);
}

// A leaf of type t (not 0) at (t1, t2[e]), e < kVec, into lv.
__device__ __forceinline__ void leaf_vec_of(int t, const float* p, float t1,
                                            const float* t2, float* lv) {
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
}

// eval_tape_vec with the stack in local memory, indexed by its height:
// for trees taller than the register instances. The same operations on
// the same values as the register stack.
__device__ __forceinline__ void eval_tape_vec_local(
    const int* __restrict__ type, int len, const float* __restrict__ par,
    float t1, const float* t2, float* v) {
  float st[kLocalDepth][kVec];
  int sp = 0;  // values on the stack
  for (int q = 0; q < len; ++q) {
    const int t = type[q];
    const float* p = par + 3 * q;
    if (is_op(t)) {
      // The top is the right operand, the one below it the left. An
      // operator with no children (the heap's last level) reads what is
      // there, as the register stack does: its value is undefined.
      const int r = max(sp - 1, 0), l = max(sp - 2, 0);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        st[l][e] = op_value(t, p, st[l][e], st[r][e], t1, t2[e]);
      sp = l + 1;
    } else if (t != 0 && sp < kLocalDepth) {
      leaf_vec_of(t, p, t1, t2, st[sp]);
      ++sp;
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = sp > 0 ? st[sp - 1][e] : 0.0f;
}

// The tree at (t1, t2[e]), e < kVec, by the post-order tape: values pushed
// by leaves, two popped and one pushed by operators, st[0] the top. DEPTH
// bounds the stack (the tape's height: a tree of D levels needs at most
// D).
template <int DEPTH>
__device__ __forceinline__ void eval_tape_vec_regs(
    const int* __restrict__ type, int len, const float* __restrict__ par,
    float t1, const float* t2, float* v) {
  float st[DEPTH][kVec];
#pragma unroll
  for (int k = 0; k < DEPTH; ++k)
#pragma unroll
    for (int e = 0; e < kVec; ++e) st[k][e] = 0.0f;
  for (int q = 0; q < len; ++q) {
    const int t = type[q];
    const float* p = par + 3 * q;
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
      leaf_vec_of(t, p, t1, t2, lv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) st[0][e] = lv[e];
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = st[0][e];
}

// The register instance DEPTH, or the local-memory stack (kLocalDepth).
template <int DEPTH>
__device__ __forceinline__ void eval_tape_vec(const int* __restrict__ type,
                                              int len,
                                              const float* __restrict__ par,
                                              float t1, const float* t2,
                                              float* v) {
  if constexpr (DEPTH == kLocalDepth)
    eval_tape_vec_local(type, len, par, t1, t2, v);
  else
    eval_tape_vec_regs<DEPTH>(type, len, par, t1, t2, v);
}

// A thread's kVec = 4 neighbouring floats of a row as one 16-byte store
// (the row 16-byte aligned).
static_assert(kVec == 4, "one float4 per thread and row");
__device__ __forceinline__ void store_vec(float* row, const float* v) {
  *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
}

// Whether element (i, j) takes the tree's value: in range, not above the
// diagonal under lower_only, and unmasked (always, without `masked`).
__device__ __forceinline__ bool needs_tree(int i, int j, int N2,
                                           const float* __restrict__ m_row,
                                           const float* __restrict__ m_col,
                                           int masked, int lower_only) {
  return j < N2 && !(lower_only && j > i) &&
         (!masked || m_row[i] * m_col[j] > 0.0f);
}

// Block (blockIdx.x, blockIdx.y) of particle blockIdx.z: rows i0 = 16 by,
// columns j0 = 128 bx of out [N1, N2] (outp, this particle's matrix).
// `stage()` is called, by every thread, only if an element of the tile
// needs the tree: it fills s_type (the tape's types) and s_par (the
// parameters, [len, 3] by tape position), ends with a barrier
// and returns the tape's length.
template <int DEPTH, class Stage>
__device__ __forceinline__ void assemble_tile(
    Stage&& stage,
    const int* __restrict__ s_type, const float* __restrict__ s_par,
    float nz, const float* __restrict__ t_row,
    const float* __restrict__ t_col, const float* __restrict__ m_row,
    const float* __restrict__ m_col, float* __restrict__ outp, int N1,
    int N2, int gram, int masked, int lower_only) {
  const int i0 = blockIdx.y * kRows;
  const int j0 = blockIdx.x * kCols;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int jt = j0 + kVec * tx;  // this thread's first column
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
      need |= needs_tree(i, jt + e, N2, m_row, m_col, masked, lower_only);
  }
  int len = 0;
  if (__syncthreads_or(need)) len = stage();

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
      keep[e] = needs_tree(i, jt + e, N2, m_row, m_col, masked, lower_only);
      any |= keep[e];
    }
    float v[kVec];
    if (any) eval_tape_vec<DEPTH>(s_type, len, s_par, t_row[i], t2, v);
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

}  // namespace autogp
