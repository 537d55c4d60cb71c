// The 3xTF32 tensor-core step shared by the kinv kernels (kinv.cu) and the
// in-tape K^-1 tiles of the tape backward (cov_tape_bwd.cu), and the
// cp.async copies that stage their operands.
//
// One FP32 product a * b on the TF32 tensor cores: every operand x is
// split into hi = tf32(x) (round to nearest) and lo = tf32(x - hi), and the
// product takes lo*hi' + hi*lo' + hi*hi' as three
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 products into one
// FP32 accumulator, in that order (3xTF32). The dropped lo*lo' term is
// ~2^-22 of the product, so the result is FP32-class (~1e-6 relative),
// finer than the reference's bf16x3 (dot3). Plain 1xTF32 (about three
// digits) is never used.
//
// K^-1 = X^T X with X = L^-1 goes through `mma_3xtf32` in both kernels
// with the same operands in the same places: element (i, j) takes column i
// of X as the A operand and column j as the B operand, 8 rows r at a time
// (a chunk starts at a multiple of 8, row r at k = r % 8), in ascending r
// from the first row of its 16-row fragment. The chunks of each 32 rows
// (rows 32c .. 32c + 31) go into one partial sum from +0, and the partials
// are added in ascending c to an FP32 sum from +0 (IEEE adds). That is
// what makes kinv.cu's K^-1 and cov_tape_bwd.cu's in-tape tiles agree bit
// for bit. The tensor cores' FP32 accumulation truncates: one chain over
// all N rows (3N / 8 steps) lost ~2.8e-5 of K^-1 at N = 1024, growing
// with N, where the partials keep each chain to 12 steps.

#pragma once

#include <cuda_runtime.h>

namespace autogp {

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

// c += A B for one 8-deep chunk, A the 16 x 8 and B the 8 x 8 fragment
// already split: lo*hi', then hi*lo', then hi*hi'.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// The split A fragment (16 rows m by 8 deep k) of an operand held in
// shared memory as [k][m] with leading dimension ld (the transposed
// layout: element (m, k) at s[k * ld + m]); s points to (k = 0, m = 0).
// With ld = 8 mod 32 the warp's 32 lanes read 32 different banks.
__device__ __forceinline__ void frag_a_km(const float* s, int ld,
                                          unsigned (&hi)[4],
                                          unsigned (&lo)[4]) {
  const int lane = threadIdx.x & 31;
  const float* p = s + (lane & 3) * ld + (lane >> 2);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8], hi[1], lo[1]);
  split_tf32(p[4 * ld], hi[2], lo[2]);
  split_tf32(p[4 * ld + 8], hi[3], lo[3]);
}

// The split B fragment (8 deep k by 8 columns n) of an operand held as
// [k][n] with leading dimension ld; s points to (k = 0, n = 0).
__device__ __forceinline__ void frag_b_kn(const float* s, int ld,
                                          unsigned (&hi)[2],
                                          unsigned (&lo)[2]) {
  const int lane = threadIdx.x & 31;
  const float* p = s + (lane & 3) * ld + (lane >> 2);
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[4 * ld], hi[1], lo[1]);
}

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

}  // namespace autogp
