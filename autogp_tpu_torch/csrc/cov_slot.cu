// Per-slot covariance assembly for a batch of kernel-expression trees: the
// heap itself is swept, with no instruction tape.
//
// Replaces: autogp_tpu/ops/cov_pallas.py, _cov_kernel_1p (with its tile
// evaluator _tree_eval_tile), launched there by cov_matrix, the forward of
// cov_matrix_diff(tape=False).
//
// What it computes: for particle p, out[p, i, j] = k_p(ts[i], ts[j]) +
// noise[p] (i == j), where k_p is the tree held in the heap node_type[p]
// ([M] slots, children of s at 2s + 1 and 2s + 2, type 0 = empty). All M
// slots are visited in the static post-order `order`; a leaf pushes its
// value on a stack at most depth_cap deep, an operator pops two and pushes
// one, an empty slot does nothing. With `masked`, rows and columns with
// mask 0 become the identity.
//
// What bounds it on this card: arithmetic, not memory, like the tape
// kernel (cov_tape.cu): ~12 flops and ~2 transcendentals per active node
// and element against 4 bytes written -- plus a type test for every empty
// slot, which the tape kernel does not pay.
//
// What the design does about it: one thread block per (particle, 32 x 32
// tile), the particle's node types and parameters and the post-order staged
// in shared memory so every slot is a broadcast read, and a per-thread
// value stack in registers/local memory. The TPU kernel's [depth_cap,
// tile_i, tile_j] VMEM stack is one float per level and thread here. The
// formulas are cov_formulas.cuh's, the ones cov_tape.cu runs, so the two
// kernels give the same values.

#include "cov_formulas.cuh"

namespace {

using namespace autogp;

constexpr int kRowsPerPass = 8;  // blockDim = (32, 8): 4 rows per thread

__global__ void cov_slot_kernel(const int* __restrict__ node_type,
                                const int* __restrict__ order,
                                const float* __restrict__ params,
                                const float* __restrict__ noise,
                                const float* __restrict__ ts,
                                const float* __restrict__ mask,
                                float* __restrict__ out, int M, int N,
                                int masked) {
  __shared__ int s_type[kMaxSlots];
  __shared__ int s_order[kMaxSlots];
  __shared__ float s_par[3 * kMaxSlots];

  const int p = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int nthreads = kTile * kRowsPerPass;
  for (int k = tid; k < M; k += nthreads) {
    s_type[k] = node_type[(size_t)p * M + k];
    s_order[k] = order[k];
  }
  for (int k = tid; k < 3 * M; k += nthreads)
    s_par[k] = params[(size_t)p * 3 * M + k];
  __syncthreads();

  const int j = j0 + tx;
  if (j >= N) return;
  const float nz = noise[p];
  const float t2 = ts[j];
  const float mj = mask[j];
  float* outp = out + (size_t)p * N * N;
  for (int r = ty; r < kTile; r += kRowsPerPass) {
    const int i = i0 + r;
    if (i >= N) break;
    const float t1 = ts[i];
    float stack[kMaxDepth];
    int sp = 0;
    for (int q = 0; q < M; ++q) {
      const int s = s_order[q];
      const int t = s_type[s];
      const float* pr = s_par + 3 * s;
      if (is_op(t)) {
        stack[sp - 2] = op_value(t, pr, stack[sp - 2], stack[sp - 1], t1, t2);
        --sp;
      } else if (t != 0) {
        stack[sp++] = leaf_value(t, pr, t1, t2);
      }
    }
    const float diag = (i == j) ? 1.0f : 0.0f;
    float v = stack[0] + nz * diag;
    if (masked && !(mask[i] * mj > 0.0f)) v = diag;
    outp[(size_t)i * N + j] = v;
  }
}

}  // namespace

// node_type [P, M] int32 heaps; order [M] int32, the post-order of the full
// heap; params [P, M, 3], noise [P], ts and mask [N] float32; out [P, N, N]
// float32. Any N >= 1.
extern "C" int autogp_cov_slot(const void* node_type, const void* order,
                               const void* params, const void* noise,
                               const void* ts, const void* mask, void* out,
                               int P, int M, int N, int masked,
                               void* stream) {
  if (M < 1 || M > kMaxSlots || N < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  dim3 block(kTile, kRowsPerPass);
  dim3 grid((N + kTile - 1) / kTile, (N + kTile - 1) / kTile, P);
  cov_slot_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)node_type, (const int*)order, (const float*)params,
      (const float*)noise, (const float*)ts, (const float*)mask, (float*)out,
      M, N, masked);
  return (int)cudaGetLastError();
}
