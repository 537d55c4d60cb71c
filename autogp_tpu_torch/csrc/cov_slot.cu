// Per-slot covariance assembly for a batch of kernel-expression trees: the
// input is the heap itself, with no instruction tape.
//
// Replaces: autogp_tpu/ops/cov_pallas.py, _cov_kernel_1p (with its tile
// evaluator _tree_eval_tile), launched there by cov_matrix, the forward of
// cov_matrix_diff(tape=False).
//
// What it computes: for particle p, out[p, i, j] = k_p(ts[i], ts[j]) +
// noise[p] (i == j), where k_p is the tree held in the heap node_type[p]
// ([M] slots, children of s at 2s + 1 and 2s + 2, type 0 = empty) and
// `order` is the static post-order of the full heap. With `masked`, rows
// and columns with mask 0 become the identity. Any N >= 1.
//
// What bounds it on this card: what bounds kernel 1 (cov_tape.cu), whose
// gram it is: instruction issue on the accurate expf / logf / sinf and
// IEEE divisions of the active nodes, then the write (4 bytes per element,
// 0.080 ms at [64, 1024, 1024] and 3.35 TB/s). Every element of the square
// is evaluated (no lower_only), about twice kernel 1's lower-only work.
// The TPU kernel sweeps all M slots per element, a type test for each;
// the one-element-per-thread design this replaces did the same (31 slots
// for the ~7 active ones in a prior tree at depth cap 5) with its value
// stack indexed at run time, in local memory: 1.84 ms at [64, 1024, 1024]
// on an H100 SXM.
//
// What the design does about it: the heap is compacted on the device, in
// each block's prologue, into the post-order tape of its active slots --
// the tape ops/cov.py build_tape writes -- and the block then runs kernel
// 1's tile body on it (cov_assemble.cuh `assemble_tile`: 16-row x
// 128-column tiles, threads (32, 8), 4 columns x 2 rows a thread, the value
// stack in registers, 16-byte stores, masked elements and whole masked
// blocks skipped). Warp 0 walks `order` 32 slots at a time (at most 8
// chunks at M = 255): each lane reads one slot's type, a ballot marks the
// active ones and a popcount of the lanes below gives each its tape
// position, while the other warps stage the [M, 3] parameters. The
// output is therefore bitwise kernel 1's full gram. One launch per call;
// the wrapper builds no tape.
//
// An operator on the heap's last level (no room for children; the prior
// never samples one) stays on the tape, as build_tape keeps it, and pops
// two values as kernel 1 does.

#include "cov_assemble.cuh"

namespace {

using namespace autogp;

template <int DEPTH>
__global__ void __launch_bounds__(kTile * kRowsPerPass)
cov_slot_kernel(const int* __restrict__ node_type,
                const int* __restrict__ order,
                const float* __restrict__ params,
                const float* __restrict__ noise, const float* __restrict__ ts,
                const float* __restrict__ mask, float* __restrict__ out,
                int M, int N, int masked) {
  __shared__ int s_slot[kMaxSlots];
  __shared__ int s_type[kMaxSlots];
  __shared__ float s_par[3 * kMaxSlots];
  __shared__ int s_len;

  const int p = blockIdx.z;
  // The particle's tape, compacted from its heap by warp 0, and its
  // parameters.
  auto stage = [&]() {
    const int tx = threadIdx.x;
    const int tid = threadIdx.y * kTile + tx;
    const int nthreads = kTile * kRowsPerPass;
    for (int k = tid; k < 3 * M; k += nthreads)
      s_par[k] = params[(size_t)p * 3 * M + k];
    if (threadIdx.y == 0) {
      const int* heap = node_type + (size_t)p * M;
      int len = 0;
      for (int q0 = 0; q0 < M; q0 += kTile) {
        const int q = q0 + tx;
        const int s = q < M ? order[q] : 0;
        const int t = q < M ? heap[s] : 0;
        const unsigned act = __ballot_sync(0xffffffffu, t != 0);
        if (t != 0) {
          const int at = len + __popc(act & ((1u << tx) - 1u));
          s_slot[at] = s;
          s_type[at] = t;
        }
        len += __popc(act);
      }
      if (tx == 0) s_len = len;
    }
    __syncthreads();
    return s_len;
  };
  assemble_tile<DEPTH>(stage, s_slot, s_type, s_par, noise[p], ts, ts, mask,
                       mask, out + (size_t)p * N * N, N, N, 1, masked, 0);
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
  dim3 grid((N + kCols - 1) / kCols, (N + kRows - 1) / kRows, P);
  // A heap of M = 2^D - 1 slots holds trees of at most D levels.
  auto kernel = M <= 31 ? cov_slot_kernel<5> : cov_slot_kernel<kMaxDepth>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)node_type, (const int*)order, (const float*)params,
      (const float*)noise, (const float*)ts, (const float*)mask, (float*)out,
      M, N, masked);
  return (int)cudaGetLastError();
}
