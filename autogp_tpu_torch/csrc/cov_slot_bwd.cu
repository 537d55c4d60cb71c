// Backward of the per-slot covariance assembly (cov_slot.cu): the gradient
// of sum_ij Kbar_ij K_ij with respect to the transformed node parameters
// [M, 3] and the noise of each particle, for a given cotangent Kbar; the
// input is the heap itself, with no instruction tape.
//
// Replaces: autogp_tpu/ops/cov_pallas_vjp.py, _bwd_kernel (with its forward
// sweep _fwd_values), launched there by _cov_grads, the backward of
// cov_matrix_diff(tape=False).
//
// What it computes: for particle p with heap node_type[p] ([M] slots,
// children of s at 2s + 1 and 2s + 2, type 0 = empty) and the static
// post-order `order` of the full heap, every element (i, j) takes kbar =
// Kbar_ij (times m_i m_j when `masked`), runs the tree forward storing
// each active slot's value, then in reverse (parents before children) to
// propagate adjoints from the root and add each leaf's and ChangePoint's
// d K_ij / d theta, times its adjoint, into theta's slot; kbar on the
// diagonal goes to the noise. out[p] = [pbar (M x 3), nbar]. No symmetry
// of Kbar is assumed: every element is visited with weight 1. Any N >= 1.
//
// What bounds it on this card: what bounds kernel 5b, the tape backward's
// unfused entry (cov_tape_bwd.cu), whose contract it shares: instruction
// issue on the accurate expf / logf / sinf, IEEE divisions and double
// adjoint arithmetic of two sweeps of the active nodes per element; 4
// bytes of Kbar read per element. The TPU kernel sweeps all M slots in
// both directions, a type test for each. The design this replaces did the
// same per element, one block per 32 x 32 tile (65,536 blocks at
// [64, 1024, 1024], each staging, zeroing and reducing again), values and
// adjoints sized by the heap ([M][threads], 93 KB at M = 31, two blocks
// per SM), and a warp shuffle reduction for every gradient term of every
// element: 6.86 ms at [64, 1024, 1024] on an H100 SXM, 5b 1.48.
//
// What the design does about it: the heap becomes a tape on the device,
// then kernel 5b's body runs on it. Three launches, nothing between them:
// - heap_tape_kernel, one warp per particle, writes the post-order tape
//   of the active slots -- (slot, type, lpos, rpos) [P, M] and the length
//   [P], the arrays ops/cov.py build_tape writes, entry for entry -- into
//   scratch the wrapper allocates. It walks `order` 32 slots at a time (at
//   most 8 chunks at M = 255): each lane reads one slot's type, a ballot
//   marks the active ones and a popcount of the lanes below gives each its
//   tape position (and every slot the position build_tape gives it); a
//   second pass reads each position's children's positions.
// - autogp_cov_tape_bwd_unfused, kernel 5b's entry, on those tapes: its
//   body (runs of tiles per block, per-thread double accumulators under a
//   compact term index, stacks sized by the block's own tape, particles
//   ranked by decreasing tape length), then reduce_tiles_kernel over the
//   [P, chunks, 3M + 1] partials. The same kernels on the same tapes, so
//   the result is bitwise 5b's on the same inputs.
//
// An operator on the heap's last level (no room for children; the prior
// never samples one) stays on the tape with no child positions (lpos =
// rpos = -1), as build_tape writes it, and 5b's body runs it as it runs it
// for 5b: its value and gradient are then undefined in both.

#include "cov_formulas.cuh"

// Kernel 5b's entry (cov_tape_bwd.cu).
extern "C" int autogp_cov_tape_bwd_unfused(
    const void* tslot, const void* ttype, const void* tlpos,
    const void* trpos, const void* tlen, const void* params, const void* ts,
    const void* mask, const void* kbar, void* partial, void* out, int P,
    int M, int N, int masked, void* stream);

namespace {

using namespace autogp;

constexpr int kTapeWarps = 4;  // particles per block of heap_tape_kernel

// Warp w of block b compacts particle 4 b + w's heap into its tape.
__global__ void __launch_bounds__(32 * kTapeWarps)
heap_tape_kernel(const int* __restrict__ node_type,
                 const int* __restrict__ order, int* __restrict__ tslot,
                 int* __restrict__ ttype, int* __restrict__ tlpos,
                 int* __restrict__ trpos, int* __restrict__ tlen, int P,
                 int M) {
  __shared__ int s_pos[kTapeWarps][kMaxSlots];   // tape position of a slot
  __shared__ int s_slot[kTapeWarps][kMaxSlots];  // slot of a position
  __shared__ int s_type[kTapeWarps][kMaxSlots];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.x * kTapeWarps + w;
  if (p >= P) return;
  int* pos = s_pos[w];
  int* slot = s_slot[w];
  int* type = s_type[w];
  const int* heap = node_type + (long long)p * M;

  // Active slots in post-order. Every slot gets build_tape's position:
  // the active slots up to and including it in post-order, less one.
  int len = 0;
  for (int q0 = 0; q0 < M; q0 += 32) {
    const int q = q0 + lane;
    const int s = q < M ? order[q] : 0;
    const int t = q < M ? heap[s] : 0;
    const unsigned act = __ballot_sync(0xffffffffu, t != 0);
    const int at = len + __popc(act & ((1u << lane) - 1u));
    if (q < M) pos[s] = at + (t != 0) - 1;
    if (t != 0) {
      slot[at] = s;
      type[at] = t;
    }
    len += __popc(act);
  }
  __syncwarp();

  // The tape; no-ops (slot 0, type 0, no children) from the length on.
  const long long row = (long long)p * M;
  for (int q = lane; q < M; q += 32) {
    int s = 0, t = 0, l = -1, r = -1;
    if (q < len) {
      s = slot[q];
      t = type[q];
      if (2 * s + 1 < M) {  // M = 2^D - 1: then 2s + 2 < M too
        l = pos[2 * s + 1];
        r = pos[2 * s + 2];
      }
    }
    tslot[row + q] = s;
    ttype[row + q] = t;
    tlpos[row + q] = l;
    trpos[row + q] = r;
  }
  if (lane == 0) tlen[p] = len;
}

}  // namespace

// node_type [P, M] int32 heaps (M = 2^D - 1); order [M] int32, the
// post-order of the full heap; params [P, M, 3], ts and mask [N], kbar
// [P, N, N] float32; tapes scratch [4 P M + P] int32 (the tape's slot,
// type, lpos and rpos [P, M] each, then the lengths [P]); partial scratch
// [P, chunks, 3M + 1] float64, chunks = min(n^2, max(1, 8448 / P)) for
// n = ceil(N / 32) (ops/cov_vjp.py bwd_chunks, unfused); out [P, 3M + 1]
// float32. Any N >= 1.
extern "C" int autogp_cov_slot_bwd(const void* node_type, const void* order,
                                   const void* params, const void* ts,
                                   const void* mask, const void* kbar,
                                   void* tapes, void* partial, void* out,
                                   int P, int M, int N, int masked,
                                   void* stream) {
  if (M < 1 || M > kMaxSlots || (M & (M + 1)) != 0 || N < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  int* tp = (int*)tapes;
  const long long pm = (long long)P * M;
  heap_tape_kernel<<<(P + kTapeWarps - 1) / kTapeWarps, 32 * kTapeWarps, 0,
                     (cudaStream_t)stream>>>(
      (const int*)node_type, (const int*)order, tp, tp + pm, tp + 2 * pm,
      tp + 3 * pm, tp + 4 * pm, P, M);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return autogp_cov_tape_bwd_unfused(tp, tp + pm, tp + 2 * pm, tp + 3 * pm,
                                     tp + 4 * pm, params, ts, mask, kbar,
                                     partial, out, P, M, N, masked, stream);
}
