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
// blocks skipped). The warps walk `order` in chunks of 32 slots, in rounds
// of up to 256 chunks: each warp ballots its chunks (a lane a slot, active
// or not), warp 0 scans the chunks' counts into their first tape
// positions, and each active lane writes its slot's type and parameters
// at its position (its chunk's first plus a popcount of the lanes below).
// The output is therefore bitwise kernel 1's full gram. One launch per
// call; the wrapper builds no tape.
//
// What bounds it in depth: the tape, as in kernel 1 -- the batch's longest
// tape L and tallest stack (ops/cov.py heap_maxima, from the heap) size
// the staging (16 bytes a position) and pick the stack instance; the
// round's chunk table takes 2 KB more. The longest tape a block stages is
// 14399 positions.
//
// An operator on the heap's last level (no room for children; the prior
// never samples one) stays on the tape, as build_tape keeps it, and pops
// two values as kernel 1 does.

#include "cov_assemble.cuh"

namespace {

using namespace autogp;

constexpr int kWarpsPerBlock = kRowsPerPass;   // 8
constexpr int kRoundChunks = 256;              // chunks of 32 slots a round

// Shared memory of one block: s_par [L, 3] floats, s_type [L] ints, the
// length, and the round's chunk masks and first positions.
inline size_t slot_smem(int L) {
  return 16 * (size_t)L + 4 * (1 + 2 * kRoundChunks);
}

template <int DEPTH>
__global__ void __launch_bounds__(kTile * kRowsPerPass)
cov_slot_kernel(const int* __restrict__ node_type,
                const int* __restrict__ order,
                const float* __restrict__ params,
                const float* __restrict__ noise, const float* __restrict__ ts,
                const float* __restrict__ mask, float* __restrict__ out,
                int M, int L, int N, int masked) {
  extern __shared__ float smem_f[];
  float* s_par = smem_f;
  int* s_type = reinterpret_cast<int*>(s_par + 3 * L);
  int* s_len = s_type + L;
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_len + 1);
  int* s_first = reinterpret_cast<int*>(s_mask + kRoundChunks);

  const int p = blockIdx.z;
  const int* heap = node_type + (size_t)p * M;
  const float* pp = params + (size_t)p * 3 * M;
  const int tx = threadIdx.x, warp = threadIdx.y;
  const unsigned below = (1u << tx) - 1u;
  // Slot q of the post-order and its type (0 past the heap).
  auto slot_at = [&](int q, int& s, int& t) {
    s = q < M ? order[q] : 0;
    t = q < M ? heap[s] : 0;
  };
  // The particle's tape, compacted from its heap by every warp, a round of
  // up to 256 chunks at a time.
  auto stage = [&]() {
    int len = 0;
    for (int r0 = 0; r0 < M; r0 += kRoundChunks * kTile) {
      const int nc = min(kRoundChunks, (M - r0 + kTile - 1) / kTile);
      for (int c = warp; c < nc; c += kWarpsPerBlock) {
        int s, t;
        slot_at(r0 + c * kTile + tx, s, t);
        const unsigned act = __ballot_sync(0xffffffffu, t != 0);
        if (tx == 0) s_mask[c] = act;
      }
      __syncthreads();
      if (warp == 0) {
        // First tape position of each chunk: an exclusive scan of the
        // chunks' counts, 32 chunks at a time.
        int base = len;
        for (int c0 = 0; c0 < nc; c0 += kTile) {
          const int c = c0 + tx;
          const int n = c < nc ? __popc(s_mask[c]) : 0;
          int x = n;
          for (int o = 1; o < kTile; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, o);
            if (tx >= o) x += y;
          }
          if (c < nc) s_first[c] = base + x - n;
          base += __shfl_sync(0xffffffffu, x, kTile - 1);
        }
        if (tx == 0) *s_len = base;
      }
      __syncthreads();
      for (int c = warp; c < nc; c += kWarpsPerBlock) {
        int s, t;
        slot_at(r0 + c * kTile + tx, s, t);
        if (t != 0) {
          const int at = s_first[c] + __popc(s_mask[c] & below);
          s_type[at] = t;
          s_par[3 * at] = pp[3 * s];
          s_par[3 * at + 1] = pp[3 * s + 1];
          s_par[3 * at + 2] = pp[3 * s + 2];
        }
      }
      len = *s_len;
      __syncthreads();   // the round's table is read before it is reused
    }
    return len;
  };
  assemble_tile<DEPTH>(stage, s_type, s_par, noise[p], ts, ts, mask, mask,
                       out + (size_t)p * N * N, N, N, 1, masked, 0);
}

}  // namespace

// node_type [P, M] int32 heaps; order [M] int32, the post-order of the full
// heap; params [P, M, 3], noise [P], ts and mask [N] float32; out [P, N, N]
// float32. Any N >= 1. max_len and max_height: the batch's longest tape
// and tallest stack (ops/cov.py heap_maxima).
extern "C" int autogp_cov_slot(const void* node_type, const void* order,
                               const void* params, const void* noise,
                               const void* ts, const void* mask, void* out,
                               int P, int M, int N, int masked, int max_len,
                               int max_height, void* stream) {
  const int depth = stack_instance(max_height);
  const size_t smem = slot_smem(max_len);
  if (M < 1 || N < 1 || P < 1 || max_len < 1 || max_len > M || depth == 0 ||
      smem > (size_t)kSmemPerBlock)
    return (int)cudaErrorInvalidValue;
  auto kernel = depth == 5    ? cov_slot_kernel<5>
                : depth == 8  ? cov_slot_kernel<8>
                : depth == 12 ? cov_slot_kernel<12>
                : depth == 16 ? cov_slot_kernel<16>
                              : cov_slot_kernel<kLocalDepth>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 block(kTile, kRowsPerPass);
  dim3 grid((N + kCols - 1) / kCols, (N + kRows - 1) / kRows, P);
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int*)node_type, (const int*)order, (const float*)params,
      (const float*)noise, (const float*)ts, (const float*)mask, (float*)out,
      M, max_len, N, masked);
  return (int)cudaGetLastError();
}
