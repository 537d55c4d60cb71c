// Backward of the tape-driven covariance assembly: the gradient with
// respect to the transformed node parameters [M, 3] and the noise of each
// particle. Three entries, one kernel:
//
// - fused with the MVN cotangent, over the lower triangle (the LML
//   gradient, autogp_cov_tape_bwd);
// - the same with the K^-1 tiles formed in the kernel from L^-1 (the LML
//   gradient's in-tape L^-1 backend, autogp_cov_tape_bwd_linv);
// - unfused, for a given cotangent Kbar [P, N, N] of the assembled matrix
//   (autogp_cov_tape_bwd_unfused, the backward of cov_matrix_diff).
//
// Replaces: autogp_tpu/ops/cov_pallas_vjp.py, _bwd_kernel_tape, launched
// there by _cov_grads_tape: fused=True, sym=True under lml_tape_fused's
// backward (with linv=True when INTAPE_LINV is set), and beta=None
// (kbar_ref holds the cotangent) under cov_matrix_diff's.
//
// What it computes: for particle p with tape (slot, type, lpos, rpos, len)
// from ops/cov.py build_tape, every element (i, j) of a lower tile forms
// its cotangent
//   kbar = 0.5 g (beta_i beta_j - Kinv_ij) m_i m_j w_ij,
//   w = 2 below the diagonal, 1 on it, 0 above
// (Kinv lower-only, from the kinv kernel), runs the tape forward to store
// every position's value, then backward in reverse post-order (parents
// before children) to propagate adjoints and add each leaf's and
// ChangePoint's d K_ij / d theta, times its adjoint, into theta's slot;
// kbar on the diagonal goes to the noise. out[p] = [pbar (M x 3), nbar].
// The formulas are the reference's guarded ones (cov_pallas_vjp.py:
// 313-523): ChangePoint is a sigmoid, and pi / p is a true division
// (cov_formulas.cuh). Where the reference recovers GammaExponential's and
// Periodic's exponents from the stored value with a clamped log, they are
// recomputed, and Periodic's argument is reduced in double: the gradient's
// terms cancel, and those roundings were 1e-5 to 2e-4 of the terms' size
// on config 3's candidates.
//
// The in-tape L^-1 entry takes V = L^-1 [P, N, N] (exact zeros above the
// diagonal, kinv.cu's autogp_linv_beta) in place of K^-1. Before the
// sweeps of each tile the block forms that tile of K^-1, K^-1[i, j] =
// sum_{r >= 32 ti} V[r, i] V[r, j] (exact: V[r, i] = 0 for r < i), from
// the two column strips V[32 ti:, ti-tile] and V[32 ti:, tj-tile] on the
// tensor cores in 3xTF32 (tf32x3.cuh): each warp owns one m16n8 fragment
// of the tile and adds its products 8 rows at a time, ascending from the
// fragment's first row, in a partial sum per 32 rows added to an FP32
// sum, exactly as kinv.cu's kinv_lower_kernel does for the same element
// (column i as the A operand), so the two K^-1 agree bit for bit; the
// cotangent is then formed as in the fused entry. K^-1 never exists in
// device memory. The contraction costs 2 * 32^2 * (N - 32 ti)
// FP32-class operations per tile (three TF32 products each), ~0.39 GFLOP
// per particle at N = 1024, and each tile re-reads its two strips (~8
// flops per byte). The strips pass through shared memory 32 rows at a
// time, double-buffered by cp.async into rows padded to 40 floats (a
// fragment load touches 32 banks), in the stack memory the sweeps use
// afterwards. Each warp's fragment is one chain of dependent mma.sync, so
// the contraction is bound by their latency and the copies', not by the
// tensor cores' rate (two tiles per pass, two chains per warp on 16-row
// slabs, ran 8% slower).
//
// The unfused entry reads kbar = Kbar_ij (times m_i m_j when `masked`)
// from its input instead: no symmetry is assumed, every element of every
// tile of the matrix is visited with weight 1, and N need not be a
// multiple of the tile (edge threads run on a clamped element with
// cotangent 0). The per-slot backward (cov_slot_bwd.cu, kernel 7) calls
// this entry on tapes it compacts from the heap on the device.
//
// What bounds it on this card: instruction issue. An element runs the tape
// twice (up to 2^D - 1 positions, a few in most trees), each position a few
// shared-memory reads and a formula whose accurate expf / logf / sinf and
// IEEE divisions take ~10-30 instructions each, with double adjoint
// arithmetic; the special-function bound at [64, 1024, 1024] (0.027 ms)
// counts one operation for each of those sequences. The design this
// replaces (one block per 32 x 32 lower tile, a warp reduction per
// gradient term per element, stacks sized by the heap's M, two 97 KB
// blocks per SM) took 1.40 ms there; its clock split
// (scripts/tape_bwd_split.py, per tile, thread 0): staging 9%, the
// cotangent's loads 19%, forward sweep 21%, reverse sweep 34%, the
// per-term warp reductions 14%, the tile's partial 4%, and the 43% of
// lower tiles wholly masked at 768 of 1024 points cost as much as active
// ones. A tile of a long tape took up to 4x the mean.
//
// What the design does about it:
// - Each block walks a contiguous run of its particle's tiles: in the
//   fused entries only the active lower tiles, those whose 32 rows and 32
//   columns each hold a point with mask != 0 (the block lists the active
//   tile rows from the mask itself, with ballots: no host sync), in the
//   unfused entry all of them. The grid is (chunks, P), chunks =
//   min(tiles, kTargetBlocks / P), ~16 waves, so the staging, the
//   accumulator zeroing and the final reduction are paid once per run of
//   ~3-5 tiles. In the fused entries an element whose cotangent is
//   structurally zero (above the diagonal, or masked) runs no sweep.
// - blockIdx.y is a rank, not a particle: each block finds the particle
//   of that rank in the order of decreasing tape length, so the blocks of
//   the longest tapes start first and the short ones fill in behind them
//   (longest-processing-time-first, against the tail a long tape left).
// - Each thread adds its gradient terms into its own double accumulators
//   in shared memory ([term][thread], conflict-free), under a compact
//   per-tape term index (position q's terms at off[q] + k, a warp scan;
//   <= 2 len + 2 terms with the noise), over every element it visits.
//   Once per block, after the last tile, each warp sums its lanes term by
//   term with xor shuffles and the warps are summed in order into the
//   block's partial [P, chunks, 3M + 1]; a second small pass sums each
//   particle's chunks in order. No atomics: the gradient repeats bit for
//   bit from run to run, and the fused and in-tape entries share every
//   sum.
// - Values (float), adjoints (double) and the accumulators are sized by
//   the block's own tape, not by the heap's M: the block runs
//   T = min(256, budget / (12 len + 8 terms)) of its 256 threads (a
//   multiple of 32 from 32 up), so a tape of up to 5 positions uses all
//   256 within a 48 KB budget and four blocks fit an SM (32 warps, 64
//   registers); the in-tape entry has a budget of 46 KB, of which its
//   double-buffered staging takes 20 KB, and its four blocks fit an SM
//   with their 4 KB K^-1 tiles. A long tape runs on fewer threads of the
//   same block.
//   When the grid is too small to fill the card (one tile per particle at
//   N <= 32, the online run's bucket), the budget grows to the share of
//   an SM that still runs the whole grid at once, so that a long tape
//   keeps its threads. The in-tape entry's staging strips take the stack
//   memory, idle until a tile's sweeps.
// - A thread loads the next element's K^-1 (or cotangent) value before
//   the current element's sweeps.
//
// Precision: the gradient is a sum of ~5e5 terms per particle at N = 1024
// that cancel heavily when the gram is ill-conditioned (beta beta^T and
// K^-1 are both large where their difference is not). So the cotangent is
// formed in double from the float32 inputs (the product of two floats is
// exact in double), adjoints are carried in double, and every sum is in
// double; only the tree's values and derivative factors are float32, each
// with its own relative rounding.

#include "cov_formulas.cuh"
#include "tf32x3.cuh"

namespace {

using namespace autogp;

constexpr int kThreads = 256;             // blockDim = (32, 8)
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;             // blocks per SM the budget allows
constexpr int kBudget = 48 * 1024;        // accumulators + stacks, bytes,
                                          // when the grid fills the card
constexpr int kBudgetLinv = 46 * 1024;    // the same, in-tape entry (its
                                          // K^-1 tile takes 4 KB more)
constexpr int kLdV = kTile + 8;           // staged V rows, padded
constexpr int kVStage = 2 * kTile * kLdV; // floats: a slab of both strips
constexpr int kVStages = 2;               // the in-tape entry's ring
// Its staging, and 16 bytes to align it.
constexpr int kStaging = kVStages * kVStage * (int)sizeof(float) + 16;
constexpr int kTargetBlocks = 8448;       // 16 x 4 blocks x 132 SMs

// Gradient terms of a tape instruction of type t: the acc(base + k) calls
// of ref_leaf_grad / ref_op_adjoint.
__host__ __device__ inline int terms_of(int t) {
  switch (t) {
    case CONSTANT:
    case WHITE_NOISE:
    case CHANGEPOINT:
      return 1;
    case SQUARED_EXPONENTIAL:
      return 2;
    case LINEAR:
    case GAMMA_EXPONENTIAL:
    case PERIODIC:
      return 3;
    default:
      return 0;
  }
}

// Threads a block runs for a tape of `len` positions and `n_terms` terms
// (the noise's included): the most, up to kThreads and a multiple of 32
// from 32 up, whose accumulators (8 n_terms each) and stacks (12 len each,
// or the in-tape staging strips if larger) fit `budget` bytes.
__host__ __device__ inline int bwd_threads(int len, int n_terms, bool linv,
                                           int budget) {
  int t = budget / (12 * len + 8 * n_terms);
  if (linv) t = min(t, (budget - kStaging) / (8 * n_terms));
  t = min(t, kThreads);
  return t >= 32 ? t / 32 * 32 : max(t, 1);
}

// Blocks per particle: kTargetBlocks shared by the batch, at most one per
// tile.
__host__ __device__ inline int bwd_chunks(int P, int n_tiles) {
  return min(n_tiles, max(1, kTargetBlocks / P));
}

// Tiles of a particle: the lower tiles over n_rows tile rows (fused), or
// all nt^2 tiles.
__host__ __device__ inline int tile_count(bool fused, int n) {
  return fused ? n * (n + 1) / 2 : n * n;
}

// Term k of a compact index adds into thread `tid`'s column.
struct ThreadAcc {
  double* a;
  int T, tid;
  __device__ __forceinline__ void operator()(int idx, double term) const {
    a[idx * T + tid] += term;
  }
};

// K^-1[i, j] = sum_{r >= 32 ti} V[r, i] V[r, j] for the tile (ti, tj), into
// kinv_t[i - 32 ti][j - 32 tj], on the tensor cores. Warp w (= ty) owns
// the m16n8 fragment at rows 16 (w / 4), columns 8 (w % 4), and adds the
// 3xTF32 products of 8 rows at a time with column i as the A operand,
// ascending from the fragment's first row 32 ti + 16 (w / 4) (the rows
// above hold zeros of V), each slab's into a partial from +0 then added
// to the sum: element for element what kinv_lower_kernel adds. V's two
// column strips pass through `stage` (16-byte aligned, kVStages stages of
// kVStage floats) 32 rows at a time, one 16-byte cp.async of each strip
// per thread and slab, the next slab in flight while the current one
// multiplies, one barrier per slab.
__device__ void kinv_tile(const float* __restrict__ vp, int N, int ti,
                          int tj, float* stage, float* kinv_t) {
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int wm = threadIdx.y >> 2, wn = threadIdx.y & 3;
  const int r0 = ti * kTile, nk = (N - r0) / kTile;
  const int lr = tid >> 3, lc = (tid & 7) * 4;
  auto load = [&](int s) {
    float* st = stage + (s % kVStages) * kVStage + lr * kLdV + lc;
    const float* src = vp + (long long)(r0 + s * kTile + lr) * N + lc;
    cp_async16(st, src + ti * kTile);
    cp_async16(st + kTile * kLdV, src + tj * kTile);
  };
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < kVStages - 1; ++s) {
    if (s < nk) load(s);
    cp_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_wait<kVStages - 2>();
    __syncthreads();  // slab s landed for all; slab s - 1 consumed by all
    if (s + kVStages - 1 < nk) load(s + kVStages - 1);
    cp_commit();
    const float* sa = stage + (s % kVStages) * kVStage;
    const float* sb = sa + kTile * kLdV;
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k8 = 0; k8 < kTile; k8 += 8) {
      if (s * kTile + k8 < 16 * wm) continue;
      unsigned ah[4], al[4], bh[2], bl[2];
      frag_a_km(sa + k8 * kLdV + 16 * wm, kLdV, ah, al);
      frag_b_kn(sb + k8 * kLdV + 8 * wn, kLdV, bh, bl);
      mma_3xtf32(part, ah, al, bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += part[e];
  }
  cp_wait<0>();
  __syncthreads();  // every slab consumed before the stacks are reused
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  float* d = kinv_t + (16 * wm + g) * kTile + 8 * wn + 2 * t;
  d[0] = acc[0];
  d[1] = acc[1];
  d[8 * kTile] = acc[2];
  d[8 * kTile + 1] = acc[3];
}

// Grid (chunks, P), block (32, 8). FUSED: `kmat` is the lower-only K^-1
// (with LINV: V = L^-1) and the tiles are the active lower ones; otherwise
// `kmat` is the cotangent itself and the tiles are all (N / 32 rounded
// up)^2.
template <bool FUSED, bool LINV>
__global__ void
__launch_bounds__(kThreads, kMinBlocks)
cov_tape_bwd_kernel(
    const int* __restrict__ tslot, const int* __restrict__ ttype,
    const int* __restrict__ tlpos, const int* __restrict__ trpos,
    const int* __restrict__ tlen, const float* __restrict__ params,
    const float* __restrict__ ts, const float* __restrict__ mask,
    const float* __restrict__ kmat, const float* __restrict__ beta,
    const float* __restrict__ gscale, double* __restrict__ partial, int M,
    int N, int masked, int budget) {
  extern __shared__ __align__(16) double smem_d[];
  const int n_acc = 3 * M + 1;
  const int nt = (N + kTile - 1) / kTile;
  double* region = smem_d;                                // budget bytes
  double* wsum = smem_d + budget / 8;                     // [kWarps][2M + 2]
  float* s_par = reinterpret_cast<float*>(wsum + kWarps * (2 * M + 2));
  float* kinv_t = s_par + 3 * M;                          // LINV: [32][32]
  int* s_slot = reinterpret_cast<int*>(kinv_t + (LINV ? kTile * kTile : 0));
  int* s_type = s_slot + M;                               // [M] each
  int* s_l = s_type + M;
  int* s_r = s_l + M;
  int* s_off = s_r + M;
  int* s_cof = s_off + M;                                 // [3M + 1]
  int* s_rows = s_cof + n_acc;                            // [nt]
  int* s_misc = s_rows + nt;                  // terms, rows, particle
  int* s_len = s_misc + 3;                                // [P]

  const int P = gridDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int warp = tid / 32, lane = tid % 32;

  // This block's particle: the one of rank blockIdx.y in the order of
  // decreasing tape length (ties by index), so that the blocks of the
  // longest tapes start first and the short ones fill in behind them.
  for (int q = tid; q < P; q += kThreads) s_len[q] = tlen[q];
  __syncthreads();
  for (int q = tid; q < P; q += kThreads) {
    const int lq = s_len[q];
    int rank = 0;
    for (int r = 0; r < P; ++r)
      rank += (s_len[r] > lq) || (s_len[r] == lq && r < q);
    if (rank == (int)blockIdx.y) s_misc[2] = q;
  }
  __syncthreads();
  const int p = s_misc[2];
  const int len = s_len[p];

  // Staging: the tape, the parameters, and (fused) which tile rows hold an
  // active point.
  for (int k = tid; k < M; k += kThreads) {
    s_slot[k] = tslot[(long long)p * M + k];
    s_type[k] = ttype[(long long)p * M + k];
    s_l[k] = tlpos[(long long)p * M + k];
    s_r[k] = trpos[(long long)p * M + k];
  }
  for (int k = tid; k < 3 * M; k += kThreads)
    s_par[k] = params[(long long)p * 3 * M + k];
  for (int k = tid; k < n_acc; k += kThreads) s_cof[k] = -1;
  if (FUSED) {
    for (int r = warp; r < nt; r += kWarps) {
      const unsigned act =
          __ballot_sync(0xffffffffu, mask[r * kTile + lane] != 0.0f);
      if (lane == 0) s_rows[r] = (act != 0u);
    }
  }
  __syncthreads();
  constexpr unsigned kAll = 0xffffffffu;
  if (warp == 0) {
    // Compact term offsets, in tape order: an exclusive scan of the terms
    // per position, 32 positions at a time. The noise's term is the last.
    int base = 0;
    for (int q0 = 0; q0 < len; q0 += 32) {
      const int q = q0 + lane;
      const int c = q < len ? terms_of(s_type[q]) : 0;
      int x = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, x, o);
        if (lane >= o) x += y;
      }
      if (q < len) s_off[q] = base + x - c;
      base += __shfl_sync(kAll, x, 31);
    }
    if (lane == 0) s_misc[0] = base + 1;
  } else if (warp == 1) {
    // The active tile rows, in order (in place: a row is read before any
    // lane writes at or below it).
    int a = 0;
    if (FUSED) {
      for (int r0 = 0; r0 < nt; r0 += 32) {
        const int r = r0 + lane;
        const bool f = r < nt && s_rows[r] != 0;
        const unsigned b = __ballot_sync(kAll, f);
        if (f) s_rows[a + __popc(b & ((1u << lane) - 1u))] = r;
        a += __popc(b);
      }
    }
    if (lane == 0) s_misc[1] = a;
  }
  __syncthreads();
  const int n_terms = s_misc[0];
  for (int q = tid; q < len; q += kThreads) {
    const int c = terms_of(s_type[q]);
    for (int k = 0; k < c; ++k) s_cof[3 * s_slot[q] + k] = s_off[q] + k;
  }
  if (tid == 0) s_cof[n_acc - 1] = n_terms - 1;
  const int T = bwd_threads(len, n_terms, LINV, budget);
  double* acc_d = region;                                 // [n_terms][T]
  double* adj = acc_d + n_terms * T;                      // [len][T]
  float* val = reinterpret_cast<float*>(adj + len * T);   // [len][T]
  if (tid < T)
    for (int c = 0; c < n_terms; ++c) acc_d[c * T + tid] = 0.0;
  const ThreadAcc acc{acc_d, T, tid};

  // This block's run of tiles.
  const int n_tiles = tile_count(FUSED, FUSED ? s_misc[1] : nt);
  const int per = (n_tiles + gridDim.x - 1) / gridDim.x;
  const int k0 = blockIdx.x * per;
  const int k1 = min(k0 + per, n_tiles);
  const float* kp = kmat + (long long)p * N * N;
  const double g = FUSED ? (double)gscale[p] : 0.0;
  const float* bp = FUSED ? beta + (long long)p * N : nullptr;
  // split: staged
  for (int k = k0; k < k1; ++k) {
    int ti, tj;
    if (FUSED) {
      // Active lower tile k = a (a + 1) / 2 + b of the active rows.
      int a = (int)((sqrtf(8.0f * (float)k + 1.0f) - 1.0f) * 0.5f);
      while ((a + 1) * (a + 2) / 2 <= k) ++a;
      while (a * (a + 1) / 2 > k) --a;
      ti = s_rows[a];
      tj = s_rows[k - a * (a + 1) / 2];
    } else {
      ti = k / nt;
      tj = k - ti * nt;
    }
    if (LINV) {
      // Staging in the stacks, idle before the sweeps, 16-byte aligned.
      __syncthreads();
      kinv_tile(kp, N, ti, tj,
                reinterpret_cast<float*>(adj + (n_terms * T & 1)), kinv_t);
      __syncthreads();
    }
    if (tid >= T) continue;
    // The thread's elements e = tid + n T of the tile; the K^-1 (or
    // cotangent) value of the next one is loaded before this one's sweeps.
    // The fused entries take N a multiple of the tile, so the clamps bind
    // in the unfused entry only.
    auto kmat_at = [&](int e_) {
      const int i = min(ti * kTile + e_ / kTile, N - 1);
      const int j = min(tj * kTile + e_ % kTile, N - 1);
      return kp[(long long)i * N + j];
    };
    float kv_next = LINV ? 0.0f : kmat_at(tid);
    for (int e_ = tid; e_ < kTile * kTile; e_ += T) {
      const float kv = kv_next;
      if (!LINV && e_ + T < kTile * kTile) kv_next = kmat_at(e_ + T);
      const int rr = e_ / kTile, cc = e_ % kTile;
      const int i_raw = ti * kTile + rr, j_raw = tj * kTile + cc;
      const int i = FUSED ? i_raw : min(i_raw, N - 1);
      const int j = FUSED ? j_raw : min(j_raw, N - 1);

      // Cotangent of this element, in the reference's operation order.
      double kb;
      if (FUSED) {
        const float mm = mask[i] * mask[j];
        if (i < j || mm == 0.0f) continue;  // cotangent 0: nothing to add
        const double kij =
            LINV ? (double)kinv_t[rr * kTile + cc] : (double)kv;
        kb = (0.5 * g) * ((double)bp[i] * (double)bp[j] - kij);
        kb = kb * (double)mm;
        const double w = (i > j) ? 2.0 : 1.0;
        kb = kb * w;
      } else {
        kb = (i_raw < N && j_raw < N) ? (double)kv : 0.0;
        if (masked) kb = kb * (double)(mask[i] * mask[j]);
      }
      if (i_raw == j_raw) acc(n_terms - 1, kb);
      const Elem e(ts[i], ts[j]);
      // split: cotangent

      // Forward sweep: the value of every tape position.
      for (int q = 0; q < len; ++q) {
        const float* pr = s_par + 3 * s_slot[q];
        const int t = s_type[q];
        val[q * T + tid] =
            is_op(t) ? ref_op_value(t, pr, val[s_l[q] * T + tid],
                                    val[s_r[q] * T + tid], e)
                     : ref_leaf_value(t, pr, e);
      }
      // split: forward

      // Reverse sweep: adjoints, and the gradient terms.
      if (len > 0) adj[(len - 1) * T + tid] = kb;
      for (int q = len - 1; q >= 0; --q) {
        const int t = s_type[q];
        const float* pr = s_par + 3 * s_slot[q];
        const double a = adj[q * T + tid];
        if (is_op(t)) {
          double al, ar;
          ref_op_adjoint(t, pr, val[s_l[q] * T + tid], val[s_r[q] * T + tid],
                         a, e, s_off[q], al, ar, acc);
          adj[s_l[q] * T + tid] = al;
          adj[s_r[q] * T + tid] = ar;
        } else {
          ref_leaf_grad(t, pr, val[q * T + tid], a, e, s_off[q], acc);
        }
      }
      // split: reverse
    }
  }
  __syncthreads();
  // split: barrier

  // Each warp sums its lanes term by term, then the warps in order into
  // this block's partial, at the terms' slot indices (0 elsewhere).
  for (int c = 0; c < n_terms; ++c) {
    const double v = warp_sum(tid < T ? acc_d[c * T + tid] : 0.0);
    if (lane == 0) wsum[warp * (2 * M + 2) + c] = v;
  }
  __syncthreads();
  double* out = partial + ((long long)p * gridDim.x + blockIdx.x) * n_acc;
  for (int k = tid; k < n_acc; k += kThreads) {
    const int c = s_cof[k];
    double s = 0.0;
    if (c >= 0)
      for (int w = 0; w < kWarps; ++w) s += wsum[w * (2 * M + 2) + c];
    out[k] = s;
  }
  // split: partials
}

// out[p, k] = sum over tiles of partial[p, tile, k], tiles in order.
__global__ void reduce_tiles_kernel(const double* __restrict__ partial,
                                    float* __restrict__ out,
                                    int n_tiles, int n_acc) {
  const int p = blockIdx.x;
  const double* pp = partial + (long long)p * n_tiles * n_acc;
  for (int k = threadIdx.x; k < n_acc; k += blockDim.x) {
    double s = 0.0;
    for (int t = 0; t < n_tiles; ++t) s += pp[(long long)t * n_acc + k];
    out[(long long)p * n_acc + k] = (float)s;
  }
}

// Dynamic shared memory of one block besides the accumulators and
// stacks, in bytes.
int bwd_table_bytes(int M, int nt, int P, bool linv) {
  return 8 * kWarps * (2 * M + 2) + 4 * 3 * M +
         (linv ? 4 * kTile * kTile : 0) +
         4 * (5 * M + 3 * M + 1 + nt + 3 + P);
}

// Bytes for the accumulators and stacks: `base` (kBudget; kBudgetLinv for
// the in-tape entry), or more when the grid is too small to fill the card
// at that size -- the share of an SM that lets the whole grid run at once,
// so that a long tape keeps its threads when only a few blocks run (one
// tile per particle at N <= 32).
int bwd_budget(int blocks, int tables, int base) {
  int dev = 0, sms = 1, per_sm = 0, per_block = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_block,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return base;
  const int resident = (blocks + sms - 1) / sms;   // blocks per SM, one wave
  const int fit = min(per_sm / resident - 1024, per_block) - tables;
  return max(base, fit / 8 * 8);
}

template <bool FUSED, bool LINV>
int launch(const void* tslot, const void* ttype, const void* tlpos,
           const void* trpos, const void* tlen, const void* params,
           const void* ts, const void* mask, const void* kmat,
           const void* beta, const void* g, void* partial, void* out, int P,
           int M, int N, int masked, void* stream) {
  const int nt = (N + kTile - 1) / kTile;
  const int chunks = bwd_chunks(P, tile_count(FUSED, nt));
  const int tables = bwd_table_bytes(M, nt, P, LINV);
  const int budget =
      bwd_budget(chunks * P, tables, LINV ? kBudgetLinv : kBudget);
  const int smem = budget + tables;
  cudaError_t err = cudaFuncSetAttribute(
      cov_tape_bwd_kernel<FUSED, LINV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  auto s = (cudaStream_t)stream;
  cov_tape_bwd_kernel<FUSED, LINV>
      <<<dim3(chunks, P), dim3(kTile, kThreads / kTile), smem, s>>>(
      (const int*)tslot, (const int*)ttype, (const int*)tlpos,
      (const int*)trpos, (const int*)tlen, (const float*)params,
      (const float*)ts, (const float*)mask, (const float*)kmat,
      (const float*)beta, (const float*)g, (double*)partial, M, N, masked,
      budget);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_tiles_kernel<<<P, 128, 0, s>>>((const double*)partial, (float*)out,
                                        chunks, 3 * M + 1);
  return (int)cudaGetLastError();
}

}  // namespace

// Tapes [P, M] int32 (slot, type, lpos, rpos) and lengths [P]; params
// [P, M, 3], ts and mask [N], kinv [P, N, N] lower-only, beta [P, N],
// g [P], all float32; partial scratch [P, chunks, 3M + 1] float64, chunks =
// min(n(n + 1) / 2, max(1, 8448 / P)) for n = N / 32 (ops/cov_vjp.py
// bwd_chunks); out [P, 3M + 1] float32. N must be a multiple of 32.
extern "C" int autogp_cov_tape_bwd(
    const void* tslot, const void* ttype, const void* tlpos,
    const void* trpos, const void* tlen, const void* params, const void* ts,
    const void* mask, const void* kinv, const void* beta, const void* g,
    void* partial, void* out, int P, int M, int N, void* stream) {
  if (M < 1 || M > kMaxSlots || N % kTile != 0 || P < 1)
    return (int)cudaErrorInvalidValue;
  return launch<true, false>(tslot, ttype, tlpos, trpos, tlen, params, ts,
                             mask, kinv, beta, g, partial, out, P, M, N, 1,
                             stream);
}

// The arguments of autogp_cov_tape_bwd, with V = L^-1 [P, N, N] (exact
// zeros above the diagonal) in place of K^-1.
extern "C" int autogp_cov_tape_bwd_linv(
    const void* tslot, const void* ttype, const void* tlpos,
    const void* trpos, const void* tlen, const void* params, const void* ts,
    const void* mask, const void* linv, const void* beta, const void* g,
    void* partial, void* out, int P, int M, int N, void* stream) {
  if (M < 1 || M > kMaxSlots || N % kTile != 0 || P < 1)
    return (int)cudaErrorInvalidValue;
  return launch<true, true>(tslot, ttype, tlpos, trpos, tlen, params, ts,
                            mask, linv, beta, g, partial, out, P, M, N, 1,
                            stream);
}

// The same tapes, params, ts and mask; kbar [P, N, N] float32, the
// cotangent of the assembled matrix, multiplied by mask_i mask_j when
// `masked`; partial scratch [P, chunks, 3M + 1] float64, chunks =
// min(n^2, max(1, 8448 / P)) for n = ceil(N / 32); out [P, 3M + 1]
// float32. Any N >= 1.
extern "C" int autogp_cov_tape_bwd_unfused(
    const void* tslot, const void* ttype, const void* tlpos,
    const void* trpos, const void* tlen, const void* params, const void* ts,
    const void* mask, const void* kbar, void* partial, void* out, int P,
    int M, int N, int masked, void* stream) {
  if (M < 1 || M > kMaxSlots || N < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  return launch<false, false>(tslot, ttype, tlpos, trpos, tlen, params, ts,
                              mask, kbar, nullptr, nullptr, partial, out, P,
                              M, N, masked, stream);
}
