// Backward of the tape-driven covariance assembly, fused with the MVN
// cotangent, over the lower triangle: the LML gradient with respect to the
// transformed node parameters [M, 3] and the noise of each particle.
//
// Replaces: autogp_tpu/ops/cov_pallas_vjp.py, _bwd_kernel_tape in its
// fused symmetric mode (fused=True, sym=True), launched there by
// _cov_grads_tape under lml_tape_fused's backward.
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
// 313-523): GammaExponential and Periodic recover their exponent from the
// stored value with a clamped log, ChangePoint is a sigmoid, and pi / p is
// a true division.
//
// What bounds it on this card: FP32 arithmetic and transcendentals, not
// memory. Each lower element reads 4 bytes of Kinv and runs two sweeps of
// the tape (~5-15 instructions, each a few exp/log/sin plus a warp
// reduction per gradient term); at [64, 1024, 1024] that is 33.6 M
// elements, ~134 MB read.
//
// What the design does about it: one block per (particle, lower 32 x 32
// tile) -- tiles wholly above the diagonal are never launched -- and one
// thread per element column, RY rows of threads each stepping over 32 / RY
// rows. The tape and parameters sit in shared memory, so every instruction
// is a broadcast read and its accumulator index slot * 3 + k is uniform
// across the block. Values (float) and adjoints (double) live in shared
// memory laid out [tape position][thread] (no bank conflicts, no
// dynamically indexed per-thread arrays in local memory): M * 12 * 256 B
// = 93 KB at M = 31, above the 48 KB default, so the launch opts in. Each
// gradient term is summed over the warp by xor shuffles and added by lane 0
// into the warp's row of a double accumulator, warps are summed in order
// into per-tile partials [P, n_tiles, 3M + 1], and a second small pass sums
// the tiles of each particle in order. No atomics: gradients repeat bit
// for bit from run to run.
//
// Precision: the gradient is a sum of ~5e5 terms per particle at N = 1024
// that cancel heavily when the gram is ill-conditioned (beta beta^T and
// K^-1 are both large where their difference is not). So the cotangent is
// formed in double from the float32 inputs (the product of two floats is
// exact in double), adjoints are carried in double, and every sum is in
// double; only the tree's values and derivative factors are float32, each
// with its own relative rounding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;
constexpr int kMaxSlots = 255;
constexpr int kSmemBudget = 140 * 1024;  // value + adjoint stacks

// Node-type codes: autogp_tpu_torch/config.py.
constexpr int CONSTANT = 1, LINEAR = 2, SQUARED_EXPONENTIAL = 3,
              GAMMA_EXPONENTIAL = 4, PERIODIC = 5, PLUS = 6, TIMES = 7,
              CHANGEPOINT = 8, WHITE_NOISE = 9;
constexpr float kCpScale = 1e-3f;  // CHANGEPOINT_SCALE
constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Threads of a block are (32 columns) x RY rows; the thread count T and
// the warp count come from blockDim.
__global__ void cov_tape_bwd_kernel(
    const int* __restrict__ tslot, const int* __restrict__ ttype,
    const int* __restrict__ tlpos, const int* __restrict__ trpos,
    const int* __restrict__ tlen, const float* __restrict__ params,
    const float* __restrict__ ts, const float* __restrict__ mask,
    const float* __restrict__ kinv, const float* __restrict__ beta,
    const float* __restrict__ gscale, double* __restrict__ partial, int M,
    int N) {
  extern __shared__ double smem_d[];
  const int T = blockDim.x * blockDim.y;
  const int nwarps = T / 32;
  const int n_acc = 3 * M + 1;
  double* wacc = smem_d;                                  // [nwarps][n_acc]
  double* adj = wacc + nwarps * n_acc;                    // [M][T]
  float* val = reinterpret_cast<float*>(adj + M * T);     // [M][T]
  float* s_par = val + M * T;                             // [3M]
  int* s_slot = reinterpret_cast<int*>(s_par + 3 * M);    // [M] each
  int* s_type = s_slot + M;
  int* s_l = s_type + M;
  int* s_r = s_l + M;

  const int p = blockIdx.y;
  const int lin = blockIdx.x;
  // Lower tile (ti, tj <= ti) of linear index lin = ti (ti + 1) / 2 + tj.
  int ti = (int)((sqrtf(8.0f * (float)lin + 1.0f) - 1.0f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= lin) ++ti;
  while (ti * (ti + 1) / 2 > lin) --ti;
  const int tj = lin - ti * (ti + 1) / 2;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx;
  const int warp = tid / 32, lane = tid % 32;
  for (int k = tid; k < M; k += T) {
    s_slot[k] = tslot[(long long)p * M + k];
    s_type[k] = ttype[(long long)p * M + k];
    s_l[k] = tlpos[(long long)p * M + k];
    s_r[k] = trpos[(long long)p * M + k];
  }
  for (int k = tid; k < 3 * M; k += T)
    s_par[k] = params[(long long)p * 3 * M + k];
  for (int k = tid; k < nwarps * n_acc; k += T) wacc[k] = 0.0;
  __syncthreads();

  const int len = tlen[p];
  const double g = gscale[p];
  const float* kp = kinv + (long long)p * N * N;
  const float* bp = beta + (long long)p * N;
  const bool diag_tile = (ti == tj);
  const int j = tj * kTile + tx;
  const float t2 = ts[j];
  const float mj = mask[j];
  const double bj = bp[j];
  double* my_acc = wacc + warp * n_acc;

  // Adds one gradient term (uniform index across the block) to the warp's
  // accumulator row.
#define ACC(idx, term)                  \
  do {                                  \
    const double s_ = warp_sum(term);   \
    if (lane == 0) my_acc[idx] += s_;   \
  } while (0)

  for (int rr = ty; rr < kTile; rr += blockDim.y) {
    const int i = ti * kTile + rr;
    const float t1 = ts[i];
    const float dt = t1 - t2;
    const float adt = fabsf(dt);

    // Cotangent of this element, in the reference's operation order.
    const double kij = (i >= j) ? kp[(long long)i * N + j] : 0.0f;
    double kb = (0.5 * g) * ((double)bp[i] * bj - kij);
    kb = kb * (double)(mask[i] * mj);
    const double w = (i > j) ? 2.0 : ((i == j) ? 1.0 : 0.0);
    kb = kb * w;
    if (diag_tile) ACC(n_acc - 1, (i == j) ? kb : 0.0);

    // Forward sweep: the value of every tape position.
    for (int q = 0; q < len; ++q) {
      const float* pr = s_par + 3 * s_slot[q];
      float v = 0.0f;
      switch (s_type[q]) {
        case CONSTANT:
          v = pr[0];
          break;
        case WHITE_NOISE:
          v = (dt == 0.0f) ? pr[0] : 0.0f;
          break;
        case LINEAR: {
          const float c = pr[0];
          v = pr[1] + pr[2] * ((t1 - c) * (t2 - c));
          break;
        }
        case SQUARED_EXPONENTIAL: {
          const float l = pr[0];
          v = pr[1] * expf((-0.5f / (l * l)) * (dt * dt));
          break;
        }
        case GAMMA_EXPONENTIAL: {
          const float l = pr[0], ga = pr[1];
          const float safe = fmaxf((adt == 0.0f) ? 1.0f : adt / l, 1e-30f);
          const float powg = (adt == 0.0f) ? 0.0f : expf(ga * logf(safe));
          v = pr[2] * expf(-powg);
          break;
        }
        case PERIODIC: {
          const float l = pr[0];
          const float freq = kPi / pr[1];
          const float sn = sinf(freq * adt);
          v = pr[2] * expf((-2.0f / (l * l)) * sn * sn);
          break;
        }
        case PLUS:
          v = val[s_l[q] * T + tid] + val[s_r[q] * T + tid];
          break;
        case TIMES:
          v = val[s_l[q] * T + tid] * val[s_r[q] * T + tid];
          break;
        case CHANGEPOINT: {
          const float loc = pr[0];
          const float inv = 2.0f / kCpScale;
          const float s1 = sigmoidf((loc - t1) * inv);
          const float s2 = sigmoidf((loc - t2) * inv);
          v = s1 * val[s_l[q] * T + tid] * s2
              + (1.0f - s1) * val[s_r[q] * T + tid] * (1.0f - s2);
          break;
        }
        default:
          break;
      }
      val[q * T + tid] = v;
    }

    // Reverse sweep: adjoints, and the gradient terms.
    if (len > 0) adj[(len - 1) * T + tid] = kb;
    for (int k = 0; k < len; ++k) {
      const int q = len - 1 - k;
      const int s = s_slot[q];
      const float* pr = s_par + 3 * s;
      const double a = adj[q * T + tid];
      const int base = 3 * s;
      switch (s_type[q]) {
        case PLUS:
          adj[s_l[q] * T + tid] = a;
          adj[s_r[q] * T + tid] = a;
          break;
        case TIMES:
          adj[s_l[q] * T + tid] = a * (double)val[s_r[q] * T + tid];
          adj[s_r[q] * T + tid] = a * (double)val[s_l[q] * T + tid];
          break;
        case CHANGEPOINT: {
          const float loc = pr[0];
          const float inv = 2.0f / kCpScale;
          const float s1 = sigmoidf((loc - t1) * inv);
          const float s2 = sigmoidf((loc - t2) * inv);
          const float vl = val[s_l[q] * T + tid];
          const float vr = val[s_r[q] * T + tid];
          const float ds1 = s1 * (1.0f - s1) * inv;
          const float ds2 = s2 * (1.0f - s2) * inv;
          const float dloc = ds1 * (s2 * vl - (1.0f - s2) * vr)
                             + ds2 * (s1 * vl - (1.0f - s1) * vr);
          ACC(base, a * (double)dloc);
          adj[s_l[q] * T + tid] = a * (double)s1 * (double)s2;
          adj[s_r[q] * T + tid] =
              a * (double)(1.0f - s1) * (double)(1.0f - s2);
          break;
        }
        case CONSTANT:
          ACC(base, a);
          break;
        case WHITE_NOISE:
          ACC(base, (dt == 0.0f) ? a : 0.0);
          break;
        case LINEAR: {
          const float c = pr[0], amp = pr[2];
          ACC(base, a * (double)((-amp) * (t1 + t2 - 2.0f * c)));
          ACC(base + 1, a);
          ACC(base + 2, a * (double)((t1 - c) * (t2 - c)));
          break;
        }
        case SQUARED_EXPONENTIAL: {
          const float l = pr[0], amp = pr[1];
          const float v = val[q * T + tid];
          ACC(base, a * (double)(v * (dt * dt) / (l * l * l)));
          ACC(base + 1, a * (double)(v / amp));
          break;
        }
        case GAMMA_EXPONENTIAL: {
          const float l = pr[0], ga = pr[1], amp = pr[2];
          const float v = val[q * T + tid];
          const float e_safe = fmaxf(v / amp, 1e-38f);
          const float u = (adt == 0.0f) ? 0.0f : -logf(e_safe);
          const float safe = fmaxf((adt == 0.0f) ? 1.0f : adt / l, 1e-30f);
          const float logs = (adt == 0.0f) ? 0.0f : logf(safe);
          ACC(base, a * (double)(v * ga * u / l));
          ACC(base + 1, a * (double)(v * (-u) * logs));
          ACC(base + 2, a * (double)(v / amp));
          break;
        }
        case PERIODIC: {
          const float l = pr[0], per = pr[1], amp = pr[2];
          const float v = val[q * T + tid];
          const float e_safe = fmaxf(v / amp, 1e-38f);
          const float sn2 = (-0.5f * l * l) * logf(e_safe);
          const float freq = kPi / per;
          const float sncs = 0.5f * sinf(2.0f * freq * adt);
          ACC(base, a * (double)(v * (4.0f * sn2) / (l * l * l)));
          ACC(base + 1, a * (double)(v * (4.0f / (l * l)) * sncs
                                     * (kPi * adt / (per * per))));
          ACC(base + 2, a * (double)(v / amp));
          break;
        }
        default:
          break;
      }
    }
  }
#undef ACC
  __syncthreads();

  // Warps in order into this tile's partial.
  double* out = partial + ((long long)p * gridDim.x + lin) * n_acc;
  for (int k = tid; k < n_acc; k += T) {
    double s = 0.0;
    for (int w = 0; w < nwarps; ++w) s += wacc[w * n_acc + k];
    out[k] = s;
  }
}

// out[p, k] = sum over tiles of partial[p, tile, k], tiles in order.
__global__ void cov_tape_bwd_reduce(const double* __restrict__ partial,
                                    float* __restrict__ out, int n_tiles,
                                    int n_acc) {
  const int p = blockIdx.x;
  const double* pp = partial + (long long)p * n_tiles * n_acc;
  for (int k = threadIdx.x; k < n_acc; k += blockDim.x) {
    double s = 0.0;
    for (int t = 0; t < n_tiles; ++t) s += pp[(long long)t * n_acc + k];
    out[(long long)p * n_acc + k] = (float)s;
  }
}

}  // namespace

// Shared memory of one block with RY thread rows, in bytes.
static int bwd_smem_bytes(int M, int ry) {
  const int T = 32 * ry;
  const int n_acc = 3 * M + 1;
  return (ry * n_acc) * 8 + M * T * 12 + 3 * M * 4 + 4 * M * 4;
}

// Tapes [P, M] int32 (slot, type, lpos, rpos) and lengths [P]; params
// [P, M, 3], ts and mask [N], kinv [P, N, N] lower-only, beta [P, N],
// g [P], all float32; partial scratch [P, n_lower_tiles, 3M + 1] float64;
// out [P, 3M + 1] float32. N must be a multiple of 32.
extern "C" int autogp_cov_tape_bwd(
    const void* tslot, const void* ttype, const void* tlpos,
    const void* trpos, const void* tlen, const void* params, const void* ts,
    const void* mask, const void* kinv, const void* beta, const void* g,
    void* partial, void* out, int P, int M, int N, void* stream) {
  if (M < 1 || M > kMaxSlots || N % kTile != 0 || P < 1)
    return (int)cudaErrorInvalidValue;
  int ry = 8;
  while (ry > 1 && 12 * M * 32 * ry > kSmemBudget) ry /= 2;
  const int smem = bwd_smem_bytes(M, ry);
  cudaError_t err = cudaFuncSetAttribute(
      cov_tape_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int nt = N / kTile;
  const int n_lower = nt * (nt + 1) / 2;
  auto s = (cudaStream_t)stream;
  cov_tape_bwd_kernel<<<dim3(n_lower, P), dim3(32, ry), smem, s>>>(
      (const int*)tslot, (const int*)ttype, (const int*)tlpos,
      (const int*)trpos, (const int*)tlen, (const float*)params,
      (const float*)ts, (const float*)mask, (const float*)kinv,
      (const float*)beta, (const float*)g, (double*)partial, M, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cov_tape_bwd_reduce<<<P, 128, 0, s>>>((const double*)partial, (float*)out,
                                        n_lower, 3 * M + 1);
  return (int)cudaGetLastError();
}
