// Tape-driven covariance assembly in float64: kernel 1's contract on
// double tensors.
//
// Replaces: autogp_tpu/ops/cov_pallas.py, _cov_kernel_tape_1p, for the
// grams that float32 cannot hold. The JAX package assembles a float64 gram
// with its XLA evaluator (gp_math.eval_cov); on the card the float32 entry
// (cov_tape.cu) serves every fit, and this entry serves the decomposition's
// fragment models: each is one fragment of a fitted kernel with noise
// 1e-10 (plus the model jitter 1e-5), often of low rank, and a float32
// gram's rounding (6e-8 of its largest entry) is then far larger than the
// noise: their float32 LMLs were mostly non-finite on the card where
// float64 gives a finite value (chip_smoke.py's decompose phase).
//
// What it computes: for particle p, out[p, i, j] = k_p(t_row[i], t_col[j])
// by the post-order tape of ops/cov.py build_tape, with gram mode's noise
// on the diagonal and identity rows and columns where the mask is 0, 0 for
// masked entries outside gram mode, and zeros above the diagonal with
// lower_only: cov_tape.cu's contract. The formulas are the plain version's
// (gp_math.eval_cov in float64, operation for operation: its guards of a
// zero lengthscale or period, GammaExponential's clamped log, ChangePoint's
// sigmoid, pi / p as a true division), each in double.
//
// What bounds it on this card: float64 arithmetic (67 TFLOP/s of FP32 but
// 34 of FP64 on the H100 SXM) and double exp / log / sin, which have no
// special-function unit: each is a software sequence of tens of FP64
// instructions. The design is the simple one: one block per (particle,
// 32 x 32 tile), threads (32, 8), each thread four rows of one column, the
// particle's tape and parameters staged in shared memory, the value stack
// in local memory. A tile whose elements need no tree (above the diagonal
// with lower_only, or all masked) runs no tape.
//
// What bounds it in depth: the tape. A block stages the batch's longest
// tape, L = max_len positions, each its type and its three parameters
// gathered through its slot (28 bytes: no [M, 3] table), in dynamic
// shared memory; the stack (local memory, indexed by its height) holds
// kLocalDepth values, as tall as any heap a C int can count. The longest
// tape a block stages is 8301 positions (28 bytes each in kSmemPerBlock);
// a longer one is refused before launch.

#include "cov_formulas.cuh"

namespace {

using namespace autogp;

constexpr double kPiD = 3.14159265358979323846;
constexpr double kCpScaleD = 1e-3;   // CHANGEPOINT_SCALE

__device__ double leaf_value_d(int t, const double* p, double t1,
                               double t2) {
  const double dt = t1 - t2;
  const double adt = fabs(dt);
  const double l = p[0] == 0.0 ? 1.0 : p[0];    // lengthscales
  switch (t) {
    case CONSTANT:
      return p[0];
    case WHITE_NOISE:
      return dt == 0.0 ? p[0] : 0.0;
    case LINEAR:
      return p[1] + p[2] * (t1 - p[0]) * (t2 - p[0]);
    case SQUARED_EXPONENTIAL:
      return p[1] * exp(-0.5 * (dt * dt) / (l * l));
    case GAMMA_EXPONENTIAL: {
      const double ratio = fmax(adt == 0.0 ? 1.0 : adt / l, 1e-30);
      const double powg = adt == 0.0 ? 0.0 : exp(p[1] * log(ratio));
      return p[2] * exp(-powg);
    }
    case PERIODIC: {
      const double per = p[1] == 0.0 ? 1.0 : p[1];
      const double s = sin((kPiD / per) * adt);
      return p[2] * exp((-2.0 / (l * l)) * s * s);
    }
    default:
      return 0.0;
  }
}

__device__ double sigmoid_d(double x) { return 1.0 / (1.0 + exp(-x)); }

__device__ double op_value_d(int t, const double* p, double left,
                             double right, double t1, double t2) {
  switch (t) {
    case PLUS:
      return left + right;
    case TIMES:
      return left * right;
    default: {  // CHANGEPOINT
      const double s1 = sigmoid_d(2.0 * (p[0] - t1) / kCpScaleD);
      const double s2 = sigmoid_d(2.0 * (p[0] - t2) / kCpScaleD);
      return s1 * left * s2 + (1.0 - s1) * right * (1.0 - s2);
    }
  }
}

constexpr int kLocalDepth = 32;   // the value stack (local memory)

// The tree at (t1, t2) by the post-order tape, its parameters by tape
// position: leaves push, operators pop two and push one. An operator
// with no children (the heap's last level) reads what is there.
__device__ double eval_tape_d(const int* s_type, int len,
                              const double* s_par, double t1, double t2) {
  double st[kLocalDepth];
  int sp = 0;
  for (int q = 0; q < len; ++q) {
    const int t = s_type[q];
    const double* p = s_par + 3 * q;
    if (is_op(t)) {
      const int r = max(sp - 1, 0), l = max(sp - 2, 0);
      st[l] = op_value_d(t, p, st[l], st[r], t1, t2);
      sp = l + 1;
    } else if (sp < kLocalDepth) {
      st[sp++] = leaf_value_d(t, p, t1, t2);
    }
  }
  return sp > 0 ? st[sp - 1] : 0.0;
}

__global__ void __launch_bounds__(kTile * 8)
cov_tape_f64_kernel(const int* __restrict__ tslot,
                    const int* __restrict__ ttype,
                    const int* __restrict__ tlen,
                    const double* __restrict__ params,
                    const double* __restrict__ noise,
                    const double* __restrict__ t_row,
                    const double* __restrict__ t_col,
                    const double* __restrict__ m_row,
                    const double* __restrict__ m_col,
                    double* __restrict__ out, int M, int L, int N1,
                    int N2, int gram, int lower_only) {
  extern __shared__ double smem_d[];
  double* s_par = smem_d;                                 // [L, 3]
  int* s_type = reinterpret_cast<int*>(s_par + 3 * L);    // [L]
  const int p = blockIdx.z;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int i0 = blockIdx.y * kTile, j = blockIdx.x * kTile + threadIdx.x;
  const double* pp = params + (size_t)p * 3 * M;
  for (int k = tid; k < L; k += kTile * 8) {
    const int s = tslot[(size_t)p * M + k];
    s_type[k] = ttype[(size_t)p * M + k];
    s_par[3 * k] = pp[3 * s];
    s_par[3 * k + 1] = pp[3 * s + 1];
    s_par[3 * k + 2] = pp[3 * s + 2];
  }
  __syncthreads();
  if (j >= N2) return;
  const int len = tlen[p];
  double* outp = out + (size_t)p * N1 * N2;
  for (int r = threadIdx.y; r < kTile; r += 8) {
    const int i = i0 + r;
    if (i >= N1) break;
    double v;
    if (lower_only && j > i) {
      v = 0.0;
    } else if (m_row[i] * m_col[j] > 0.0) {
      v = eval_tape_d(s_type, len, s_par, t_row[i], t_col[j]);
      if (gram && i == j) v = v + noise[p];
    } else {
      v = (gram && i == j) ? 1.0 : 0.0;
    }
    outp[(size_t)i * N2 + j] = v;
  }
}

}  // namespace

// cov_tape.cu's autogp_cov_tape with params [P, M, 3], noise [P], t_row,
// m_row [N1], t_col, m_col [N2] and out [P, N1, N2] in float64; max_len:
// the batch's longest tape (ops/cov.py tape_maxima), which sizes the
// staging.
extern "C" int autogp_cov_tape_f64(const void* tslot, const void* ttype,
                                   const void* tlen, const void* params,
                                   const void* noise, const void* t_row,
                                   const void* t_col, const void* m_row,
                                   const void* m_col, void* out, int P,
                                   int M, int N1, int N2, int gram,
                                   int lower_only, int max_len,
                                   void* stream) {
  const size_t smem = 28 * (size_t)max_len;
  if (M < 1 || max_len < 1 || max_len > M || smem > (size_t)kSmemPerBlock)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cov_tape_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 block(kTile, 8);
  dim3 grid((N2 + kTile - 1) / kTile, (N1 + kTile - 1) / kTile, P);
  cov_tape_f64_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int*)tslot, (const int*)ttype, (const int*)tlen,
      (const double*)params, (const double*)noise, (const double*)t_row,
      (const double*)t_col, (const double*)m_row, (const double*)m_col,
      (double*)out, M, max_len, N1, N2, gram, lower_only);
  return (int)cudaGetLastError();
}
