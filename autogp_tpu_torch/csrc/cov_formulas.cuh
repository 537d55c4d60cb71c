// Leaf, operator and derivative formulas of the kernel-expression trees,
// shared by the covariance assembly (cov_assemble.cuh's tile body, which
// kernels 1 and 6 run) and its backward (cov_tape_bwd.cu, whose body
// kernels 5, 5b, 5c and 7 run).
//
// They are the guarded formulas of the reference (GP.jl:135-517;
// autogp_tpu/ops/cov_pallas.py:46-133, cov_pallas_vjp.py:56-255):
// GammaExponential's safe log, ChangePoint's sigmoid (tanh is never used)
// and a true division pi / p. Two operation orders are kept, one last bit
// apart, so that each kernel stays bitwise what its comparison needs:
//
// - `leaf_value` / `op_value`, used by the assembly kernels, follow the
//   plain PyTorch version (gp_math.eval_cov), whose values the LML is held
//   to;
// - `ref_leaf_value` / `ref_op_value`, used by the backward kernels' forward
//   sweep, follow the reference's backward kernels. Their derivative
//   formulas (`ref_leaf_grad`) recover exponents from the stored value,
//   except GammaExponential's and Periodic's, which recompute them, and
//   Periodic's argument is reduced in double first (`periodic_arg`): the
//   gradient is a sum of terms that cancel, and those recoveries and the
//   argument's float32 rounding put errors of 1e-5 to 2e-4 of the terms'
//   size into it on config 3's candidates.
//
// Build without --use_fast_math: expf/sinf/logf must stay accurate to about
// one ulp.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace autogp {

constexpr int kTile = 32;        // tile edge of every covariance kernel

// Depth. No kernel is sized by the heap's M = 2^D - 1 slots: each stages
// its block's tape (the active slots in post-order), with each position's
// parameters gathered through its slot ([len, 3], not the heap's [M, 3]),
// in dynamic shared memory sized by the batch's longest tape, and a heap
// of any depth runs. What remains is the longest tape a block can stage
// (each kernel's header and ops/cov.py give the number): a block has at
// most kSmemPerBlock bytes of shared memory on this card.
constexpr int kSmemPerBlock = 232448;  // 227 KB, H100 (opt-in maximum)

// Node-type codes: autogp_tpu_torch/config.py.
constexpr int CONSTANT = 1, LINEAR = 2, SQUARED_EXPONENTIAL = 3,
              GAMMA_EXPONENTIAL = 4, PERIODIC = 5, PLUS = 6, TIMES = 7,
              CHANGEPOINT = 8, WHITE_NOISE = 9;
constexpr float kCpScale = 1e-3f;  // CHANGEPOINT_SCALE
constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ bool is_op(int t) {
  return t >= PLUS && t <= CHANGEPOINT;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ---------------------------------------------------------------------------
// Assembly kernels: the plain version's operation order.
// ---------------------------------------------------------------------------

// Value of a leaf of type t with parameters p[0..2] at (t1, t2).
__device__ __forceinline__ float leaf_value(int t, const float* p, float t1,
                                            float t2) {
  const float dt = t1 - t2;
  const float adt = fabsf(dt);
  switch (t) {
    case CONSTANT:
      return p[0];
    case WHITE_NOISE:
      return (dt == 0.0f) ? p[0] : 0.0f;
    case LINEAR: {
      const float c = p[0];
      return p[1] + p[2] * (t1 - c) * (t2 - c);
    }
    case SQUARED_EXPONENTIAL: {
      const float l = p[0];
      return p[1] * expf(-0.5f * (dt * dt) / (l * l));
    }
    case GAMMA_EXPONENTIAL: {
      const float l = p[0], g = p[1];
      const float safe = fmaxf((adt == 0.0f) ? 1.0f : adt / l, 1e-30f);
      const float powg = (adt == 0.0f) ? 0.0f : expf(g * logf(safe));
      return p[2] * expf(-powg);
    }
    case PERIODIC: {
      const float l = p[0];
      const float freq = kPi / p[1];
      const float s = sinf(freq * adt);
      return p[2] * expf((-2.0f / (l * l)) * s * s);
    }
    default:
      return 0.0f;
  }
}

// Value of an operator of type t over its children's values.
__device__ __forceinline__ float op_value(int t, const float* p, float left,
                                          float right, float t1, float t2) {
  switch (t) {
    case PLUS:
      return left + right;
    case TIMES:
      return left * right;
    default: {  // CHANGEPOINT
      const float loc = p[0];
      // sigmoid(2 (loc - t) / scale), in the plain version's order: the
      // argument reaches ~2e3, so its rounding matters near loc.
      const float s1 = sigmoidf(2.0f * (loc - t1) / kCpScale);
      const float s2 = sigmoidf(2.0f * (loc - t2) / kCpScale);
      return s1 * left * s2 + (1.0f - s1) * right * (1.0f - s2);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward kernels: the reference backward's operation order.
// ---------------------------------------------------------------------------

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One matrix element's times, as the backward sweeps use them.
struct Elem {
  float t1, t2, dt, adt;
  __device__ __forceinline__ Elem(float a, float b)
      : t1(a), t2(b), dt(a - b), adt(fabsf(a - b)) {}
};

// Periodic's argument pi |t1 - t2| / per, reduced by a multiple of pi to
// [-pi/2, pi/2] in double: its sin^2 and sin(2 .) are the argument's. In
// float32 the product's rounding is relative, ~4e-6 rad at the 37 rad of a
// 12-step season over 144 points, and the period's gradient, a sum of
// terms in sin(2 .) that cancel, inherits it; reduced first, the float32
// argument is off by ~1e-7 rad whatever the period.
__device__ __forceinline__ float periodic_arg(float t1, float t2,
                                              float per) {
  const double pi = 3.14159265358979323846;
  const double th = pi * fabs((double)t1 - (double)t2) / (double)per;
  return (float)fma(-rint(th * (1.0 / pi)), pi, th);
}

__device__ __forceinline__ float ref_leaf_value(int t, const float* pr,
                                                const Elem& e) {
  switch (t) {
    case CONSTANT:
      return pr[0];
    case WHITE_NOISE:
      return (e.dt == 0.0f) ? pr[0] : 0.0f;
    case LINEAR: {
      const float c = pr[0];
      return pr[1] + pr[2] * ((e.t1 - c) * (e.t2 - c));
    }
    case SQUARED_EXPONENTIAL: {
      const float l = pr[0];
      return pr[1] * expf((-0.5f / (l * l)) * (e.dt * e.dt));
    }
    case GAMMA_EXPONENTIAL: {
      const float l = pr[0], ga = pr[1];
      const float safe = fmaxf((e.adt == 0.0f) ? 1.0f : e.adt / l, 1e-30f);
      const float powg = (e.adt == 0.0f) ? 0.0f : expf(ga * logf(safe));
      return pr[2] * expf(-powg);
    }
    case PERIODIC: {
      const float l = pr[0];
      const float sn = sinf(periodic_arg(e.t1, e.t2, pr[1]));
      return pr[2] * expf((-2.0f / (l * l)) * sn * sn);
    }
    default:
      return 0.0f;
  }
}

__device__ __forceinline__ float ref_op_value(int t, const float* pr,
                                              float vl, float vr,
                                              const Elem& e) {
  switch (t) {
    case PLUS:
      return vl + vr;
    case TIMES:
      return vl * vr;
    default: {  // CHANGEPOINT
      const float loc = pr[0];
      const float inv = 2.0f / kCpScale;
      const float s1 = sigmoidf((loc - e.t1) * inv);
      const float s2 = sigmoidf((loc - e.t2) * inv);
      return s1 * vl * s2 + (1.0f - s1) * vr * (1.0f - s2);
    }
  }
}

// Reverse step of an operator with adjoint a: its children's adjoints
// (al, ar) and, for a ChangePoint, the location's gradient term through
// acc(index, term). `base` = 3 * slot.
template <class Acc>
__device__ __forceinline__ void ref_op_adjoint(int t, const float* pr,
                                               float vl, float vr, double a,
                                               const Elem& e, int base,
                                               double& al, double& ar,
                                               Acc&& acc) {
  switch (t) {
    case PLUS:
      al = a;
      ar = a;
      break;
    case TIMES:
      al = a * (double)vr;
      ar = a * (double)vl;
      break;
    default: {  // CHANGEPOINT
      const float loc = pr[0];
      const float inv = 2.0f / kCpScale;
      const float s1 = sigmoidf((loc - e.t1) * inv);
      const float s2 = sigmoidf((loc - e.t2) * inv);
      const float ds1 = s1 * (1.0f - s1) * inv;
      const float ds2 = s2 * (1.0f - s2) * inv;
      const float dloc = ds1 * (s2 * vl - (1.0f - s2) * vr)
                         + ds2 * (s1 * vl - (1.0f - s1) * vr);
      acc(base, a * (double)dloc);
      al = a * (double)s1 * (double)s2;
      ar = a * (double)(1.0f - s1) * (double)(1.0f - s2);
      break;
    }
  }
}

// Gradient terms of a leaf with stored value v and adjoint a, through
// acc(index, term). GammaExponential and Periodic recompute their
// exponents; SquaredExponential's needs none.
template <class Acc>
__device__ __forceinline__ void ref_leaf_grad(int t, const float* pr, float v,
                                              double a, const Elem& e,
                                              int base, Acc&& acc) {
  const float t1 = e.t1, t2 = e.t2, dt = e.dt, adt = e.adt;
  switch (t) {
    case CONSTANT:
      acc(base, a);
      break;
    case WHITE_NOISE:
      acc(base, (dt == 0.0f) ? a : 0.0);
      break;
    case LINEAR: {
      const float c = pr[0], amp = pr[2];
      acc(base, a * (double)((-amp) * (t1 + t2 - 2.0f * c)));
      acc(base + 1, a);
      acc(base + 2, a * (double)((t1 - c) * (t2 - c)));
      break;
    }
    case SQUARED_EXPONENTIAL: {
      const float l = pr[0], amp = pr[1];
      acc(base, a * (double)(v * (dt * dt) / (l * l * l)));
      acc(base + 1, a * (double)(v / amp));
      break;
    }
    case GAMMA_EXPONENTIAL: {
      // The exponent u = (|dt| / l)^gamma recomputed, not recovered from
      // v as -log(v / amp): near the diagonal, where the cotangent is
      // largest, u is small and the recovery keeps only ~6e-8 / u of it.
      const float l = pr[0], ga = pr[1], amp = pr[2];
      const float safe = fmaxf((adt == 0.0f) ? 1.0f : adt / l, 1e-30f);
      const float logs = (adt == 0.0f) ? 0.0f : logf(safe);
      const float u = (adt == 0.0f) ? 0.0f : expf(ga * logs);
      acc(base, a * (double)(v * ga * u / l));
      acc(base + 1, a * (double)(v * (-u) * logs));
      acc(base + 2, a * (double)(v / amp));
      break;
    }
    case PERIODIC: {
      // sin^2 recomputed from the reduced argument, for the same reason.
      const float l = pr[0], per = pr[1], amp = pr[2];
      float sn, cs;
      sincosf(periodic_arg(t1, t2, per), &sn, &cs);
      const float sn2 = sn * sn;
      const float sncs = sn * cs;
      acc(base, a * (double)(v * (4.0f * sn2) / (l * l * l)));
      acc(base + 1, a * (double)(v * (4.0f / (l * l)) * sncs
                                 * (kPi * adt / (per * per))));
      acc(base + 2, a * (double)(v / amp));
      break;
    }
    default:
      break;
  }
}

}  // namespace autogp
