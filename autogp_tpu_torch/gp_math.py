"""GP math over tensor-encoded kernel trees, batched over particles.

Port of autogp_tpu/gp_math.py. The kernel expression tree lives in a
fixed-shape binary heap (node_type [P, M], params [P, M, 3] transformed,
M = 2^D - 1); every function here takes the particle axis first instead of
being vmapped per particle.

`eval_cov` is the plain version of the covariance-assembly kernel
(ops/cov.py): it walks the heap in static post-order with a static value
stack, evaluating every leaf formula at every slot as a masked sum, exactly
like the JAX evaluator (autogp_tpu/gp_math.py:110-196). The value-only
MVN log density and the posterior marginals route their covariance blocks
and factorizations through ops/cov.py and ops/chol.py, so on a CUDA tensor
they run the hand-written kernels.

The gradient path's plain helpers are here too: `kinv_from_linv` and the
closed-form cotangent of the MVN log density (autogp_tpu/gp_math.py:
402-473), which the plain versions of the kinv and tape-backward kernels
use.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from autogp_tpu_torch import config as C

LOG2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Static heap helpers (autogp_tpu/gp_math.py:60-104)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def postorder(depth_cap: int) -> Tuple[int, ...]:
    """Post-order visit sequence of the full heap with 2^D - 1 slots."""
    M = (1 << depth_cap) - 1

    def rec(i):
        if i >= M:
            return []
        return rec(2 * i + 1) + rec(2 * i + 2) + [i]

    return tuple(rec(0))


@functools.lru_cache(maxsize=None)
def slot_depths(depth_cap: int) -> np.ndarray:
    """1-based depth of each slot (GP.jl:1141)."""
    M = (1 << depth_cap) - 1
    return np.array([int(np.floor(np.log2(i + 1))) + 1 for i in range(M)],
                    dtype=np.int64)


@functools.lru_cache(maxsize=None)
def ancestor_table(depth_cap: int) -> np.ndarray:
    """[M, D] table: ancestors of slot i (including i), padded with -1."""
    M = (1 << depth_cap) - 1
    out = -np.ones((M, depth_cap), dtype=np.int64)
    for i in range(M):
        j, k = i, 0
        while True:
            out[i, k] = j
            if j == 0:
                break
            j = (j - 1) // 2
            k += 1
    return out


def is_leaf_code(t):
    """True for primitive-kernel codes (1..5 and 9)."""
    return ((t >= C.CONSTANT) & (t <= C.PERIODIC)) | (t == C.WHITE_NOISE)


def is_op_code(t):
    return (t >= C.PLUS) & (t <= C.CHANGEPOINT)


# ---------------------------------------------------------------------------
# Leaf and operator formulas (GP.jl:135-503; autogp_tpu/gp_math.py:110-169)
# ---------------------------------------------------------------------------

def _rdiv(c: float, x):
    return torch.full_like(x, c) / x


def _leaf_cov(t, p, t1, t2):
    """Covariance blocks [P, N1, N2] for one heap slot of every particle.

    t: [P] node types; p: [P, 3] transformed params; t1: [1, N1, 1];
    t2: [1, 1, N2]. A masked sum of all six formulas, with the same guards
    as the JAX evaluator (slots of other types feed zeros into formulas
    they do not select)."""
    p0 = p[:, 0, None, None]
    p1 = p[:, 1, None, None]
    p2 = p[:, 2, None, None]
    tt = t[:, None, None]
    dt = t1 - t2
    adt = torch.abs(dt)
    dt2 = dt * dt
    zero = torch.zeros((), dtype=dt.dtype, device=dt.device)
    one = torch.ones((), dtype=dt.dtype, device=dt.device)
    p0s = torch.where(p0 == 0, one, p0)      # lengthscales
    p1s = torch.where(p1 == 0, one, p1)      # period

    k_const = p0 * torch.ones_like(dt)
    k_wn = torch.where(dt == 0, p0, zero)
    k_lin = p1 + p2 * (t1 - p0) * (t2 - p0)
    k_se = p1 * torch.exp(-0.5 * dt2 / (p0s * p0s))
    # GammaExponential: the double-where guard keeps |dt|^gamma finite at
    # dt = 0 (exp(-(0/l)^g) == 1).
    ratio = torch.clamp(torch.where(adt == 0, one, adt / p0s), min=1e-30)
    powg = torch.where(adt == 0, zero, torch.exp(p1 * torch.log(ratio)))
    k_ge = p2 * torch.exp(-powg)
    # c / x as a true division (a Python scalar over a tensor would be
    # computed as c * (1 / x), rounded twice): the periodic argument
    # reaches ~1e2 rad for short periods, where one ulp of freq shows.
    freq = _rdiv(math.pi, p1s)
    s = torch.sin(freq * adt)
    k_per = p2 * torch.exp(_rdiv(-2.0, p0s * p0s) * s * s)

    return (torch.where(tt == C.CONSTANT, k_const, zero)
            + torch.where(tt == C.WHITE_NOISE, k_wn, zero)
            + torch.where(tt == C.LINEAR, k_lin, zero)
            + torch.where(tt == C.SQUARED_EXPONENTIAL, k_se, zero)
            + torch.where(tt == C.GAMMA_EXPONENTIAL, k_ge, zero)
            + torch.where(tt == C.PERIODIC, k_per, zero))


def sigma_cp(x, location, scale):
    """.5*(1 + tanh((location-x)/scale)) (GP.jl:481) in the sigmoid form,
    which stays finite for large |x| (tanh is never used)."""
    return torch.sigmoid(2.0 * (location - x) / scale)


def _combine(t, p, left, right, t1, t2):
    """Operator combination for slot types t [P] (GP.jl:371-503)."""
    tt = t[:, None, None]
    loc = p[:, 0, None, None]
    zero = torch.zeros((), dtype=left.dtype, device=left.device)
    k_plus = left + right
    k_times = left * right
    s1 = sigma_cp(t1, loc, C.CHANGEPOINT_SCALE)
    s2 = sigma_cp(t2, loc, C.CHANGEPOINT_SCALE)
    k_cp = s1 * left * s2 + (1.0 - s1) * right * (1.0 - s2)
    return (torch.where(tt == C.PLUS, k_plus, zero)
            + torch.where(tt == C.TIMES, k_times, zero)
            + torch.where(tt == C.CHANGEPOINT, k_cp, zero))


def eval_cov(node_type, params, ts1, ts2, depth_cap: int):
    """Covariance matrices [P, N1, N2] of the encoded trees on ts1 x ts2.

    node_type [P, M]; params [P, M, 3] already transformed to constrained
    space (model.transform_params); ts1 [N1]; ts2 [N2]."""
    M = (1 << depth_cap) - 1
    t1 = ts1[None, :, None]
    t2 = ts2[None, None, :]
    bottom = M // 2  # slots >= bottom are at the deepest level: leaves only.
    stack = []
    for s in postorder(depth_cap):
        t = node_type[:, s]
        p = params[:, s]
        if s >= bottom:
            val = _leaf_cov(t, p, t1, t2)
        else:
            right = stack.pop()
            left = stack.pop()
            leaf_val = _leaf_cov(t, p, t1, t2)
            op_val = _combine(t, p, left, right, t1, t2)
            val = torch.where(is_op_code(t)[:, None, None], op_val, leaf_val)
        stack.append(val)
    assert len(stack) == 1
    return stack[0]


# ---------------------------------------------------------------------------
# Masked multivariate-normal log density (value only)
# ---------------------------------------------------------------------------

def masked_gram(K, mask):
    """Replace masked-out rows/cols of K [P, N, N] with the identity block
    (autogp_tpu/gp_math.py:210-218)."""
    m2 = mask[:, None] * mask[None, :]
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return torch.where(m2 > 0, K, eye)


def mvn_logpdf_masked(K, x, mask):
    """log N(x_active; 0, K_active) per particle, value only.

    K: [P, N, N] padded-identity gram (noise included; only its lower
    triangle is read); x: [N] with zeros at padding; mask: [N] {0,1}.
    Same value as the primal of autogp_tpu.gp_math.mvn_logpdf_masked_cvjp
    (:337-367): the blocked factor returns only diag(L) and alpha. A
    failed factorization gives NaN, never an exception."""
    from autogp_tpu_torch.ops import chol
    P, N, _ = K.shape
    d, alpha = chol.chol_solve_diag(K, (x * mask).expand(P, N))
    return mvn_logpdf_from_factor(d, alpha, mask)


def mvn_logpdf_from_factor(d, alpha, mask):
    """[P] masked MVN log densities from diag(L) [P, N] and alpha = L^-1 x
    [P, N]; every LML route (value, gradient, noise gradient) ends here,
    so their values agree bit for bit on the same factor."""
    n = torch.sum(mask)
    logdet = 2.0 * torch.sum(torch.log(d) * mask, dim=-1)
    return -0.5 * (n * LOG2PI + logdet + torch.sum(alpha * alpha, dim=-1))


def use_blocked_inv(N: int) -> bool:
    """The noise gradient's closed form applies: N a power of two >= 64
    (autogp_tpu/gp_math.py:370-371); smaller buckets use autograd."""
    return N >= 64 and (N & (N - 1)) == 0


def kinv_from_linv(Linv):
    """Lower-only K^-1 = Linv^T Linv from a lower-triangular Linv
    [P, N, N] (autogp_tpu/gp_math.py:402-436 with lower_only=True): block
    (bi, bj <= bi) of 128 x 128 (the Cholesky driver's panels) contracts
    only rows >= bi, and the strictly-upper blocks are 0, which the
    symmetric tape backward never reads. One block (N <= 128) or a ragged
    N gives the dense product."""
    block = 128
    P, N, _ = Linv.shape
    if N % block != 0 or N == block:
        return torch.matmul(Linv.mT, Linv)
    out = torch.zeros_like(Linv)
    for i in range(N // block):
        r0 = i * block
        R = Linv[:, r0:, :]
        out[:, r0:r0 + block, :r0 + block] = torch.matmul(
            R[:, :, r0:r0 + block].mT, R[:, :, :r0 + block])
    return out


def mvn_logpdf_cotangent(beta, Kinv, mask, g):
    """Cotangent of the masked MVN log density with respect to its gram:
    0.5 g (beta beta^T - K^-1) * m m^T (autogp_tpu/gp_math.py:452-473).
    beta [P, N], Kinv [P, N, N] symmetric, mask [N], g [P]."""
    m2 = mask[:, None] * mask[None, :]
    return ((0.5 * g)[:, None, None]
            * (beta[:, :, None] * beta[:, None, :] - Kinv) * m2)


# ---------------------------------------------------------------------------
# Posterior predictive marginals (GP.jl:731-758; gp_math.py:541-583)
# ---------------------------------------------------------------------------

def train_cholesky_masked(node_type, params, noise, ts, xs, mask,
                          depth_cap: int):
    """Training-block factor (L [P, N, N], alpha [P, N]) of the
    joint-Cholesky posterior: L = chol(masked_gram(K(ts, ts) + noise I)),
    alpha = L^-1 (xs * mask). `noise` is [P]."""
    from autogp_tpu_torch.ops import chol, cov
    P, N = node_type.shape[0], ts.shape[0]
    Km = cov.cov_tape(node_type, params, noise, ts, ts, mask, mask,
                      depth_cap, gram=True, lower_only=True)
    return chol.chol_solve(Km, (xs * mask).expand(P, N))


def posterior_marginals_from_factor(node_type, params, L, alpha, mask, ts,
                                    ts_pred, noise_pred, depth_cap: int):
    """Marginal posterior (mu, std), each [P, p], at ts_pred from a train
    factor: with V = L^-1 (K(ts, ts_pred) * mask), mu = V^T alpha and
    var = diag K(ts_pred, ts_pred) + noise_pred - colsum(V^2), clipped at
    0 (the trailing-block downdate of the joint factorization, never the
    explicit Schur complement). `noise_pred` is [P]."""
    from autogp_tpu_torch.ops import cov
    P, p = node_type.shape[0], ts_pred.shape[0]
    ones = torch.ones_like(ts_pred)
    zero = torch.zeros(P, dtype=ts.dtype, device=ts.device)
    Kpt = cov.cov_tape(node_type, params, zero, ts_pred, ts, ones, mask,
                       depth_cap, gram=False, lower_only=False)
    V = torch.linalg.solve_triangular(L, Kpt.mT, upper=False)
    mu = torch.matmul(V.mT, alpha[..., None])[..., 0]
    Kpp = cov.cov_tape(node_type, params, zero, ts_pred, ts_pred, ones,
                       ones, depth_cap, gram=False, lower_only=False)
    var = (torch.diagonal(Kpp, dim1=-2, dim2=-1) + noise_pred[:, None]
           - torch.sum(V * V, dim=-2))
    return mu, torch.sqrt(torch.clamp(var, min=0.0))
