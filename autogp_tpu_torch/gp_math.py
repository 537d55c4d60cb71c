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

The gradient path's plain helpers are here too: `diag_blocks` and
`tri_inv_blocked` (the Wd of the kinv kernel's non-`wd` entries),
`kinv_from_linv` and the
closed-form cotangent of the MVN log density (autogp_tpu/gp_math.py:
402-473), which the plain versions of the kinv and tape-backward kernels
use; `mvn_logpdf_masked_cvjp`, the MVN log density as an autograd Function
with that cotangent as its backward (the dense gradient route of
`model.lml`); the joint-Cholesky posteriors `posterior_mvn_masked` and
`posterior_logpdf_masked`; and the GP-sum posterior of the decomposition
API, `infer_gp_sum_from_blocks`, with `normal_quantile`.
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


def _live_subtrees(node_type, depth_cap: int) -> np.ndarray:
    """[M] bools on the host: whether the subtree rooted at each slot holds
    an active slot in any heap of the batch (the root always counts)."""
    live = (node_type != 0).any(0).cpu().numpy().copy()
    for d in range(depth_cap - 2, -1, -1):
        s = np.arange((1 << d) - 1, (1 << (d + 1)) - 1)
        live[s] |= live[2 * s + 1] | live[2 * s + 2]
    live[0] = True
    return live


def eval_cov(node_type, params, ts1, ts2, depth_cap: int):
    """Covariance matrices [P, N1, N2] of the encoded trees on ts1 x ts2.

    node_type [P, M]; params [P, M, 3] already transformed to constrained
    space (model.transform_params); ts1 [N1]; ts2 [N2]. Slot by slot in
    post-order, as the reference's evaluator; a subtree empty in every
    heap of the batch is exactly 0 there (each of its slots selects the
    zero of every formula), so it is taken as 0 without evaluating its
    2^k - 1 slots: a deep heap costs what its active slots do."""
    M = (1 << depth_cap) - 1
    t1 = ts1[None, :, None]
    t2 = ts2[None, None, :]
    bottom = M // 2  # slots >= bottom are at the deepest level: leaves only.
    live = _live_subtrees(node_type, depth_cap)
    dtype = torch.promote_types(params.dtype, ts1.dtype)
    empty = torch.zeros((node_type.shape[0], ts1.shape[0], ts2.shape[0]),
                        dtype=dtype, device=params.device)

    def rec(s):
        if not live[s]:
            return empty
        t = node_type[:, s]
        p = params[:, s]
        if s >= bottom:
            return _leaf_cov(t, p, t1, t2)
        left = rec(2 * s + 1)
        right = rec(2 * s + 2)
        leaf_val = _leaf_cov(t, p, t1, t2)
        op_val = _combine(t, p, left, right, t1, t2)
        return torch.where(is_op_code(t)[:, None, None], op_val, leaf_val)

    return rec(0)


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


# torch's CUDA reduction gives each row of a [P, n] sum more threads when
# fewer than 16 rows are reduced (16 rows of 32 threads a block from 16 rows
# up), so below 16 rows a row is summed in another order. HMC's compacted
# sweeps and a particle mesh's shards run such batches.
ROW_SUM_ROWS = 16


def row_sum(x, dim=-1):
    """torch.sum(x, dim) over the trailing dims of x [P, ...], each
    particle's sum the same bits in a batch of any size: on the card a
    batch under ROW_SUM_ROWS rows is padded with zero rows first. The
    CPU's order does not depend on P."""
    P = x.shape[0]
    if x.is_cuda and P < ROW_SUM_ROWS:
        pad = x.new_zeros((ROW_SUM_ROWS - P,) + tuple(x.shape[1:]))
        return torch.sum(torch.cat([x, pad]), dim=dim)[:P]
    return torch.sum(x, dim=dim)


def mvn_logpdf_from_factor(d, alpha, mask):
    """[P] masked MVN log densities from diag(L) [P, N] and alpha = L^-1 x
    [P, N]; every LML route (value, gradient, noise gradient) ends here,
    so their values agree bit for bit on the same factor."""
    n = torch.sum(mask)
    logdet = 2.0 * row_sum(torch.log(d) * mask)
    return -0.5 * (n * LOG2PI + logdet + row_sum(alpha * alpha))


def use_blocked_inv(N: int) -> bool:
    """The noise gradient's closed form applies: N a power of two >= 64
    (autogp_tpu/gp_math.py:370-371); smaller buckets use autograd."""
    return N >= 64 and (N & (N - 1)) == 0


def diag_blocks(L, s: int):
    """[..., N/s, s, s] diagonal s x s blocks of L [..., N, N]
    (autogp_tpu/gp_math.py:310)."""
    N = L.shape[-1]
    return torch.stack([L[..., k * s:(k + 1) * s, k * s:(k + 1) * s]
                        for k in range(N // s)], dim=-3)


def tri_inv_blocked(L):
    """Inverse of lower-triangular L [..., n, n], with exact zeros above
    the diagonal (autogp_tpu/gp_math.py:262). The reference built it by
    recursive 2 x 2 blocking to put the work on the MXU; here it is one
    batched triangular solve against the identity. It gives the kinv
    kernel's Wd (the inverses of the factor's diagonal blocks) where the
    factorization did not keep them."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.tril(torch.linalg.solve_triangular(L, eye.expand_as(L),
                                                    upper=False))


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


class MvnLogpdfMaskedCvjp(torch.autograd.Function):
    """apply(K, x, mask, pregram): see `mvn_logpdf_masked_cvjp`."""

    @staticmethod
    def forward(ctx, K, x, mask, pregram: bool):
        from autogp_tpu_torch.ops import chol
        P, N, _ = K.shape
        Km = K if pregram else masked_gram(K, mask)
        xm = (x * mask).expand(P, N)
        if use_blocked_inv(N):
            d, alpha, wd, L = chol.chol_solve_strips(Km, xm)
            ctx.save_for_backward(L, alpha, mask, wd)
        else:
            L, alpha = chol.chol_solve(Km, xm)
            d = torch.diagonal(L, dim1=-2, dim2=-1)
            ctx.save_for_backward(L, alpha, mask)
        ctx.x_batched = x.dim() == 2
        return mvn_logpdf_from_factor(d, alpha, mask)

    @staticmethod
    def backward(ctx, g):
        from autogp_tpu_torch.ops import kinv
        L, alpha, mask, *wd = ctx.saved_tensors
        if wd:
            Kl, beta, _ = kinv.kinv_beta_strips(alpha, wd[0], L)
            Kinv = torch.tril(Kl) + torch.tril(Kl, -1).mT
        else:
            beta = torch.linalg.solve_triangular(
                L.mT, alpha[..., None], upper=True)[..., 0]
            eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
            Kinv = torch.cholesky_solve(eye.expand_as(L), L)
        Kbar = mvn_logpdf_cotangent(beta, Kinv, mask, g)
        xbar = -g[:, None] * beta
        return (Kbar, xbar if ctx.x_batched else xbar.sum(0), None, None)


def mvn_logpdf_masked_cvjp(K, x, mask, pregram: bool = False):
    """`mvn_logpdf_masked` with the closed-form cotangent as its backward
    (autogp_tpu/gp_math.py:337-473): Kbar = 0.5 g (beta beta^T - K^-1)
    m m^T, beta = K^-1 x, and xbar = -g beta.

    K [P, N, N] (lower triangle read; any N), x [N] or [P, N], mask [N].
    `pregram` says K already is the padded-identity gram (the assembly
    kernels emit it). The value is bitwise `mvn_logpdf_masked`'s: the same
    blocked factorization. Where `use_blocked_inv(N)` the backward takes K^-1 and
    beta from the kinv kernel; otherwise from dense triangular solves
    against the identity, as the reference's rule does in XLA."""
    return MvnLogpdfMaskedCvjp.apply(K, x, mask, pregram)


def mvn_logpdf(mu, K, x):
    """Dense MVN log density [P] of x [p] or [P, p] under N(mu [P, p],
    K [P, p, p]) (lower triangle read), through the blocked driver of
    ops/chol.py (kernel 2 on the card, its float64 trailing updates for
    float32 K); NaN where K is not positive definite."""
    from autogp_tpu_torch.ops import chol
    r = (x - mu).expand(K.shape[:-1])
    d, alpha = chol.chol_solve_diag(K, r.contiguous())
    return mvn_logpdf_from_factor(d, alpha, torch.ones_like(r[0]))


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


def posterior_mvn_masked(node_type, params, noise, ts, xs, mask, ts_pred,
                         depth_cap: int, noise_pred=None):
    """Conditional MVN (mu [P, p], cov [P, p, p]) of X(ts_pred) given
    X(ts_active) = xs_active, through the joint Cholesky
    (autogp_tpu/gp_math.py:501-538): with
        chol([[K11m, K12m], [K21m, K22 + noise_pred I]]) = [[L11, 0],
                                                            [L21, L22]]
    the conditional covariance is L22 L22^T, positive semi-definite by
    construction; the explicit Schur complement goes indefinite in
    float32. `noise` and `noise_pred` are [P] (default noise). The joint
    matrix has n + p rows for any p; it is factored whole (NaN where that
    fails), as the reference's is, by the blocked driver of ops/chol.py,
    whose float64 trailing updates keep a float32 joint accurate (a dense
    float32 Cholesky, cholesky_ex, put the LML of BASELINE config 2's joint
    gram 0.15-0.37 off on an NVIDIA H100; scripts/chol_ab.py)."""
    from autogp_tpu_torch.ops import chol, cov
    if noise_pred is None:
        noise_pred = noise
    P, n, p = node_type.shape[0], ts.shape[0], ts_pred.shape[0]
    z = torch.cat([ts, ts_pred])
    ones = torch.ones_like(z)
    zero = torch.zeros(P, dtype=z.dtype, device=z.device)
    K = cov.cov_tape(node_type, params, zero, z, z, ones, ones, depth_cap,
                     gram=False, lower_only=False)
    K = 0.5 * (K + K.mT)
    noise_diag = torch.cat([noise[:, None].expand(P, n),
                            noise_pred[:, None].expand(P, p)], dim=1)
    J = K + torch.diag_embed(noise_diag)
    m_ext = torch.cat([mask, torch.ones_like(ts_pred)])
    x_ext = torch.cat([xs * mask, torch.zeros_like(ts_pred)]).expand(P, -1)
    # The forward solve's first n entries are L11^-1 (xs * mask).
    L, alpha = chol.chol_solve(masked_gram(J, m_ext), x_ext.contiguous())
    bad = ~torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1)).all(dim=-1)
    L = torch.where(bad[:, None, None], float("nan"), L)
    mu = torch.matmul(L[:, n:, :n], alpha[:, :n, None])[..., 0]
    L22 = L[:, n:, n:]
    cov_pred = torch.matmul(L22, L22.mT)
    return mu, 0.5 * (cov_pred + cov_pred.mT)


def posterior_logpdf_masked(node_type, params, noise, ts, xs, mask, ts_pred,
                            y_pred, depth_cap: int, noise_pred=None):
    """[P] log densities of y_pred [p] under the posterior predictive MVN
    of `posterior_mvn_masked` (autogp_tpu/gp_math.py:586-599)."""
    mu, cov_pred = posterior_mvn_masked(node_type, params, noise, ts, xs,
                                        mask, ts_pred, depth_cap,
                                        noise_pred=noise_pred)
    return mvn_logpdf(mu, cov_pred, y_pred)


# ---------------------------------------------------------------------------
# Joint posterior over latent GP-sum components (GP.jl:904-993;
# autogp_tpu/gp_math.py:606-672)
# ---------------------------------------------------------------------------

def sum_gp_jitters(dtype) -> Tuple[float, ...]:
    """The jitters the GP-sum joint's a-block tries, in turn, for blocks
    computed in `dtype`. Float64: SUM_GP_JITTER alone, the reference's
    (autogp_tpu/gp_math.py:646-648). Float32: SUM_GP_JITTERS_F32, from
    SUM_GP_JITTER up by tens to SUM_GP_JITTER_F32, the reference's float32
    value: the blocks' rounding leaves the joint's Schur complement
    negative by ~1e-7, and the jitter is added to every posterior
    variance, so the smallest one that factorizes is kept (on config 4's fitted particles 1e-7 or 1e-6,
    where 1e-5 moved a posterior covariance of scale 3.4e-4 by 2.9e-2;
    NVIDIA H100, scripts/gp_sum_jitter.py)."""
    if dtype == torch.float64:
        return (C.SUM_GP_JITTER,)
    return C.SUM_GP_JITTERS_F32


def infer_gp_sum_from_blocks(Ktt, Ktp, Kpp, noise, xs, mask,
                             noise_pred=None, jitter=None):
    """Joint posterior over [F_1(T*), ..., F_m(T*), X(T*)] | X(T) = x, per
    particle.

    Ktt [P, m, n, n], Ktp [P, m, n, p], Kpp [P, m, p, p]: the covariance
    blocks of each particle's m components; noise [P] and noise_pred [P]
    (default noise); xs, mask [n] (mask pads the training block). Returns
    (mu [P, (m+1)p], cov [P, (m+1)p, (m+1)p]).

    Joint-Cholesky form only: with J = [[Sbb, Sab^T], [Sab, Saa]] and
    chol(J) = [[L11, 0], [L21, L22]], mu = L21 L11^-1 x and cov = L22
    L22^T, positive semi-definite by construction (the explicit Saa -
    Sab Sbb^-1 Sab^T goes indefinite in float32). A jitter goes on Saa
    first, since X(T*) = sum F_i(T*) + noise makes the joint singular:
    `jitter` is a sequence tried in turn, each particle keeping the first
    that factorizes (default `sum_gp_jitters` of the blocks' dtype; pass
    the blocks' own when they were computed in float32 and are
    conditioned in float64). Where none does, NaN, as the reference's
    failed factorization gives."""
    P, m, n, p = Ktp.shape
    dt, dev = Ktt.dtype, Ktt.device
    if noise_pred is None:
        noise_pred = noise
    Ktt = 0.5 * (Ktt + Ktt.mT)
    Kpp = 0.5 * (Kpp + Kpp.mT)
    S_tt, S_tp, S_pp = Ktt.sum(dim=1), Ktp.sum(dim=1), Kpp.sum(dim=1)
    d_a = m * p + p
    eye_p = torch.eye(p, dtype=dt, device=dev)
    Saa = torch.zeros((P, d_a, d_a), dtype=dt, device=dev)
    for i in range(m):
        sl = slice(i * p, (i + 1) * p)
        Saa[:, sl, sl] = Kpp[:, i]
        Saa[:, sl, m * p:] = Kpp[:, i]
        Saa[:, m * p:, sl] = Kpp[:, i].mT
    Saa[:, m * p:, m * p:] = S_pp + noise_pred[:, None, None] * eye_p
    # Sigma_ab: the a-block's covariance with X(T), padding masked out.
    Sab = torch.cat([Ktp.mT.reshape(P, m * p, n), S_tp.mT], dim=1)
    Sab = Sab * mask[None, None, :]
    Sbb = masked_gram(
        S_tt + noise[:, None, None] * torch.eye(n, dtype=dt, device=dev),
        mask)
    Saa = 0.5 * (Saa + Saa.mT)
    eye_a = torch.eye(d_a, dtype=dt, device=dev)
    L = todo = None
    for jit in (sum_gp_jitters(dt) if jitter is None else jitter):
        J = torch.cat([torch.cat([Sbb, Sab.mT], dim=2),
                       torch.cat([Sab, Saa + jit * eye_a], dim=2)], dim=1)
        Lj, info = torch.linalg.cholesky_ex(J)
        if L is None:
            L, todo = Lj, info > 0
        else:
            L = torch.where(todo[:, None, None], Lj, L)
            todo = todo & (info > 0)
        if not bool(todo.any()):
            break
    L = torch.where(todo[:, None, None], float("nan"), L)
    alpha = torch.linalg.solve_triangular(
        L[:, :n, :n], (xs * mask).expand(P, n)[..., None], upper=False)
    mu = torch.matmul(L[:, n:, :n], alpha)[..., 0]
    L22 = L[:, n:, n:]
    cov = torch.matmul(L22, L22.mT)
    return mu, 0.5 * (cov + cov.mT)


def normal_quantile(q, mu, sigma):
    """Marginal Gaussian quantiles (GP.jl:1006-1012), numpy."""
    from scipy.stats import norm
    return norm.ppf(q, loc=mu, scale=sigma)
