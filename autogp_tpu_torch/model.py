"""Generative model: PCFG prior over kernel trees + MVN likelihood, batched.

Port of autogp_tpu/model.py (Model.jl of the reference): whitened
parameters mapped to constrained space (:75-95), the tree prior's density
(:155-188) and its level-vectorised sampler (:195-256), the log marginal
likelihood with its gradient route (:263-293), the noise-HMC pieces
`assemble_K0` and the analytic noise gradient (:296-405), `joint_score`
and `generate`.

Every function takes the particle axis first: node_type [P, M] int64,
params_z [P, M, 3], noise_z [P]. The data (ts, xs, mask, each [N]) is
shared by all particles and unbatched by signature. Random draws come from
an explicit torch.Generator on the tensors' device; they cannot replay JAX
threefry streams, so samplers are held to the reference by distribution.
Every draw whose axis 0 is the particles goes through `draw`, which under
a particle mesh (parallel/mesh.py) draws the whole batch and keeps the
rank's rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import gp_math
from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv
from autogp_tpu_torch.utils import trace

LOG2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Parameter transforms (Model.jl:24-63; autogp_tpu/model.py:35-95)
# ---------------------------------------------------------------------------

def untransform_param(field: str, x, config: C.GPConfig):
    """Scalar inverse transform by field name, numpy (Model.jl:50-63)."""
    if field == "gamma":
        p = config.prior["gamma"]
        return (np.log(x / (p["scale"] - x)) - p["mu"]) / p["sigma"]
    p = config.prior["period" if field == "period" else "wildcard"]
    return (np.log(x) - p["mu"]) / p["sigma"]


def transform_param(field: str, z, config: C.GPConfig):
    """Scalar transform by field name, numpy (Model.jl:35-48)."""
    if field == "gamma":
        p = config.prior["gamma"]
        return p["scale"] / (1.0 + np.exp(-(p["mu"] + p["sigma"] * z)))
    p = config.prior["period" if field == "period" else "wildcard"]
    return np.exp(p["mu"] + p["sigma"] * z)


def transform_params(node_type, params_z, tables: "PriorTables"):
    """Whitened -> constrained transform over whole heaps: node_type
    [..., M], params_z [..., M, 3] -> [..., M, 3] (0 at unused slots)."""
    kind = tables.param_kind[node_type]                   # [..., M, 3]
    mu = tables.ttable[kind, 0]
    sigma = tables.ttable[kind, 1]
    scale = tables.ttable[kind, 2]
    lin = mu + sigma * params_z
    lognorm = torch.exp(lin)
    logit = scale / (1.0 + torch.exp(-lin))
    out = torch.where(kind == C.KIND_GAMMA, logit, lognorm)
    return torch.where(kind > 0, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))


def transform_noise(noise_z, config: C.GPConfig):
    """Observation-noise variance incl. model jitter (Model.jl:133-134)."""
    p = config.prior["wildcard"]
    return torch.exp(p["mu"] + p["sigma"] * noise_z) + C.MODEL_JITTER


def normal_logpdf(z):
    return -0.5 * (z * z + LOG2PI)


# ---------------------------------------------------------------------------
# Prior tables (autogp_tpu/model.py:106-132)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PriorTables:
    """Tables derived from a GPConfig, as tensors on one device."""
    node_dist: torch.Tensor       # [3, 8] leaf / nocp / cp distributions
    log_node_dist: torch.Tensor   # [3, 8]
    ttable: torch.Tensor          # [4, 3] transform params
    param_kind: torch.Tensor      # [NUM_TYPES, 3] int64
    arity: torch.Tensor           # [NUM_TYPES] int64
    depths: torch.Tensor          # [M] int64, 1-based
    ancestors: torch.Tensor       # [M, D] int64, -1 padded
    depth_cap: int
    changepoints: bool

    @property
    def max_nodes(self) -> int:
        return (1 << self.depth_cap) - 1


def prior_tables(config: C.GPConfig, device, dtype) -> PriorTables:
    nd = config.node_dist_table()
    with np.errstate(divide="ignore"):
        log_nd = np.log(nd)
    D = config.depth_cap

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)

    # Host-to-device copies: each waits for the device's queue.
    with trace.sync("model.prior_tables"):
        return PriorTables(
            node_dist=f(nd), log_node_dist=f(log_nd),
            ttable=f(config.transform_table()), param_kind=i(C.PARAM_KIND),
            arity=i(C.PARAM_ARITY), depths=i(gp_math.slot_depths(D)),
            ancestors=i(gp_math.ancestor_table(D)), depth_cap=D,
            changepoints=config.changepoints)


def _dist_row(depth, cp_allowed, tables: PriorTables, leaf_cap=None):
    """Node-distribution row per slot (Model.jl:66-76): 0 = leaf only at
    the depth cap, else 2 if ChangePoint is allowed, else 1."""
    cap = tables.depth_cap if leaf_cap is None else leaf_cap
    return torch.where(depth == cap, 0,
                       torch.where(cp_allowed, 2, 1))


def subtree_member(root_idx, tables: PriorTables):
    """[P, M] mask of slots in the subtree of root_idx [P] (inclusive)."""
    return (tables.ancestors[None, :, :]
            == root_idx[:, None, None]).any(dim=-1)


def is_op_parent(t):
    return (t == C.PLUS) | (t == C.TIMES) | (t == C.CHANGEPOINT)


def as_index(idx, P, device):
    if isinstance(idx, int):
        return torch.full((P,), idx, dtype=torch.int64, device=device)
    return idx


def param_slot_mask(t, tables):
    """[..., 3] mask of the parameter slots a node of type t carries."""
    ar = tables.arity[t]
    return torch.arange(C.MAX_PARAMS, device=t.device) < ar[..., None]


# ---------------------------------------------------------------------------
# Tree prior: log density (Model.jl:78-128; autogp_tpu/model.py:155-188)
# ---------------------------------------------------------------------------

def tree_prior_logpdf(node_type, params_z, tables: PriorTables,
                      root_idx=0, root_cp_allowed=None, leaf_cap=None):
    """[P] log density of the subtrees rooted at root_idx under the prior.

    root_idx: int or [P]; root_cp_allowed: [P] bool (changepoint gating of
    subtree proposals, inference_rejuv_tree_sr.jl:27-39), default
    config.changepoints. `leaf_cap` scores under a shallower max depth."""
    P, M = node_type.shape
    dev = node_type.device
    root = as_index(root_idx, P, dev)
    if root_cp_allowed is None:
        root_cp_allowed = torch.full((P,), tables.changepoints, device=dev)
    active = node_type > 0
    parent_idx = torch.clamp((torch.arange(M, device=dev) - 1) // 2, min=0)
    parent_type = node_type[:, parent_idx]
    is_root = torch.arange(M, device=dev)[None, :] == root[:, None]
    cp_allowed = torch.where(is_root, root_cp_allowed[:, None],
                             parent_type == C.CHANGEPOINT)
    rows = _dist_row(tables.depths[None, :], cp_allowed, tables,
                     leaf_cap=leaf_cap)
    code_idx = torch.clamp(node_type - 1, 0, 7)
    logp_type = tables.log_node_dist[rows, code_idx]
    slot_mask = param_slot_mask(node_type, tables)
    zero = torch.zeros((), dtype=params_z.dtype, device=dev)
    logp_params = torch.sum(torch.where(slot_mask, normal_logpdf(params_z),
                                        zero), dim=-1)
    member = subtree_member(root, tables)
    contrib = torch.where(active & member, logp_type + logp_params, zero)
    return gp_math.row_sum(contrib)


# ---------------------------------------------------------------------------
# Tree prior: sampling (autogp_tpu/model.py:195-256)
# ---------------------------------------------------------------------------

class Shard(NamedTuple):
    """Rows [offset, offset + n) of a particle batch of `total` rows: what
    one rank of a particle mesh holds (parallel/mesh.py)."""
    offset: int
    total: int


def draw(sampler, gen, shape, dtype, device, shard: Optional[Shard] = None):
    """`sampler(shape, generator=gen, ...)` (torch.rand or torch.randn)
    for a batch whose axis 0 is the particles. With a shard it draws the
    whole batch, [total, ...], and keeps the shard's shape[0] rows, so
    every rank consumes the generator as the unsharded program does;
    shard=None is the plain call."""
    if shard is None:
        return sampler(shape, generator=gen, dtype=dtype, device=device)
    full = sampler((shard.total,) + tuple(shape[1:]), generator=gen,
                   dtype=dtype, device=device)
    return full[shard.offset:shard.offset + shape[0]]


def gumbel(gen, shape, dtype, device, shard: Optional[Shard] = None):
    """Standard Gumbel noise; argmax(logits + gumbel) is a categorical draw
    that never picks a zero-probability (-inf logit) category."""
    u = draw(torch.rand, gen, shape, dtype, device, shard)
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def sample_subtree(gen, node_type, params_z, tables: PriorTables,
                   root_idx=0, root_cp_allowed=None,
                   shard: Optional[Shard] = None):
    """Resample the subtrees rooted at root_idx ([P] or int) from the prior.

    Slots outside each subtree keep their values; slots inside are
    overwritten (inactive ones get type 0 / params 0). The loop runs over
    the depth_cap levels, each level's slots sampled as one batch (the
    dependence is parent -> child only)."""
    P, M = node_type.shape
    D = tables.depth_cap
    dev, dt = params_z.device, params_z.dtype
    root = as_index(root_idx, P, dev)
    if root_cp_allowed is None:
        root_cp_allowed = torch.full((P,), tables.changepoints, device=dev)
    g = gumbel(gen, (P, M, 8), dt, dev, shard)
    z_all = draw(torch.randn, gen, (P, M, C.MAX_PARAMS), dt, dev, shard)
    member_all = subtree_member(root, tables)
    new_type = torch.zeros_like(node_type)
    new_params = torch.zeros_like(params_z)
    for lvl in range(D):
        lo, hi = (1 << lvl) - 1, (1 << (lvl + 1)) - 1   # slots [lo, hi)
        if lvl == 0:
            parent_t = torch.zeros((P, 1), dtype=node_type.dtype, device=dev)
        else:
            plo = (1 << (lvl - 1)) - 1
            parent_t = torch.repeat_interleave(new_type[:, plo:lo], 2, dim=1)
        member = member_all[:, lo:hi]
        is_root = torch.arange(lo, hi, device=dev)[None, :] == root[:, None]
        active = member & (is_root | is_op_parent(parent_t))
        cp_allowed = torch.where(is_root, root_cp_allowed[:, None],
                                 parent_t == C.CHANGEPOINT)
        row = _dist_row(tables.depths[None, lo:hi], cp_allowed, tables)
        logits = tables.log_node_dist[row]                  # [P, W, 8]
        t = torch.argmax(logits + g[:, lo:hi], dim=-1) + 1
        t = torch.where(active, t, 0).to(node_type.dtype)
        z = torch.where(param_slot_mask(t, tables), z_all[:, lo:hi], 0.0)
        new_type[:, lo:hi] = t
        new_params[:, lo:hi] = z
    out_type = torch.where(member_all, new_type, node_type)
    out_params = torch.where(member_all[..., None], new_params, params_z)
    return out_type, out_params


def sample_tree(gen, n: int, tables: PriorTables, dtype, device,
                shard: Optional[Shard] = None):
    """n full trees from the prior: (node_type [n, M], params_z [n, M, 3])."""
    M = tables.max_nodes
    node_type = torch.zeros((n, M), dtype=torch.int64, device=device)
    params_z = torch.zeros((n, M, C.MAX_PARAMS), dtype=dtype, device=device)
    return sample_subtree(gen, node_type, params_z, tables, root_idx=0,
                          shard=shard)


# ---------------------------------------------------------------------------
# Likelihood and joint score (Model.jl:130-138; model.py:263-293, 408-436)
# ---------------------------------------------------------------------------

def lml(node_type, params_z, noise_z, ts, xs, mask, config: C.GPConfig,
        tables: PriorTables, *, part_batch: Optional[int] = None):
    """[P] log marginal likelihoods of (ts, xs, mask) under each particle.

    Value only (model.lml's fused route, cov_pallas_vjp.py:857-865
    primal): kernel 1 assembles the padded-identity gram with noise,
    lower triangle only, and kernel 2's blocked driver returns diag(L) and
    alpha. When params_z or noise_z requires grad (and grad mode is on)
    the same value comes from a differentiable route, chosen as the
    reference chooses it (autogp_tpu/model.py:280-291): where
    `gp_math.use_blocked_inv(N)` (N a power of two >= 64),
    `cov_vjp.LmlTapeFused`, whose backward runs the kinv and fused
    tape-backward kernels; otherwise (the 32-point bucket, any other N)
    `cov_vjp.cov_matrix_diff` + `gp_math.mvn_logpdf_masked_cvjp`, whose
    backward forms the cotangent [P, N, N] densely and hands it to the
    tape backward's unfused entry. All three values are bitwise equal. A
    failed factorization gives NaN. The gradient's tape backward uses the
    partition of `part_batch` particles (ops/cov_vjp.py; default: this
    batch's): a batch of some particles of a larger one passes the larger
    one's count, and each particle's gradient is then the larger batch's
    bit for bit."""
    with trace.span("model.lml"):
        params_t = transform_params(node_type, params_z, tables)
        noise = transform_noise(noise_z, config)
        if torch.is_grad_enabled() and (params_t.requires_grad
                                        or noise.requires_grad):
            if gp_math.use_blocked_inv(ts.shape[0]):
                return cov_vjp.LmlTapeFused.apply(
                    params_t, noise, node_type, ts, xs, mask,
                    tables.depth_cap, part_batch)
            K = cov_vjp.cov_matrix_diff(node_type, params_t, noise, ts,
                                        mask, tables.depth_cap,
                                        part_batch=part_batch)
            return gp_math.mvn_logpdf_masked_cvjp(K, xs, mask, True)
        K = cov.cov_tape(node_type, params_t, noise, ts, ts, mask, mask,
                         tables.depth_cap, gram=True, lower_only=True)
        return gp_math.mvn_logpdf_masked(K, xs, mask)


def lml_f64(node_type, params_z, noise_z, ts, xs, mask, config: C.GPConfig,
            tables: PriorTables):
    """[P] LMLs in float64 from float64 inputs (`tables` of
    prior_tables(..., torch.float64)), for grams that float32 cannot hold:
    decompose's fragment models, whose noise is 1e-10 plus MODEL_JITTER
    and whose kernels are often of low rank. Kernel 1's float64 entry
    assembles the padded-identity gram on the card (the plain version on
    the CPU) and one float64 Cholesky factors it (`chol.dense_solve`,
    the float64 route of ops/chol.py; kernel 2 is float32 only). NaN where the
    gram is not positive definite."""
    params_t = transform_params(node_type, params_z, tables)
    noise = transform_noise(noise_z, config)
    K = cov.cov_tape(node_type, params_t, noise, ts, ts, mask, mask,
                     tables.depth_cap, gram=True, lower_only=False)
    P, N = node_type.shape[0], ts.shape[0]
    _, d, alpha, _ = chol.dense_solve(K, (xs * mask).expand(P, N),
                                      want_l=False)
    return gp_math.mvn_logpdf_from_factor(d, alpha, mask)


def assemble_K0(node_type, params_z, ts, mask, config: C.GPConfig,
                tables: PriorTables):
    """[P, N, N] noise-free padded-identity grams, lower triangle only
    (autogp_tpu/model.py:296-319). Noise HMC only moves the active
    diagonal, K(nz) = K0 + noise(nz) diag(mask), so K0 is assembled once
    per trajectory and each leapfrog pays the factorization only."""
    params_t = transform_params(node_type, params_z, tables)
    zero = torch.zeros(node_type.shape[0], dtype=params_t.dtype,
                       device=params_t.device)
    return cov.cov_tape(node_type, params_t, zero, ts, ts, mask, mask,
                        tables.depth_cap, gram=True, lower_only=True)


def _value_and_noise_grad(Km, noise, xs, mask, config: C.GPConfig):
    """(lml, d lml / d noise_z) of padded-identity grams Km [P, N, N] with
    the noise on their active diagonal. With beta = Km^-1 x,
        d lml / d noise = -1/2 (tr_active(Km^-1) - beta^T beta),
        tr_active(Km^-1) = ||L^-1||_F^2 - (N - n)
    (padded columns of L^-1 are unit vectors), then the chain rule through
    the log-normal noise transform (autogp_tpu/model.py:322-405)."""
    P, N, _ = Km.shape
    diag, alpha, wd, L = chol.chol_solve_strips(Km,
                                                (xs * mask).expand(P, N))
    beta, fro2 = kinv.linv_stats_wd(L, alpha, wd)
    val = gp_math.mvn_logpdf_from_factor(diag, alpha, mask)
    n = torch.sum(mask)
    tr_active = fro2 - (N - n)
    dlml_dnoise = -0.5 * (tr_active - gp_math.row_sum(beta * beta))
    p = config.prior["wildcard"]
    dnoise_dz = p["sigma"] * (noise - C.MODEL_JITTER)
    return val, dlml_dnoise * dnoise_dz


def lml_value_and_noise_grad_from_K0(K0, noise_z, xs, mask,
                                     config: C.GPConfig):
    """([P] lml, [P] d lml / d noise_z) from the noise-free grams of
    `assemble_K0` (autogp_tpu/model.py:322-353)."""
    noise = transform_noise(noise_z, config)
    Km = K0 + torch.diag_embed(noise[:, None] * mask)
    return _value_and_noise_grad(Km, noise, xs, mask, config)


def lml_value_and_noise_grad(node_type, params_z, noise_z, ts, xs, mask,
                             config: C.GPConfig, tables: PriorTables, *,
                             part_batch: Optional[int] = None):
    """([P] lml, [P] d lml / d noise_z) without reverse mode through the
    covariance when the closed form applies (gp_math.use_blocked_inv);
    otherwise autograd of `lml` in noise_z (autogp_tpu/model.py:356-405),
    with `part_batch` as in `lml`."""
    if not gp_math.use_blocked_inv(ts.shape[0]):
        with torch.enable_grad():
            nz = noise_z.detach().requires_grad_(True)
            val = lml(node_type, params_z.detach(), nz, ts, xs, mask, config,
                      tables, part_batch=part_batch)
            with trace.span("model.lml_grad"):
                (grad,) = torch.autograd.grad(val.sum(), nz)
        return val.detach(), grad
    params_t = transform_params(node_type, params_z, tables)
    noise = transform_noise(noise_z, config)
    Km = cov.cov_tape(node_type, params_t, noise, ts, ts, mask, mask,
                      tables.depth_cap, gram=True, lower_only=True)
    return _value_and_noise_grad(Km, noise, xs, mask, config)


def joint_score(node_type, params_z, noise_z, ts, xs, mask,
                config: C.GPConfig, tables: PriorTables):
    """[P] log p(tree, noise, xs) -- the Gen trace score."""
    return (tree_prior_logpdf(node_type, params_z, tables)
            + normal_logpdf(noise_z)
            + lml(node_type, params_z, noise_z, ts, xs, mask, config,
                  tables))


def generate(gen, n: int, ts, xs, mask, config: C.GPConfig,
             tables: PriorTables, noise_z_constraint=None,
             shard: Optional[Shard] = None):
    """Gen.generate(model, (ts, config), {xs[, noise]}) for n particles.

    Samples trees (and noise unless constrained) from the prior; the
    weight is the log density of the constrained choices: the LML (plus
    the noise prior if noise is constrained). Returns (node_type,
    params_z, noise_z, weight); with a shard, the shard's n rows."""
    dt, dev = ts.dtype, ts.device
    node_type, params_z = sample_tree(gen, n, tables, dt, dev, shard)
    if noise_z_constraint is None:
        noise_z = draw(torch.randn, gen, (n,), dt, dev, shard)
        w_noise = torch.zeros((n,), dtype=dt, device=dev)
    else:
        noise_z = torch.full((n,), float(noise_z_constraint), dtype=dt,
                             device=dev)
        w_noise = normal_logpdf(noise_z)
    w = w_noise + lml(node_type, params_z, noise_z, ts, xs, mask, config,
                      tables)
    return node_type, params_z, noise_z, w
