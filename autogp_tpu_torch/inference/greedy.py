"""Greedy AIC-driven kernel structure search (reference: src/Greedy.jl).

Port of autogp_tpu/inference/greedy.py. CKS-style search (Kim & Teh 2018,
Alg. 2): start from the best single base kernel, then repeatedly try every
replace-leaf and insert-operator extension, MAP-optimize each candidate's
parameters with a line-searched gradient ascent (Gen.map_optimize analog)
and keep the argmin-AIC candidate while it improves. `fit_greedy_mcmc` is
the hybrid greedy/MCMC chain ("Algorithm 0").

Candidate structures are enumerated on the host (trees are tiny) with the
reference's numpy code and draw order, so `api._GLOBAL["rng"]` draws the
same candidates in both packages. They are padded to one batch and
optimized together: where the reference vmapped a while loop, the port
runs one batched score-and-gradient (`model.lml` under autograd: its fused
route at N = 2^k >= 64, so kernels 1, 2, 4 and 5 on the card) per probe,
while any lane is live, and a finished lane stays frozen exactly as the
batched predicate of the reference's loop freezes it.
"""

from __future__ import annotations

import math
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import model as M
from autogp_tpu_torch import tree as T
from autogp_tpu_torch.inference import moves
from autogp_tpu_torch.inference import smc

MAX_OPT = 500          # update_and_optimize_structure (Greedy.jl:363)
MAX_OPT_MCMC = 10      # greedy_mcmc_rejuvenate (Greedy.jl:57)


# ---------------------------------------------------------------------------
# MAP optimization (Gen.map_optimize analog; greedy.py:37-94)
# ---------------------------------------------------------------------------

class MapResult(NamedTuple):
    """map_optimize's result for a batch of B lanes: params_z [B, M, 3],
    noise_z [B], score [B], lml [B], the accepted rounds per lane [B] and
    the probes the batch ran (one score-and-gradient each)."""
    params_z: torch.Tensor
    noise_z: torch.Tensor
    score: torch.Tensor
    lml: torch.Tensor
    rounds: torch.Tensor
    probes: int


def _score_fn(nt, pz, nz, data, cfg, tables, pmask):
    """[B] (score, lml): the parameters' and noise's standard-normal log
    densities plus the LML (greedy.py:37-42)."""
    lp_params = torch.sum(M.normal_logpdf(pz) * pmask, dim=(1, 2))
    lp_noise = M.normal_logpdf(nz)
    lml = M.lml(nt, pz, nz, data.ts, data.xs, data.mask, cfg, tables)
    return lp_params + lp_noise + lml, lml


def _value_and_grad(nt, pz, nz, data, cfg, tables, pmask, nmask):
    """[B] score and lml, and the masked gradients of each lane's score in
    its own (params_z, noise_z): one autograd pass over the lanes' sum."""
    with torch.enable_grad():
        p = pz.detach().requires_grad_(True)
        n = nz.detach().requires_grad_(True)
        s, lml = _score_fn(nt, p, n, data, cfg, tables, pmask)
        gp, gn = torch.autograd.grad(s.sum(), (p, n))
    return s.detach(), lml.detach(), gp * pmask, gn * nmask


def map_optimize(nt, pz, nz, data, cfg, tables, infer_noise: bool,
                 max_rounds: int = MAX_OPT, max_step: float = 0.1,
                 tau: float = 0.5, min_step: float = 1e-12) -> MapResult:
    """Repeated line-searched gradient-ascent steps on the active
    parameters (and the noise when inferred) of every lane of the batch
    nt [B, M], pz [B, M, 3], nz [B], until each lane's score stops
    improving (Greedy.jl:358-381 with Gen.map_optimize's backtracking).

    One flat probe loop, as in the reference: an accepted probe applies the
    step and resets it to `max_step` (a new map_optimize round in Gen); a
    rejected one multiplies it by `tau`. A lane stops when the step falls
    below `min_step`, after `max_rounds` accepted rounds or after
    2 max_rounds + 64 probes; a stopped lane is never updated again. A
    probe whose score is not finite (a failed factorization) is never
    accepted."""
    pmask = T.param_mask(nt).to(pz.dtype)
    nmask = 1.0 if infer_noise else 0.0
    max_probes = 2 * max_rounds + 64
    B = nt.shape[0]
    dev, dt = pz.device, pz.dtype

    s, lml, gp, gn = _value_and_grad(nt, pz, nz, data, cfg, tables, pmask,
                                     nmask)
    step = torch.full((B,), max_step, dtype=dt, device=dev)
    reset = torch.full_like(step, max_step)
    rounds = torch.zeros((B,), dtype=torch.int64, device=dev)
    it = torch.zeros_like(rounds)

    def live():
        return (step >= min_step) & (rounds < max_rounds) & (it < max_probes)

    active = live()
    probes = 0
    while bool(active.any()):
        pz2 = pz + step[:, None, None] * gp
        nz2 = nz + step * gn
        s2, lml2, gp2, gn2 = _value_and_grad(nt, pz2, nz2, data, cfg, tables,
                                             pmask, nmask)
        ok = active & (s2 > s) & torch.isfinite(s2)
        pz = torch.where(ok[:, None, None], pz2, pz)
        nz = torch.where(ok, nz2, nz)
        s = torch.where(ok, s2, s)
        lml = torch.where(ok, lml2, lml)
        gp = torch.where(ok[:, None, None], gp2, gp)
        gn = torch.where(ok, gn2, gn)
        step = torch.where(active, torch.where(ok, reset, step * tau), step)
        rounds = rounds + ok.to(torch.int64)
        it = it + active.to(torch.int64)
        active = live()
        probes += 1
    return MapResult(pz, nz, s, lml, rounds, probes)


# ---------------------------------------------------------------------------
# AIC (Greedy.jl:27-50; greedy.py:97-104)
# ---------------------------------------------------------------------------

def n_params(nt, infer_noise: bool):
    """k in the AIC: active numeric tree params (+ noise when inferred),
    per heap of nt [..., M] (a tensor or a numpy array)."""
    return T.num_active_params(torch.as_tensor(nt)) + (1 if infer_noise
                                                       else 0)


def compute_aic(lml, k):
    """2 (k - logp_data); logp_data is the LML (Greedy.jl:43-50)."""
    return 2.0 * (k - lml)


# ---------------------------------------------------------------------------
# Candidate enumeration (host numpy, the reference's code and draw order;
# Greedy.jl:142-352, greedy.py:111-212)
# ---------------------------------------------------------------------------

def leaf_node_types(cfg: C.GPConfig) -> List[int]:
    return [i + 1 for i, p in enumerate(cfg.node_dist_leaf) if p > 0]


def op_node_types(cfg: C.GPConfig) -> List[int]:
    dist = cfg.node_dist_cp if cfg.changepoints else cfg.node_dist_nocp
    n_leaf = len(cfg.node_dist_leaf)
    return [i + 1 for i, p in enumerate(dist) if p > 0 and i >= n_leaf]


def _subtree_slots(s: int, M_: int) -> List[int]:
    out = []
    stack = [s]
    while stack:
        i = stack.pop()
        if i < M_:
            out.append(i)
            stack.append(2 * i + 1)
            stack.append(2 * i + 2)
    return out


def _move_subtree(nt, pz, src: int, dst: int, M_: int):
    """Re-index the subtree at src to root at dst (host numpy);
    extract_subtree_choices analog (inference_utils.jl:116-146)."""
    new_nt = np.zeros_like(nt)
    new_pz = np.zeros_like(pz)
    stack = [(src, dst)]
    while stack:
        i, o = stack.pop()
        if i >= M_ or nt[i] == 0:
            continue
        if o >= M_:
            raise ValueError("subtree move exceeds depth cap")
        new_nt[o] = nt[i]
        new_pz[o] = pz[i]
        stack.append((2 * i + 1, 2 * o + 1))
        stack.append((2 * i + 2, 2 * o + 2))
    return new_nt, new_pz


def _random_leaf_params(rng, node_type: int) -> np.ndarray:
    """make_base_kernel_choicemap: params ~ Normal(0,1) (Greedy.jl:204-218)."""
    z = np.zeros(C.MAX_PARAMS)
    ar = int(C.PARAM_ARITY[node_type])
    z[:ar] = rng.standard_normal(ar)
    return z


def enumerate_next_structures(nt, pz, cfg: C.GPConfig, rng
                              ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """All replace-leaf and insert-operator candidates (Greedy.jl:383-387)
    of the heap nt [M], pz [M, 3] (numpy).

    Candidate order mirrors the reference: replace-leaf over leaf slots x
    leaf types, then insert-op over (sorted) subtree slots x op types x
    leaf types."""
    M_ = len(nt)
    leaf_types = leaf_node_types(cfg)
    op_types = op_node_types(cfg)
    cands = []

    leaf_slots = [i for i in range(M_)
                  if nt[i] in (1, 2, 3, 4, 5, 9)]
    node_slots = sorted([i for i in range(M_) if nt[i] > 0])

    # Move 1: replace leaf with a different base kernel (Greedy.jl:225-274).
    for s in leaf_slots:
        for t in leaf_types:
            if t == nt[s]:
                continue
            nt2 = nt.copy()
            pz2 = pz.copy()
            nt2[s] = t
            pz2[s] = _random_leaf_params(rng, t)
            cands.append((nt2, pz2))

    # Move 2: insert operator above a subtree (Greedy.jl:281-352):
    # old subtree -> left child; fresh random leaf -> right child.
    for s in node_slots:
        for o in op_types:
            for t in leaf_types:
                if 2 * s + 2 >= M_:
                    continue  # would exceed the depth cap
                try:
                    nt2, pz2 = _move_subtree(nt, pz, s, 2 * s + 1, M_)
                except ValueError:
                    continue
                # keep everything outside the old subtree
                sub = set(_subtree_slots(s, M_))
                for i in range(M_):
                    if i not in sub and nt[i] > 0:
                        nt2[i] = nt[i]
                        pz2[i] = pz[i]
                nt2[s] = o
                pz2[s] = np.zeros(C.MAX_PARAMS)
                nt2[2 * s + 2] = t
                pz2[2 * s + 2] = _random_leaf_params(rng, t)
                cands.append((nt2, pz2))
    return cands


# ---------------------------------------------------------------------------
# Batched optimize + select (greedy_search_initialize / _extend;
# greedy.py:233-309)
# ---------------------------------------------------------------------------

def _pad_pow2(k: int, minimum: int = 1) -> int:
    return max(minimum, 1 << math.ceil(math.log2(max(k, 1))))


def sweep_bucket(cfg: C.GPConfig, max_depth: int) -> int:
    """One candidate-batch size for a whole greedy depth sweep (the
    reference pads every optimize_candidates call to it so that the sweep
    compiles one program; the port keeps it so that both packages optimize
    the same batches). After d accepted steps the tree has <= d leaves and
    <= 2d - 1 nodes, so the largest extension round enumerates at most
    leaves (L - 1) + nodes O L candidates (Greedy.jl:416-432)."""
    L = len(leaf_node_types(cfg))
    O = len(op_node_types(cfg))
    d = max(max_depth - 1, 1)
    bound = max(L, d * (L - 1) + (2 * d - 1) * O * L)
    return _pad_pow2(bound)


class Best(NamedTuple):
    """optimize_candidates' pick, with what the batch cost."""
    node_type: np.ndarray    # [M]
    params_z: np.ndarray     # [M, 3] float64
    noise_z: float
    lml: float
    aic: float
    candidates: int          # real candidates in the padded batch
    probes: int


def optimize_candidates(cands, nz0, data, cfg, tables, infer_noise,
                        max_rounds=MAX_OPT, pad_to: Optional[int] = None
                        ) -> Best:
    """Optimize a list of candidate structures in one batch and return the
    argmin-AIC one. Padding lanes repeat the last candidate and never win.
    As in the reference, np.argmin picks the first NaN AIC if there is
    one (a candidate whose every probe failed keeps its NaN start)."""
    k = len(cands)
    pad = max(_pad_pow2(k), pad_to or 0)
    M_ = cfg.max_nodes
    nts = np.zeros((pad, M_), np.int64)
    pzs = np.zeros((pad, M_, C.MAX_PARAMS), np.float64)
    for i in range(pad):
        nts[i], pzs[i] = cands[min(i, k - 1)]
    dev, dt = data.ts.device, data.ts.dtype
    nt_t = torch.as_tensor(nts, device=dev)
    res = map_optimize(nt_t, torch.as_tensor(pzs, dtype=dt, device=dev),
                       torch.full((pad,), float(nz0), dtype=dt, device=dev),
                       data, cfg, tables, infer_noise, max_rounds=max_rounds)
    aic = compute_aic(res.lml, n_params(nt_t, infer_noise))
    aic_np = aic.cpu().numpy().astype(np.float64)
    aic_np[k:] = np.inf
    best = int(np.argmin(aic_np))
    return Best(nts[best], res.params_z[best].cpu().numpy().astype(
        np.float64), float(res.noise_z[best]), float(res.lml[best]),
        float(aic_np[best]), k, res.probes)


def greedy_search_initialize(data, cfg, tables, rng, nz0,
                             infer_noise: bool, pad_to=None) -> Best:
    """Best single-leaf structure (Greedy.jl:389-414)."""
    cands = []
    M_ = cfg.max_nodes
    for t in leaf_node_types(cfg):
        nt = np.zeros(M_, np.int64)
        pz = np.zeros((M_, C.MAX_PARAMS))
        nt[0] = t
        pz[0] = _random_leaf_params(rng, t)
        cands.append((nt, pz))
    return optimize_candidates(cands, nz0, data, cfg, tables, infer_noise,
                               pad_to=pad_to)


def greedy_search_extend(nt, pz, nz, aic, data, cfg, tables, rng,
                         infer_noise: bool, verbose=False, pad_to=None
                         ) -> Tuple[Optional[Best], bool]:
    """One extension round (Greedy.jl:416-441): (the batch's best, whether
    it improves on `aic`); (None, False) when there is no candidate."""
    cands = enumerate_next_structures(nt, pz, cfg, rng)
    if verbose:
        print(f"Proposals: {len(cands)}")
    if not cands:
        return None, False
    best = optimize_candidates(cands, nz, data, cfg, tables, infer_noise,
                               pad_to=pad_to)
    return best, best.aic < aic


# ---------------------------------------------------------------------------
# fit_greedy (api.jl:327-378; greedy.py:312-382)
# ---------------------------------------------------------------------------

def _set_single(model, nt, pz, nz, lml):
    """The model's one particle := (nt [M], pz [M, 3], nz, lml), weight
    lml."""
    dev, dt = model.device, model.dtype
    lml_t = torch.as_tensor(lml, dtype=dt, device=dev).reshape(1)
    model.particles = smc.Particles(
        node_type=torch.as_tensor(nt, device=dev).to(torch.int64)[None],
        params=torch.as_tensor(pz, dtype=dt, device=dev)[None],
        noise_z=torch.as_tensor(nz, dtype=dt, device=dev).reshape(1),
        log_weights=lml_t, lml=lml_t.clone(),
        log_ml_est=torch.zeros((), dtype=dt, device=dev),
        parents=torch.zeros((1,), dtype=torch.int64, device=dev))


def _check_single(model, name: str):
    if model.num_particles != 1:
        raise ValueError(f"{name} requires exactly 1 particle.")
    if model.config.changepoints:
        raise ValueError(f"{name} does not support changepoint operators.")


def _clock(model) -> float:
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    return time.time()


def fit_greedy(model, max_depth: Optional[int] = None,
               verbose: bool = False, check: bool = False,
               callback_fn: Optional[Callable] = None):
    """Greedy AIC search over structures up to `max_depth` (api.jl:327-378):
    the best single leaf, then one extension round per depth, each keeping
    the argmin-AIC candidate iff it improves. `callback_fn(model=, step=,
    aic=, elapsed=)` after each stage; one dict per stage (step,
    candidates, probes, accepted) is left in `model.round_stats`."""
    from autogp_tpu_torch import api

    cfg = model.config
    _check_single(model, "fit_greedy")
    max_depth = cfg.depth_cap if max_depth is None else max_depth
    if not (1 <= max_depth <= cfg.depth_cap):
        raise ValueError("fit_greedy requires positive and finite "
                         "max_depth within the static cap.")

    rng = api._GLOBAL["rng"]
    infer_noise = cfg.noise is None
    data = model._dataset()
    tables = model.tables
    if infer_noise:
        nz0 = float(rng.standard_normal())
    else:
        nz0 = float(M.untransform_param("noise", cfg.noise, cfg))

    pad_to = sweep_bucket(cfg, max_depth)
    model.round_stats = []
    t0 = _clock(model)
    best = greedy_search_initialize(data, cfg, tables, rng, nz0, infer_noise,
                                    pad_to=pad_to)
    elapsed = _clock(model) - t0
    nt, pz, nz, lml, aic = (best.node_type, best.params_z, best.noise_z,
                            best.lml, best.aic)

    def stage_done(step, b, accepted):
        _set_single(model, nt, pz, nz, lml)
        model.round_stats.append({
            "step": step, "candidates": 0 if b is None else b.candidates,
            "probes": 0 if b is None else b.probes, "accepted": accepted})
        if check:
            # Greedy.jl:88,102 runs Gen's dynamic checks under check=true;
            # the analog here is trace-integrity validation of the
            # particle plus finiteness of its score.
            smc.validate_particles(model.particles, cfg)
        if callback_fn is not None:
            callback_fn(model=model, step=step, aic=aic, elapsed=elapsed)

    stage_done(1, best, True)
    for depth in range(2, max_depth + 1):
        t0 = _clock(model)
        b, accepted = greedy_search_extend(nt, pz, nz, aic, data, cfg,
                                           tables, rng, infer_noise,
                                           verbose=verbose, pad_to=pad_to)
        elapsed += _clock(model) - t0
        if accepted:
            nt, pz, nz, lml, aic = (b.node_type, b.params_z, b.noise_z,
                                    b.lml, b.aic)
        stage_done(depth, b, accepted)
    return model


# ---------------------------------------------------------------------------
# Hybrid greedy/MCMC rejuvenation (Algorithm 0, Greedy.jl:59-130;
# greedy.py:389-518)
# ---------------------------------------------------------------------------

def propose_subtree_replace(gen, nt, pz, n: int, cfg: C.GPConfig, tables,
                            biased: bool):
    """n independent subtree-replace proposals from the one state nt [M],
    pz [M, 3]: a node picked by the size-weighted walk, its subtree
    resampled from the prior under the changepoint gate. Returns
    (nt2 [n, M], pz2 [n, M, 3])."""
    ntb = nt[None].expand(n, -1).contiguous()
    pzb = pz[None].expand(n, -1, -1).contiguous()
    sizes = T.subtree_sizes(ntb).to(pz.dtype)
    idx, _ = moves.sample_pick_node(gen, ntb, sizes, biased,
                                    tables.depth_cap)
    gate = moves.cp_gate_at(ntb, idx, cfg.changepoints)
    return M.sample_subtree(gen, ntb, pzb, tables, root_idx=idx,
                            root_cp_allowed=gate)


def greedy_mcmc_rejuvenate(nt, pz, nz, aic, lml, proposal, data, cfg,
                           tables, infer_noise: bool):
    """Optimize each proposed structure (nt2 [B, M], pz2 [B, M, 3] from
    the state nt [M], pz [M, 3], nz, aic, lml) for <= MAX_OPT_MCMC rounds
    and accept it iff its AIC improves (Greedy.jl:59-110). Returns, per
    proposal, (nt, pz, nz, aic, lml, accepted): the optimized proposal
    where accepted, the state otherwise. The proposal is explicit, so it
    can be held to the reference's on the same draw."""
    nt2, pz2 = proposal
    B = nt2.shape[0]
    res = map_optimize(nt2, pz2, nz.expand(B).contiguous(), data, cfg,
                       tables, infer_noise, max_rounds=MAX_OPT_MCMC)
    aic2 = compute_aic(res.lml, n_params(nt2, infer_noise))
    acc = aic2 < aic
    return (torch.where(acc[:, None], nt2, nt[None]),
            torch.where(acc[:, None, None], res.params_z, pz[None]),
            torch.where(acc, res.noise_z, nz), torch.where(acc, aic2, aic),
            torch.where(acc, res.lml, lml), acc)


def greedy_mcmc_step(gen, nt, pz, nz, aic, lml, data, cfg, tables,
                     biased: bool, infer_noise: bool, n_parallel: int):
    """One chain step (Greedy.jl:113-124): n_parallel independent
    proposals from the same state, optimized as one batch; the argmin-AIC
    result (the state itself when nothing improves, since rejected
    proposals carry the state's AIC). Returns (nt, pz, nz, aic, lml,
    accepted)."""
    prop = propose_subtree_replace(gen, nt, pz, n_parallel, cfg, tables,
                                   biased)
    nts, pzs, nzs, aics, lmls, accs = greedy_mcmc_rejuvenate(
        nt, pz, nz, aic, lml, prop, data, cfg, tables, infer_noise)
    b = int(torch.argmin(aics))
    return nts[b], pzs[b], nzs[b], aics[b], lmls[b], bool(accs[b])


def fit_greedy_mcmc(model, n_mcmc: int, n_parallel: int = 1,
                    biased: bool = False, verbose: bool = False,
                    check: bool = False,
                    callback_fn: Optional[Callable] = None):
    """Hybrid greedy/MCMC chain ("Algorithm 0", Greedy.jl:59-130): n_mcmc
    steps, each proposing `n_parallel` independent subtree-replace moves
    from the current state, MAP-optimizing each <= 10 rounds and keeping
    the argmin-AIC candidate iff it improves. The AIC is non-increasing
    along the chain by construction. Same constraints as fit_greedy (one
    particle, no changepoint operators); the chain starts from the model's
    particle after the same <= 10-round optimization the proposals get.
    `callback_fn(model=, step=, aic=, accepted=, elapsed=)` after each
    step."""
    from autogp_tpu_torch import api

    cfg = model.config
    _check_single(model, "fit_greedy_mcmc")
    if n_parallel < 1:
        raise ValueError("n_parallel must be >= 1")

    infer_noise = cfg.noise is None
    data = model._dataset()
    tables = model.tables
    p = model.particles
    res = map_optimize(p.node_type[:1], p.params[:1], p.noise_z[:1], data,
                       cfg, tables, infer_noise, max_rounds=MAX_OPT_MCMC)
    nt = p.node_type[0]
    pz, nz, lml = res.params_z[0], res.noise_z[0], res.lml[0]
    aic = compute_aic(lml, n_params(nt, infer_noise))
    _set_single(model, nt, pz, nz, lml)

    elapsed = 0.0
    n_accepted = 0
    for step in range(1, n_mcmc + 1):
        t0 = _clock(model)
        gen = api._next_generator(model.device)
        nt, pz, nz, aic, lml, accepted = greedy_mcmc_step(
            gen, nt, pz, nz, aic, lml, data, cfg, tables, biased,
            infer_noise, n_parallel)
        elapsed += _clock(model) - t0
        n_accepted += accepted
        if accepted:
            _set_single(model, nt, pz, nz, lml)
            if check:
                smc.validate_particles(model.particles, cfg)
        if verbose:
            print(f"greedy-mcmc step {step}: AIC={float(aic):.3f} "
                  f"accepted={accepted}")
        if callback_fn is not None:
            callback_fn(model=model, step=step, aic=float(aic),
                        accepted=accepted, elapsed=elapsed)
    if verbose:
        print(f"greedy-mcmc: {n_accepted}/{n_mcmc} steps accepted")
    return model
