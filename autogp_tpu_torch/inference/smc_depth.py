"""SMC over tree depth, batched over the particles.

Port of autogp_tpu/inference/smc_depth.py (reference: src/inference_smc_
anneal_depth.jl). Instead of annealing over data prefixes, the ensemble
anneals over the maximum tree depth: each round raises `max_depth`, extends
every particle with an ATTACH proposal (DETACH as the backward kernel),
then resamples and rejuvenates under the deeper config.

Heap slot indices are stable across depths, so a particle is carried to
the larger heap by zero-filling the new slots. The extension is split in
two: `extend_propose` draws the pick path, the hole and the auxiliary
subtree; `extend_weight` scores them deterministically, so the weight can
be held to the JAX package's on the same draws.

One deviation from the reference: its weight uses DETACH as the backward
kernel without normalizing it on the old config's support, which biases
the ensemble towards shallow trees; `extend` divides that mass out
(`detach_support_logprob`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from autogp_tpu_torch import backend
from autogp_tpu_torch import config as C
from autogp_tpu_torch import model as M
from autogp_tpu_torch import tree as T
from autogp_tpu_torch.inference import hmc as hmc_mod
from autogp_tpu_torch.inference import moves, moves_da, smc


def embed_particles(particles: smc.Particles, m_new: int) -> smc.Particles:
    """Grow the heaps from M_old to m_new slots (indices are stable)."""
    P, m_old = particles.node_type.shape
    if m_new == m_old:
        return particles
    if m_new < m_old:
        raise ValueError(f"cannot shrink heaps of {m_old} slots to {m_new}")
    nt = particles.node_type.new_zeros((P, m_new))
    nt[:, :m_old] = particles.node_type
    pz = particles.params.new_zeros((P, m_new, C.MAX_PARAMS))
    pz[:, :m_old] = particles.params
    return particles.replace(node_type=nt, params=pz)


class Extension(NamedTuple):
    """An ATTACH proposal for every particle: the new trees, the picked
    node idx_a [P] and its walk, the hole [P] below it where the old
    subtree(a) now sits, and whether the auxiliary path is forced to
    ChangePoints (subtree(a)'s root is one)."""
    node_type: torch.Tensor
    params: torch.Tensor
    idx_a: torch.Tensor
    path_a: moves.PickPath
    hole: torch.Tensor
    force_cp: torch.Tensor


def extend_propose(gen, node_type, params_z, tables_new: M.PriorTables,
                   biased: bool = False) -> Extension:
    """Draw each particle's depth extension on heaps already embedded in
    the deeper config's (smc_depth.py:54-68): pick a node, draw a path to
    a hole at most as deep as subtree(a) can go, bury subtree(a) at the
    hole and sample the auxiliary material around the path."""
    D = tables_new.depth_cap
    dt = params_z.dtype
    sizes = T.subtree_sizes(node_type).to(dt)
    idx_a, path_a = moves.sample_pick_node(gen, node_type, sizes, biased, D)
    h_att = moves_da.subtree_height(node_type, idx_a, tables_new)
    mda = D - (h_att - 1)
    hole = moves_da.sample_random_path(gen, idx_a, mda, tables_new, D, dt)
    force_cp = moves.gather_at(node_type, idx_a) == C.CHANGEPOINT
    nt_mv, pz_mv = moves_da.move_subtree(node_type, params_z, idx_a, hole,
                                         tables_new)
    nt_new, pz_new = moves_da.sample_aux(gen, nt_mv, pz_mv, idx_a, hole,
                                         force_cp, tables_new)
    return Extension(node_type=nt_new, params=pz_new, idx_a=idx_a,
                     path_a=path_a, hole=hole, force_cp=force_cp)


def extend_weight(node_type, params_z, noise_z, ext: Extension, data,
                  cfg_new: C.GPConfig, tables_new: M.PriorTables,
                  depth_old: int, biased: bool = False):
    """Incremental weight of the extensions `ext` of the embedded old trees
    (smc_depth.py:54-96): the new trace's score under the deeper config
    minus the old trace's under the old one (its prior scored with the
    leaf cap at `depth_old`, both LMLs under cfg_new), plus the backward
    DETACH densities (pick a on the new tree, then the path to the hole)
    minus the forward ATTACH ones (pick a, the random path, the auxiliary
    material). `data` is (ts, xs, mask). Returns (nt_new, pz_new, lml_new
    [P], w [P])."""
    ts, xs, mask = data
    D = tables_new.depth_cap
    dt = params_z.dtype
    nt_new, pz_new = ext.node_type, ext.params
    sizes = T.subtree_sizes(node_type).to(dt)
    lq_pick_a_old, _ = moves.assess_pick_node(ext.path_a, node_type, sizes,
                                              biased, D)
    h_att = moves_da.subtree_height(node_type, ext.idx_a, tables_new)
    mda = D - (h_att - 1)
    lq_path = moves_da.logq_random_path(ext.idx_a, ext.hole, mda,
                                        tables_new, dt)
    lq_aux = moves_da.aux_logpdf(nt_new, pz_new, ext.idx_a, ext.hole,
                                 ext.force_cp, tables_new)

    sizes_new = T.subtree_sizes(nt_new).to(dt)
    lq_pick_a_new, _ = moves.assess_pick_node(ext.path_a, nt_new, sizes_new,
                                              biased, D)
    path_ab = moves_da.path_between(ext.idx_a, ext.hole, tables_new, D)
    lq_pick_b_new, _ = moves.assess_pick_node(path_ab, nt_new, sizes_new,
                                              biased, D, start_idx=ext.idx_a)

    lp_old = M.tree_prior_logpdf(node_type, params_z, tables_new,
                                 leaf_cap=depth_old)
    lp_new = M.tree_prior_logpdf(nt_new, pz_new, tables_new)
    lml_old = M.lml(node_type, params_z, noise_z, ts, xs, mask, cfg_new,
                    tables_new)
    lml_new = M.lml(nt_new, pz_new, noise_z, ts, xs, mask, cfg_new,
                    tables_new)
    w = ((lp_new + lml_new) - (lp_old + lml_old)
         + (lq_pick_a_new + lq_pick_b_new)
         - (lq_pick_a_old + lq_path + lq_aux))
    return nt_new, pz_new, lml_new, w


def detach_support_logprob(node_type, depth_old: int,
                           tables_new: M.PriorTables, biased: bool = False):
    """[P] log probability that the DETACH backward kernel, run on the new
    trees node_type (pick a, pick b in subtree(a), promote subtree(b) to
    a), returns a tree the old config can hold: depth <= depth_old and no
    ChangePoint promoted below a non-ChangePoint.

    The reference's weight (`extend_weight`) takes DETACH's density as the
    backward kernel, but on a new tree DETACH also reaches trees deeper
    than depth_old, where the old target is 0; restricted to the old
    support that kernel sums to this probability, not to 1, so the
    weighted ensemble targets prior x likelihood x this probability
    (compositions are under-weighted: 2/9 of a leaf's mass for a + b at
    depth 2 from depth 1). `extend` divides it out.

    With the walk probabilities of moves.sample_pick_node at every slot,
    reach(s) the probability that a walk from the root passes s and
    pick(s) = reach(s) p_done(s), the pair (a, b) has probability
    p_done(a) pick(b)."""
    P, Mn = node_type.shape
    dev = node_type.device
    dt = tables_new.node_dist.dtype
    D = tables_new.depth_cap
    idx = torch.arange(Mn, device=dev)
    active = node_type > 0
    sizes = T.subtree_sizes(node_type).to(dt)
    walk = [moves._walk_probs(node_type, sizes, M.as_index(s, P, dev), 1,
                              biased, False) for s in range(Mn)]
    p_done = torch.stack([w[0] for w in walk], dim=1)
    p_left = torch.stack([w[1] for w in walk], dim=1)
    reach = torch.zeros_like(sizes)
    reach[:, 0] = 1.0
    height = active.to(torch.int64)
    for lvl in range(1, D):
        s = torch.arange((1 << lvl) - 1, (1 << (lvl + 1)) - 1, device=dev)
        par = (s - 1) // 2
        turn = torch.where(s % 2 == 1, p_left[:, par], 1.0 - p_left[:, par])
        reach[:, s] = reach[:, par] * (1.0 - p_done[:, par]) * turn
    for lvl in reversed(range(D - 1)):
        s = torch.arange((1 << lvl) - 1, (1 << (lvl + 1)) - 1, device=dev)
        below = torch.maximum(height[:, 2 * s + 1], height[:, 2 * s + 2])
        height[:, s] = torch.where(active[:, s], 1 + below, 0)
    pick = reach * p_done
    member = M.subtree_member(idx, tables_new)              # [a, b]
    depths = tables_new.depths
    outside = torch.where(active[:, None, :] & ~member[None],
                          depths[None, None, :], 0).amax(-1)   # [P, a]
    new_depth = torch.maximum(outside[:, :, None],
                              depths[None, :, None] + height[:, None, :] - 1)
    parent_cp = node_type[:, torch.clamp((idx - 1) // 2, min=0)] == \
        C.CHANGEPOINT
    cp_ok = ((node_type[:, None, :] != C.CHANGEPOINT)
             | (idx == 0)[None, :, None] | parent_cp[:, :, None])
    valid = (member[None] & active[:, None, :] & (new_depth <= depth_old)
             & cp_ok)
    zero = torch.zeros((), dtype=dt, device=dev)
    prob = torch.where(valid, p_done[:, :, None] * pick[:, None, :], zero)
    return torch.log(prob.sum(dim=(1, 2)))


def extend(gen, particles: smc.Particles, data: smc.Dataset,
           cfg_new: C.GPConfig, tables_new: M.PriorTables, depth_old: int,
           biased: bool = False) -> smc.Particles:
    """Embed the particles in cfg_new's heap and extend each by one ATTACH
    proposal, its weight added to its log weight: the reference's
    `extend_weight` less `detach_support_logprob` of the new tree (the
    backward kernel normalized on the old config's support). A non-finite
    new LML or weight (a float32 factorization that failed) gives the
    particle log weight -inf and the finite stand-in LML smc.BAD_LML, as
    smc.reweight does."""
    particles = embed_particles(particles, tables_new.max_nodes)
    ext = extend_propose(gen, particles.node_type, particles.params,
                         tables_new, biased)
    nt, pz, lml, w = extend_weight(
        particles.node_type, particles.params, particles.noise_z, ext,
        (data.ts, data.xs, data.mask), cfg_new, tables_new, depth_old,
        biased)
    w = w - detach_support_logprob(nt, depth_old, tables_new, biased)
    ok = torch.isfinite(lml) & torch.isfinite(w)
    return particles.replace(
        node_type=nt, params=pz, lml=torch.where(ok, lml, smc.BAD_LML),
        log_weights=torch.where(ok, particles.log_weights + w,
                                float("-inf")))


def run_smc_anneal_depth(
        gen,
        ts,
        xs,
        schedule: Sequence[int],
        n_particles: int = 50,
        n_mcmc: int = 10,
        n_hmc: int = 10,
        biased: bool = False,
        changepoints: bool = False,
        noise: Optional[float] = None,
        hmc_cfg: hmc_mod.HMCConfig = hmc_mod.HMCConfig(),
        adaptive_resampling: bool = True,
        adaptive_rejuvenation: bool = False,
        verbose: bool = False,
        callback_fn: Optional[Callable] = None,
        *,
        dtype: Optional[torch.dtype] = None,
        device="cuda",
        round_stats: Optional[list] = None):
    """Depth-annealed SMC (smc_anneal_depth.jl:130-229) on (ts, xs) as
    given: initialize under max_depth = schedule[0], then for each depth
    extend (from the second on), resample (not at the last) and
    rejuvenate. `gen` is a torch.Generator on `device` (the card unless
    the caller asks for the CPU); `dtype` defaults to float32 on the card,
    float64 on the CPU. `callback_fn(particles=, depth=, resampled=)` is
    called after each depth. With a list `round_stats`, one dict a depth
    is appended: depth, ess (before resampling), resampled, mh_accepted,
    hmc_sweeps, hmc_accepted (totals; 0 when not rejuvenated). Returns the
    final (particles, config). It takes no particle mesh, as in the JAX
    package: the whole batch runs on `device`."""
    schedule = list(schedule)
    if not (schedule and all(b > a for a, b in zip(schedule, schedule[1:]))):
        raise ValueError("schedule must be a strictly increasing list of "
                         "depths")
    device = backend.resolve_device(device)
    dtype = dtype or (torch.float32 if device.type == "cuda"
                      else torch.float64)
    data = smc.make_dataset(ts, xs, dtype=dtype, device=device)

    def cfg_at(depth):
        return C.GPConfig(max_depth=depth, changepoints=changepoints,
                          noise=noise)

    cfg = cfg_at(schedule[0])
    tables = M.prior_tables(cfg, device, dtype)
    particles = smc.initialize(gen, n_particles, data, cfg, tables)
    threshold = (n_particles / 2 if adaptive_resampling
                 else float(n_particles))

    for depth in schedule:
        if verbose:
            print(f"Running SMC round {depth}/{schedule[-1]}")
        cfg_new = cfg_at(depth)
        tables_new = M.prior_tables(cfg_new, device, dtype)
        if depth != schedule[0]:
            particles = extend(gen, particles, data, cfg_new, tables_new,
                               cfg.max_depth, biased)
        ess = smc.effective_sample_size(particles.log_weights)
        resampled = False
        if depth < schedule[-1]:
            particles, do = smc.maybe_resample(gen, particles, threshold)
            resampled = bool(do)
        counts = {}
        if not adaptive_rejuvenation or resampled:
            particles, *acc, _ = smc.rejuvenate_structure(
                gen, particles, data, cfg_new, tables_new, n_mcmc, n_hmc,
                biased, hmc_cfg=hmc_cfg)
            counts = dict(zip(("mh_accepted", "hmc_sweeps", "hmc_accepted"),
                              acc))
        if round_stats is not None:
            round_stats.append(
                {"depth": depth, "ess": float(ess), "resampled": resampled,
                 **{k: int(counts[k].sum()) if k in counts else 0
                    for k in ("mh_accepted", "hmc_sweeps", "hmc_accepted")}})
        cfg, tables = cfg_new, tables_new
        if callback_fn is not None:
            callback_fn(particles=particles, depth=depth,
                        resampled=resampled)
    return particles, cfg
