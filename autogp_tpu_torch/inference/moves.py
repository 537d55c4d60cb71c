"""Involutive MCMC structure moves on batched tensor traces.

Port of autogp_tpu/inference/moves.py (reference: src/inference_rejuv_tree_
sr.jl). Subtree-replace picks a node by a size-weighted walk, resimulates
its subtree from the prior (with changepoint gating) and accepts by the
involutive MH ratio alpha = [score' - score] + logq_bwd - logq_fwd.

Every function here acts on the whole particle batch at once ([P, ...]
first) where the JAX package vmapped a per-particle function. Random draws
come from an explicit torch.Generator, through `model.draw` with the
optional `shard` of a particle mesh. Tree walks are fixed-length loops
over the static depth cap with masked updates.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import gp_math
from autogp_tpu_torch import model as M
from autogp_tpu_torch import tree as T
from autogp_tpu_torch.utils import trace


class PickPath(NamedTuple):
    """Record of pick_random_node walks (inference_utils.jl:27-59):
    stop_level [P] (0-based from the walk start) and dirs [P, D] in {0, 1}
    (left/right at each level before the stop)."""
    stop_level: torch.Tensor
    dirs: torch.Tensor


def gather_at(x, idx):
    """x[p, idx[p]] for every particle p."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _walk_probs(node_type, sizes, idx, level, biased, noroot):
    """(p_done, p_left) at the current nodes idx [P] of a pick walk
    (inference_utils.jl:17-24)."""
    Mn = node_type.shape[1]
    t = gather_at(node_type, idx)
    size = gather_at(sizes, idx)
    leaf = gp_math.is_leaf_code(t)
    at_bottom = 2 * idx + 1 >= Mn
    if noroot and level == 0:
        inner = torch.zeros_like(size)
    elif biased:
        inner = torch.full_like(size, 0.5)
    else:
        inner = 1.0 / size
    p_done = torch.where(leaf | at_bottom, torch.ones_like(size), inner)
    size_l = gather_at(sizes, torch.clamp(2 * idx + 1, max=Mn - 1))
    p_left = (torch.full_like(size, 0.5) if biased
              else size_l / torch.clamp(size - 1.0, min=1.0))
    return p_done, p_left


def sample_pick_node(gen, node_type, sizes, biased: bool, depth_cap: int,
                     start_idx=0, noroot: bool = False,
                     shard: Optional[M.Shard] = None):
    """Sample a random node of each (sub)tree rooted at start_idx.

    node_type [P, M]; sizes [P, M] float. Returns (idx [P], PickPath).
    p_done = 1 at leaves; else 0 at the start if noroot; else .5 if biased
    else 1/size(subtree); p_left = .5 if biased else size(left)/(size-1)."""
    P, Mn = node_type.shape
    dev = node_type.device
    u = M.draw(torch.rand, gen, (P, 2 * depth_cap), sizes.dtype, dev, shard)
    idx = M.as_index(start_idx, P, dev).clone()
    done = torch.zeros((P,), dtype=torch.bool, device=dev)
    stop_level = torch.full((P,), depth_cap - 1, dtype=torch.int64,
                            device=dev)
    dirs = torch.zeros((P, depth_cap), dtype=torch.int64, device=dev)
    for level in range(depth_cap):
        p_done, p_left = _walk_probs(node_type, sizes, idx, level, biased,
                                     noroot)
        stop_now = (~done) & (u[:, 2 * level] < p_done)
        stop_level = torch.where(stop_now, level, stop_level)
        done = done | stop_now
        go_left = u[:, 2 * level + 1] < p_left
        dirs[:, level] = torch.where(done, dirs[:, level],
                                     torch.where(go_left, 0, 1))
        new_idx = torch.where(go_left, 2 * idx + 1, 2 * idx + 2)
        idx = torch.where(done, idx, torch.clamp(new_idx, max=Mn - 1))
    return idx, PickPath(stop_level=stop_level, dirs=dirs)


def assess_pick_node(path: PickPath, node_type, sizes, biased: bool,
                     depth_cap: int, start_idx=0, noroot: bool = False):
    """(logq [P], idx [P]): log density of walking `path` on each tree
    (-inf if infeasible), and where the walk ends."""
    P, Mn = node_type.shape
    dev = node_type.device
    idx = M.as_index(start_idx, P, dev).clone()
    logq = torch.zeros((P,), dtype=sizes.dtype, device=dev)
    done = torch.zeros((P,), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=sizes.dtype, device=dev)
    for level in range(depth_cap):
        p_done, p_left = _walk_probs(node_type, sizes, idx, level, biased,
                                     noroot)
        stop_here = path.stop_level == level
        step_lp = torch.where(stop_here, torch.log(p_done),
                              torch.log1p(-p_done))
        go_left = path.dirs[:, level] == 0
        dir_lp = torch.where(stop_here, zero,
                             torch.where(go_left, torch.log(p_left),
                                         torch.log1p(-p_left)))
        logq = logq + torch.where(done, zero, step_lp + dir_lp)
        done = done | stop_here
        new_idx = torch.where(go_left, 2 * idx + 1, 2 * idx + 2)
        idx = torch.where(done, idx, torch.clamp(new_idx, max=Mn - 1))
    return logq, idx


def cp_gate_at(node_type, idx, changepoints: bool):
    """[P] changepoint permission for subtree proposals rooted at idx
    (inference_rejuv_tree_sr.jl:27-39): allowed iff the config permits AND
    (idx is the root OR its parent is a ChangePoint)."""
    parent = torch.clamp((idx - 1) // 2, min=0)
    gate = (idx == 0) | (gather_at(node_type, parent) == C.CHANGEPOINT)
    return gate & changepoints


class MHResult(NamedTuple):
    node_type: torch.Tensor
    params: torch.Tensor
    lml: torch.Tensor
    accepted: torch.Tensor


class MHProposal(NamedTuple):
    """A structure proposal before likelihood scoring: `delta` holds every
    term of the log acceptance ratio except the likelihoods, so the
    umbrella kernel scores ONE selected proposal per step."""
    node_type: torch.Tensor
    params: torch.Tensor
    delta: torch.Tensor


def subtree_replace_propose(gen, node_type, params_z, cfg: C.GPConfig,
                            tables: M.PriorTables, biased: bool = False,
                            shard: Optional[M.Shard] = None) -> MHProposal:
    """Pick a node, resimulate its subtree from the prior
    (inference_rejuv_tree_sr.jl:17-47)."""
    D = tables.depth_cap
    sizes = T.subtree_sizes(node_type).to(params_z.dtype)
    idx, path = sample_pick_node(gen, node_type, sizes, biased, D,
                                 shard=shard)
    logq_pick_fwd, _ = assess_pick_node(path, node_type, sizes, biased, D)
    gate = cp_gate_at(node_type, idx, cfg.changepoints)
    new_type, new_params = M.sample_subtree(gen, node_type, params_z, tables,
                                            root_idx=idx,
                                            root_cp_allowed=gate,
                                            shard=shard)
    # Subtree prior densities appear in both the score delta and the
    # proposal densities; kept explicit to mirror Gen's accounting.
    lp_sub_new = M.tree_prior_logpdf(new_type, new_params, tables,
                                     root_idx=idx, root_cp_allowed=gate)
    lp_sub_old = M.tree_prior_logpdf(node_type, params_z, tables,
                                     root_idx=idx, root_cp_allowed=gate)
    new_sizes = T.subtree_sizes(new_type).to(params_z.dtype)
    logq_pick_bwd, _ = assess_pick_node(path, new_type, new_sizes, biased, D)
    delta = (lp_sub_new - lp_sub_old
             + (logq_pick_bwd + lp_sub_old)
             - (logq_pick_fwd + lp_sub_new))
    return MHProposal(node_type=new_type, params=new_params, delta=delta)


def score_proposal(gen, prop: MHProposal, node_type, params_z, noise_z,
                   lml_cached, data, cfg: C.GPConfig, tables: M.PriorTables,
                   shard: Optional[M.Shard] = None) -> MHResult:
    """Score proposals with ONE batched LML (the only O(N^3) part) and
    apply the involutive-MH accept/reject (moves.py:189-204)."""
    ts, xs, mask = data
    with trace.span("moves.score"):
        lml_new = M.lml(prop.node_type, prop.params, noise_z, ts, xs, mask,
                        cfg, tables)
        log_alpha = (lml_new - lml_cached) + prop.delta
        u = M.draw(torch.rand, gen, lml_new.shape, lml_new.dtype,
                   lml_new.device, shard)
        accept = ((torch.log(u) < log_alpha) & torch.isfinite(lml_new)
                  & torch.isfinite(log_alpha))
        return MHResult(
            node_type=torch.where(accept[:, None], prop.node_type,
                                  node_type),
            params=torch.where(accept[:, None, None], prop.params, params_z),
            lml=torch.where(accept, lml_new, lml_cached),
            accepted=accept)


def subtree_replace_step(gen, node_type, params_z, noise_z, lml_cached,
                         data, cfg: C.GPConfig, tables: M.PriorTables,
                         biased: bool = False,
                         shard: Optional[M.Shard] = None) -> MHResult:
    """One subtree-replace involutive MH step for every particle."""
    with trace.span("moves.propose_sr"):
        prop = subtree_replace_propose(gen, node_type, params_z, cfg, tables,
                                       biased=biased, shard=shard)
    return score_proposal(gen, prop, node_type, params_z, noise_z,
                          lml_cached, data, cfg, tables, shard)


def tree_rejuvenation_step(gen, node_type, params_z, noise_z, lml_cached,
                           data, cfg: C.GPConfig, tables: M.PriorTables,
                           biased: bool = False,
                           shard: Optional[M.Shard] = None) -> MHResult:
    """Umbrella involutive kernel: 50/50 mixture of subtree-replace and
    detach-attach (inference_rejuv_tree.jl:23-55); detach-attach is off
    when the depth cap is 1. Both proposals are computed for the whole
    batch, the coin picks one per particle, and only the picked one is
    scored: one LML per MH step (moves.py:222-251)."""
    from autogp_tpu_torch.inference import moves_da

    with trace.span("moves.mh_step"):
        if tables.depth_cap == 1:
            return subtree_replace_step(gen, node_type, params_z, noise_z,
                                        lml_cached, data, cfg, tables,
                                        biased=biased, shard=shard)
        P = node_type.shape[0]
        use_da = M.draw(torch.rand, gen, (P,), params_z.dtype,
                        params_z.device, shard) < 0.5
        with trace.span("moves.propose_sr"):
            prop_sr = subtree_replace_propose(gen, node_type, params_z, cfg,
                                              tables, biased=biased,
                                              shard=shard)
        with trace.span("moves.propose_da"):
            prop_da = moves_da.detach_attach_propose(
                gen, node_type, params_z, tables, biased=biased, shard=shard)
        prop = MHProposal(
            node_type=torch.where(use_da[:, None], prop_da.node_type,
                                  prop_sr.node_type),
            params=torch.where(use_da[:, None, None], prop_da.params,
                               prop_sr.params),
            delta=torch.where(use_da, prop_da.delta, prop_sr.delta))
        return score_proposal(gen, prop, node_type, params_z, noise_z,
                              lml_cached, data, cfg, tables, shard)
