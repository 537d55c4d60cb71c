"""Detach-attach involutive MCMC move on batched tensor traces.

Port of autogp_tpu/inference/moves_da.py:38-373 (reference: src/
inference_rejuv_tree_da.jl).

  DETACH: pick node `a`, pick node `b` inside subtree(a); promote
    subtree(b) to position `a`, discarding the rest of subtree(a) (the
    reverse proposal's auxiliary tree).
  ATTACH: pick node `a`, draw a random downward path from `a` to a hole
    `b`, sample auxiliary structure around the path (internal path nodes
    are operators; Dirac at ChangePoint when the moved subtree's root is a
    ChangePoint), and bury the current subtree(a) at `b`.

Everything is heap-index arithmetic: a node inside subtree(a) is addressed
by the low bits of (b + 1) below the bits of (a + 1). Indices a, b, hole
are [P] int64 tensors; masks are [P, M].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import gp_math
from autogp_tpu_torch import model as M
from autogp_tpu_torch import tree as T
from autogp_tpu_torch.inference import moves
from autogp_tpu_torch.utils import trace


# ---------------------------------------------------------------------------
# Heap-index geometry
# ---------------------------------------------------------------------------

def ancestor_mask_of(h, tables):
    """[P, M] mask of slots that are ancestors of h [P] (inclusive)."""
    Mn = tables.ancestors.shape[0]
    anc_of_h = tables.ancestors[h]                          # [P, D]
    idx = torch.arange(Mn, device=h.device)
    return (idx[None, :, None] == anc_of_h[:, None, :]).any(dim=-1)


def subtree_height(node_type, root, tables):
    """[P] height of the active subtree rooted at root [P]."""
    mask = M.subtree_member(root, tables) & (node_type > 0)
    maxd = torch.max(torch.where(mask, tables.depths[None, :], 0),
                     dim=-1).values
    return maxd - tables.depths[root] + 1


def remap_index(t, src, dst, tables):
    """Map slots t [M] in subtree(dst [P]) to the corresponding slots under
    src [P]: (t+1) = (dst+1) << k | rem  ->  (src+1) << k | rem - 1.
    Returns (mapped [P, M], valid [P, M])."""
    Mn = tables.ancestors.shape[0]
    k = tables.depths[t][None, :] - tables.depths[dst][:, None]
    ks = torch.clamp(k, min=0)   # shifts only matter where k >= 0
    rem = (t[None, :] + 1) - ((dst[:, None] + 1) << ks)
    mapped = ((src[:, None] + 1) << ks) + rem - 1
    valid = (k >= 0) & (mapped < Mn) & (mapped >= 0)
    return torch.where(valid, mapped, 0), valid


def is_desc_vec(s, r, tables):
    """[P, M] whether slots s [P, M] lie in the subtree of r [P]."""
    return (tables.ancestors[s] == r[:, None, None]).any(dim=-1)


def move_subtree(node_type, params_z, src, dst, tables):
    """Copy the subtree at src [P] to root at dst [P], clearing the rest of
    subtree(dst); slots outside subtree(dst) are kept."""
    Mn = node_type.shape[1]
    idx = torch.arange(Mn, device=node_type.device)
    in_dst = M.subtree_member(dst, tables)
    mapped, valid = remap_index(idx, src, dst, tables)
    take = valid & is_desc_vec(mapped, src, tables)
    gathered_nt = torch.where(take, torch.gather(node_type, 1, mapped), 0)
    gathered_pz = torch.where(
        take[..., None],
        torch.gather(params_z, 1, mapped[..., None].expand(-1, -1, 3)), 0.0)
    new_nt = torch.where(in_dst, gathered_nt.to(node_type.dtype), node_type)
    new_pz = torch.where(in_dst[..., None], gathered_pz, params_z)
    return new_nt, new_pz


def path_between(a, b, tables, depth_cap: int) -> moves.PickPath:
    """PickPath from a [P] down to its descendant b [P]: stop_level =
    depth(b) - depth(a), dirs from the binary digits of (b + 1)."""
    L = tables.depths[b] - tables.depths[a]
    rem = (b + 1) - ((a + 1) << L)
    levels = torch.arange(depth_cap, device=a.device)
    shift = torch.clamp(L[:, None] - 1 - levels[None, :], min=0)
    dirs = torch.where(levels[None, :] < L[:, None],
                       (rem[:, None] >> shift) & 1, 0)
    return moves.PickPath(stop_level=L, dirs=dirs)


# ---------------------------------------------------------------------------
# generate_random_path (inference_utils.jl:62-89)
# ---------------------------------------------------------------------------

def sample_random_path(gen, a, max_depth_aux, tables, depth_cap: int,
                       dtype, noroot: bool = False,
                       shard: Optional[M.Shard] = None):
    """Random downward paths from a [P]: p_done = .5 per level, forced stop
    at depth == max_depth_aux [P], forced continue at the root if noroot.
    Returns the hole indices [P]."""
    P = a.shape[0]
    u = M.draw(torch.rand, gen, (P, 2 * depth_cap), dtype, a.device, shard)
    idx = a.clone()
    done = torch.zeros((P,), dtype=torch.bool, device=a.device)
    Mn = tables.ancestors.shape[0]
    for level in range(depth_cap):
        depth = tables.depths[idx]
        inner = 0.0 if (noroot and level == 0) else 0.5
        p_done = torch.where(depth == max_depth_aux, 1.0, inner)
        stop_now = (~done) & (u[:, 2 * level] < p_done)
        done = done | stop_now
        go_left = u[:, 2 * level + 1] < 0.5
        nxt = torch.where(go_left, 2 * idx + 1, 2 * idx + 2)
        idx = torch.where(done, idx, torch.clamp(nxt, max=Mn - 1))
    return idx


def logq_random_path(a, hole, max_depth_aux, tables, dtype,
                     noroot: bool = False):
    """[P] density of generate_random_path choosing `hole` from `a`."""
    L = (tables.depths[hole] - tables.depths[a]).to(dtype)
    # A host-to-device copy waits for the device's queue.
    with trace.sync("moves.log_half"):
        log_half = torch.tensor(np.log(0.5), dtype=dtype, device=a.device)
    zero = torch.zeros((), dtype=dtype, device=a.device)
    cont_lp = L * log_half
    if noroot:
        cont_lp = cont_lp - torch.where(L > 0, log_half, zero)
    dir_lp = L * log_half
    stop_forced = tables.depths[hole] == max_depth_aux
    stop_lp = torch.where(stop_forced, zero, log_half)
    lp = cont_lp + dir_lp + stop_lp
    if noroot:
        lp = torch.where(L == 0, float("-inf"), lp)
    return lp


# ---------------------------------------------------------------------------
# Auxiliary-tree proposal (covariance_proposal_attach_detach, da.jl:17-87)
# ---------------------------------------------------------------------------

def _aux_log_dist(s_depth, cp_allowed, on_path, force_cp, tables):
    """[..., 8] log node-type distribution per aux-proposal slot: off-path
    slots use the model prior row; internal path slots are restricted to
    operators (renormalised), or Dirac at ChangePoint when force_cp [P]."""
    row = torch.where(s_depth == tables.depth_cap, 0,
                      torch.where(cp_allowed, 2, 1))
    dist = tables.node_dist[row]                            # [P, W, 8]
    codes = torch.arange(1, 9, device=dist.device)          # columns' codes
    ops_only = torch.where(codes >= C.PLUS, dist, 0.0)
    ops_only = ops_only / torch.clamp(ops_only.sum(-1, keepdim=True),
                                      min=1e-300)
    dirac_cp = (codes == C.CHANGEPOINT).to(dist.dtype)
    path_dist = torch.where(force_cp[:, None, None], dirac_cp, ops_only)
    out = torch.where(on_path[..., None], path_dist, dist)
    return (torch.log(torch.clamp(out, min=1e-300))
            + torch.where(out > 0, 0.0, float("-inf")))


def _aux_cp_allowed(parent_t, is_a, tables):
    return torch.where(is_a, tables.changepoints,
                       parent_t == C.CHANGEPOINT)


def aux_logpdf(node_type, params_z, a, hole, force_cp, tables):
    """[P] log density of the auxiliary material of node_type -- the slots
    in subtree(a) excluding subtree(hole) -- under the attach proposal."""
    P, Mn = node_type.shape
    dev = node_type.device
    member = M.subtree_member(a, tables) & ~M.subtree_member(hole, tables)
    on_path = ancestor_mask_of(hole, tables) & member
    active = (node_type > 0) & member
    parent_idx = torch.clamp((torch.arange(Mn, device=dev) - 1) // 2, min=0)
    parent_type = node_type[:, parent_idx]
    is_a = torch.arange(Mn, device=dev)[None, :] == a[:, None]
    cp_allowed = _aux_cp_allowed(parent_type, is_a, tables)
    log_dist = _aux_log_dist(tables.depths[None, :], cp_allowed, on_path,
                             force_cp, tables)              # [P, M, 8]
    code_idx = torch.clamp(node_type - 1, 0, 7)
    lp_type = torch.gather(log_dist, 2, code_idx[..., None])[..., 0]
    slot_mask = M.param_slot_mask(node_type, tables)
    zero = torch.zeros((), dtype=params_z.dtype, device=dev)
    lp_params = torch.sum(torch.where(slot_mask, M.normal_logpdf(params_z),
                                      zero), dim=-1)
    return gp_math.row_sum(torch.where(active, lp_type + lp_params, zero))


def sample_aux(gen, node_type, params_z, a, hole, force_cp, tables,
               shard: Optional[M.Shard] = None):
    """Sample auxiliary structure for the slots in subtree(a) excluding
    subtree(hole); other slots are untouched. Level by level, like
    model.sample_subtree."""
    P, Mn = node_type.shape
    D = tables.depth_cap
    dev, dt = params_z.device, params_z.dtype
    member_all = (M.subtree_member(a, tables)
                  & ~M.subtree_member(hole, tables))
    on_path_all = ancestor_mask_of(hole, tables) & member_all
    g = M.gumbel(gen, (P, Mn, 8), dt, dev, shard)
    z_all = M.draw(torch.randn, gen, (P, Mn, C.MAX_PARAMS), dt, dev, shard)
    new_type = node_type.clone()
    new_params = params_z.clone()
    for lvl in range(D):
        lo, hi = (1 << lvl) - 1, (1 << (lvl + 1)) - 1
        member = member_all[:, lo:hi]
        on_path = on_path_all[:, lo:hi]
        if lvl == 0:
            parent_t = torch.zeros((P, 1), dtype=node_type.dtype, device=dev)
        else:
            plo = (1 << (lvl - 1)) - 1
            parent_t = torch.repeat_interleave(new_type[:, plo:lo], 2, dim=1)
        is_a = torch.arange(lo, hi, device=dev)[None, :] == a[:, None]
        # Active: a itself, or a child of an operator parent.
        active = member & (is_a | M.is_op_parent(parent_t))
        cp_allowed = _aux_cp_allowed(parent_t, is_a, tables)
        logits = _aux_log_dist(tables.depths[None, lo:hi], cp_allowed,
                               on_path, force_cp, tables)
        t = (torch.argmax(logits + g[:, lo:hi], dim=-1) + 1).to(
            node_type.dtype)
        z = torch.where(M.param_slot_mask(t, tables), z_all[:, lo:hi], 0.0)
        t = torch.where(active, t, 0)
        z = torch.where(active[..., None], z, 0.0)
        new_type[:, lo:hi] = torch.where(member, t, new_type[:, lo:hi])
        new_params[:, lo:hi] = torch.where(member[..., None], z,
                                           new_params[:, lo:hi])
    return new_type, new_params


# ---------------------------------------------------------------------------
# The move
# ---------------------------------------------------------------------------

def _log_pos(p):
    """log(max(p, 1e-300)) as in the reference's guarded log."""
    return torch.log(torch.clamp(p, min=1e-300))


def detach_attach_propose(gen, node_type, params_z, tables: M.PriorTables,
                          biased: bool = False,
                          shard: Optional[M.Shard] = None
                          ) -> moves.MHProposal:
    """Detach-attach proposals for every particle.

    DETACH with p = .5 (0 for singleton trees), else ATTACH; the returned
    delta carries the whole involutive ratio except the likelihoods: tree
    prior change, auxiliary-tree and path densities (da.jl:90-281)."""
    D = tables.depth_cap
    dt = params_z.dtype
    P = node_type.shape[0]
    dev = node_type.device

    sizes = T.subtree_sizes(node_type).to(dt)
    p_detach = torch.where(sizes[:, 0] == 1, 0.0, 0.5).to(dt)
    do_detach = M.draw(torch.rand, gen, (P,), dt, dev, shard) < p_detach

    # Both branches share pick_node_a.
    idx_a, path_a = moves.sample_pick_node(gen, node_type, sizes, biased, D,
                                           shard=shard)
    lq_pick_a_old, _ = moves.assess_pick_node(path_a, node_type, sizes,
                                              biased, D)

    # ----- DETACH branch ---------------------------------------------------
    idx_b_det, path_b = moves.sample_pick_node(gen, node_type, sizes, biased,
                                               D, start_idx=idx_a,
                                               shard=shard)
    lq_pick_b_old, _ = moves.assess_pick_node(path_b, node_type, sizes,
                                              biased, D, start_idx=idx_a)
    nt_det, pz_det = move_subtree(node_type, params_z, idx_b_det, idx_a,
                                  tables)
    sizes_det = T.subtree_sizes(nt_det).to(dt)
    lq_pick_a_det, _ = moves.assess_pick_node(path_a, nt_det, sizes_det,
                                              biased, D)
    h_det = subtree_height(nt_det, idx_a, tables)
    mda_det = D - (h_det - 1)
    lq_path_det = logq_random_path(idx_a, idx_b_det, mda_det, tables, dt)
    force_cp_det = moves.gather_at(nt_det, idx_a) == C.CHANGEPOINT
    lq_aux_det = aux_logpdf(node_type, params_z, idx_a, idx_b_det,
                            force_cp_det, tables)
    p_detach_det = torch.where(sizes_det[:, 0] == 1, 0.0, 0.5).to(dt)
    lq_fwd_det = _log_pos(p_detach) + lq_pick_a_old + lq_pick_b_old
    lq_bwd_det = (torch.log1p(-p_detach_det) + lq_pick_a_det + lq_path_det
                  + lq_aux_det)

    # ----- ATTACH branch ---------------------------------------------------
    h_att = subtree_height(node_type, idx_a, tables)
    mda_att = D - (h_att - 1)
    hole = sample_random_path(gen, idx_a, mda_att, tables, D, dt,
                              shard=shard)
    lq_path_att = logq_random_path(idx_a, hole, mda_att, tables, dt)
    force_cp_att = moves.gather_at(node_type, idx_a) == C.CHANGEPOINT
    # Move subtree(a) down to the hole; sample_aux then overwrites exactly
    # the stale slots of subtree(a) \ subtree(hole).
    nt_mv, pz_mv = move_subtree(node_type, params_z, idx_a, hole, tables)
    nt_att, pz_att = sample_aux(gen, nt_mv, pz_mv, idx_a, hole,
                                force_cp_att, tables, shard)
    lq_aux_att = aux_logpdf(nt_att, pz_att, idx_a, hole, force_cp_att,
                            tables)
    sizes_att = T.subtree_sizes(nt_att).to(dt)
    lq_pick_a_att, _ = moves.assess_pick_node(path_a, nt_att, sizes_att,
                                              biased, D)
    path_ab = path_between(idx_a, hole, tables, D)
    lq_pick_b_att, _ = moves.assess_pick_node(path_ab, nt_att, sizes_att,
                                              biased, D, start_idx=idx_a)
    p_detach_att = torch.where(sizes_att[:, 0] == 1, 0.0, 0.5).to(dt)
    lq_fwd_att = (torch.log1p(-p_detach) + lq_pick_a_old + lq_path_att
                  + lq_aux_att)
    lq_bwd_att = (_log_pos(p_detach_att)
                  + torch.where(p_detach_att > 0, 0.0, float("-inf"))
                  + lq_pick_a_att + lq_pick_b_att)

    # ----- select branch, assemble proposal ---------------------------------
    nt_new = torch.where(do_detach[:, None], nt_det, nt_att)
    pz_new = torch.where(do_detach[:, None, None], pz_det, pz_att)
    lq_fwd = torch.where(do_detach, lq_fwd_det, lq_fwd_att)
    lq_bwd = torch.where(do_detach, lq_bwd_det, lq_bwd_att)
    lp_tree_old = M.tree_prior_logpdf(node_type, params_z, tables)
    lp_tree_new = M.tree_prior_logpdf(nt_new, pz_new, tables)
    delta = (lp_tree_new - lp_tree_old) + lq_bwd - lq_fwd
    return moves.MHProposal(node_type=nt_new, params=pz_new, delta=delta)
