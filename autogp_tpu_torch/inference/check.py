"""Involution round-trip checks and trace validity, batched.

Port of autogp_tpu/inference/check.py (the reference's `check=true`
analog, Gen.check_round_trip at inference_smc_anneal_depth.jl:59-87): each
structure move is applied with freshly sampled choices, then reversed from
the recorded choices, and the original trace must come back exactly.

  - subtree-replace: writing the original subtree back at the picked index
    restores the trace, and the recorded pick path reaches the same index
    with finite density on the proposed tree;
  - detach(a, b): re-burying the promoted subtree at b and restoring the
    auxiliary material restores the trace;
  - attach(a, hole): promoting subtree(hole) back to a restores the trace
    (so sample_aux never touches subtree(hole)).
"""

from __future__ import annotations

from typing import Optional

import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import gp_math
from autogp_tpu_torch import model as M
from autogp_tpu_torch import tree as T
from autogp_tpu_torch.inference import moves, moves_da


def _states_equal(nt_a, pz_a, nt_b, pz_b):
    return (nt_a == nt_b).all(dim=1) & (pz_a == pz_b).all(dim=2).all(dim=1)


def subtree_replace_roundtrip(gen, node_type, params_z, tables,
                              changepoints: bool = True,
                              biased: bool = False,
                              shard: Optional[M.Shard] = None):
    """[P] bool: subtree-replace then reverse from recorded choices."""
    D = tables.depth_cap
    sizes = T.subtree_sizes(node_type).to(params_z.dtype)
    idx, path = moves.sample_pick_node(gen, node_type, sizes, biased, D,
                                       shard=shard)
    gate = moves.cp_gate_at(node_type, idx, changepoints)
    new_type, new_params = M.sample_subtree(gen, node_type, params_z, tables,
                                            root_idx=idx,
                                            root_cp_allowed=gate,
                                            shard=shard)
    member = M.subtree_member(idx, tables)
    nt_rt = torch.where(member, node_type, new_type)
    pz_rt = torch.where(member[..., None], params_z, new_params)
    ok_state = _states_equal(nt_rt, pz_rt, node_type, params_z)
    new_sizes = T.subtree_sizes(new_type).to(params_z.dtype)
    lq_bwd, idx_bwd = moves.assess_pick_node(path, new_type, new_sizes,
                                             biased, D)
    return ok_state & (idx_bwd == idx) & torch.isfinite(lq_bwd)


def detach_roundtrip(gen, node_type, params_z, tables, biased: bool = False,
                     shard: Optional[M.Shard] = None):
    """[P] bool: detach(a, b) then the reverse attach."""
    D = tables.depth_cap
    sizes = T.subtree_sizes(node_type).to(params_z.dtype)
    idx_a, _ = moves.sample_pick_node(gen, node_type, sizes, biased, D,
                                      shard=shard)
    idx_b, _ = moves.sample_pick_node(gen, node_type, sizes, biased, D,
                                      start_idx=idx_a, shard=shard)
    nt_det, pz_det = moves_da.move_subtree(node_type, params_z, idx_b, idx_a,
                                           tables)
    nt_mv, pz_mv = moves_da.move_subtree(nt_det, pz_det, idx_a, idx_b,
                                         tables)
    member = (M.subtree_member(idx_a, tables)
              & ~M.subtree_member(idx_b, tables))
    nt_rt = torch.where(member, node_type, nt_mv)
    pz_rt = torch.where(member[..., None], params_z, pz_mv)
    return _states_equal(nt_rt, pz_rt, node_type, params_z)


def attach_roundtrip(gen, node_type, params_z, tables,
                     changepoints: bool = True, biased: bool = False,
                     shard: Optional[M.Shard] = None):
    """[P] bool: attach(a, hole) then the reverse detach(a, b=hole)."""
    D = tables.depth_cap
    sizes = T.subtree_sizes(node_type).to(params_z.dtype)
    idx_a, _ = moves.sample_pick_node(gen, node_type, sizes, biased, D,
                                      shard=shard)
    h = moves_da.subtree_height(node_type, idx_a, tables)
    hole = moves_da.sample_random_path(gen, idx_a, D - (h - 1), tables, D,
                                       params_z.dtype, shard=shard)
    force_cp = moves.gather_at(node_type, idx_a) == C.CHANGEPOINT
    nt_mv, pz_mv = moves_da.move_subtree(node_type, params_z, idx_a, hole,
                                         tables)
    nt_att, pz_att = moves_da.sample_aux(gen, nt_mv, pz_mv, idx_a, hole,
                                         force_cp, tables, shard)
    nt_rt, pz_rt = moves_da.move_subtree(nt_att, pz_att, hole, idx_a, tables)
    return _states_equal(nt_rt, pz_rt, node_type, params_z)


def roundtrip_all(gen, node_type, params_z, tables,
                  changepoints: bool = True, biased: bool = False,
                  shard: Optional[M.Shard] = None):
    """[P, 3] bool: (subtree_replace, detach, attach) round trips."""
    return torch.stack([
        subtree_replace_roundtrip(gen, node_type, params_z, tables,
                                  changepoints, biased, shard),
        detach_roundtrip(gen, node_type, params_z, tables, biased, shard),
        attach_roundtrip(gen, node_type, params_z, tables, changepoints,
                         biased, shard)], dim=1)


def trace_structurally_valid(node_type, changepoints: bool = True):
    """[P] bool heap-invariant check: root active with a known code; every
    non-root slot active exactly when its parent is an operator; active
    slots hold known codes; ChangePoint only when permitted, at the root
    or directly below another ChangePoint (GP.jl:1099-1138)."""
    P, Mn = node_type.shape
    t = node_type
    known = gp_math.is_leaf_code(t) | gp_math.is_op_code(t)
    s = torch.arange(Mn, device=t.device)
    par = torch.clamp((s - 1) // 2, min=0)
    parent_is_op = gp_math.is_op_code(t[:, par])
    active = t > 0
    ok = known[:, 0] & active[:, 0]
    ok &= ((active[:, 1:] == parent_is_op[:, 1:])
           & (known[:, 1:] | ~active[:, 1:])).all(dim=1)
    is_cp = t == C.CHANGEPOINT
    cp_ok = (~is_cp) | (((s == 0)[None, :] | (t[:, par] == C.CHANGEPOINT))
                        & changepoints)
    return ok & cp_ok.all(dim=1)
