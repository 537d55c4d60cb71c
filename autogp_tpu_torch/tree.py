"""Tensor-trace encoding of kernel expression trees.

Port of autogp_tpu/tree.py: the heap is node_type [M] int, params_z [M, 3]
whitened (inference_utils.jl:206-246). `node_to_tensor` and
`tensor_to_node` work on numpy arrays of one tree; the structure utilities
work on batched torch tensors, particle axis first.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import gp_math
from autogp_tpu_torch import kernels as K
from autogp_tpu_torch import model as M_
from autogp_tpu_torch.utils import trace

# Field names per node type, in Julia fieldnames order (Model.jl:92).
NODE_FIELDS = {
    C.CONSTANT: ("value",),
    C.LINEAR: ("intercept", "bias", "amplitude"),
    C.SQUARED_EXPONENTIAL: ("lengthscale", "amplitude"),
    C.GAMMA_EXPONENTIAL: ("lengthscale", "gamma", "amplitude"),
    C.PERIODIC: ("lengthscale", "period", "amplitude"),
    C.CHANGEPOINT: ("location",),
    C.WHITE_NOISE: ("value",),
}

NODE_CLASS = {
    C.CONSTANT: K.Constant,
    C.LINEAR: K.Linear,
    C.SQUARED_EXPONENTIAL: K.SquaredExponential,
    C.GAMMA_EXPONENTIAL: K.GammaExponential,
    C.PERIODIC: K.Periodic,
    C.PLUS: K.Plus,
    C.TIMES: K.Times,
    C.CHANGEPOINT: K.ChangePoint,
    C.WHITE_NOISE: K.WhiteNoise,
}

CLASS_CODE = {v: k for k, v in NODE_CLASS.items()}


def node_code(node: K.Node) -> int:
    """Integer node-type code of a symbolic node."""
    return CLASS_CODE[type(node)]


def _kind(field: str) -> str:
    return field if field in ("gamma", "period") else "wildcard"


def node_to_tensor(node: K.Node, config: C.GPConfig
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a symbolic kernel into (node_type [M] int64, params_z
    [M, 3] float64), parameters untransformed to whitened space. Raises if
    the tree exceeds the static depth cap (autogp_tpu/tree.py:54-82)."""
    Mn = config.max_nodes
    node_type = np.zeros((Mn,), dtype=np.int64)
    params_z = np.zeros((Mn, C.MAX_PARAMS), dtype=np.float64)

    def rec(n: K.Node, idx: int):
        if idx >= Mn:
            raise ValueError(
                f"kernel tree depth exceeds static cap {config.depth_cap}")
        code = CLASS_CODE[type(n)]
        node_type[idx] = code
        if isinstance(n, (K.LeafNode, K.ChangePoint)):
            for j, f in enumerate(NODE_FIELDS[code]):
                params_z[idx, j] = M_.untransform_param(
                    _kind(f), getattr(n, f), config)
        if isinstance(n, K.BinaryOpNode):
            rec(n.left, 2 * idx + 1)
            rec(n.right, 2 * idx + 2)

    rec(node, 0)
    return node_type, params_z


def tensor_to_node(node_type, params_z, config: C.GPConfig) -> K.Node:
    """Decode one tensor trace (numpy) back into a symbolic kernel."""
    node_type = np.asarray(node_type)
    params_z = np.asarray(params_z, dtype=np.float64)

    def rec(idx: int) -> K.Node:
        code = int(node_type[idx])
        if code == C.INACTIVE:
            raise ValueError(f"inactive slot {idx} reached during decode")
        if code in (C.PLUS, C.TIMES):
            return NODE_CLASS[code](rec(2 * idx + 1), rec(2 * idx + 2))
        if code == C.CHANGEPOINT:
            loc = float(M_.transform_param("wildcard", params_z[idx, 0],
                                           config))
            return K.ChangePoint(rec(2 * idx + 1), rec(2 * idx + 2), loc,
                                 C.CHANGEPOINT_SCALE)
        vals = [float(M_.transform_param(_kind(f), params_z[idx, j], config))
                for j, f in enumerate(NODE_FIELDS[code])]
        return NODE_CLASS[code](*vals)

    return rec(0)


# ---------------------------------------------------------------------------
# Structure utilities on batched encodings (autogp_tpu/tree.py:116-151)
# ---------------------------------------------------------------------------

def subtree_sizes(node_type):
    """[P, M] number of active nodes in the subtree rooted at each slot
    (Base.size at GP.jl:93-95), accumulated level by level from the
    bottom: the children of level [lo, hi) are the next level, in pairs."""
    P, Mn = node_type.shape
    active = (node_type > 0).to(torch.int64)
    D = Mn.bit_length()
    levels = [None] * D
    for lvl in reversed(range(D)):
        lo, hi = (1 << lvl) - 1, (1 << (lvl + 1)) - 1
        s = active[:, lo:hi]
        if lvl + 1 < D:
            s = s * (1 + levels[lvl + 1].view(P, hi - lo, 2).sum(dim=-1))
        levels[lvl] = s
    return torch.cat(levels, dim=1)


def tree_depth(node_type):
    """[P] depth (1-based) of each active tree."""
    # A host-to-device copy waits for the device's queue.
    with trace.sync("tree.depths"):
        depths = torch.as_tensor(
            gp_math.slot_depths(node_type.shape[-1].bit_length()),
            device=node_type.device)
    return torch.max(torch.where(node_type > 0, depths, 0), dim=-1).values


def num_active_params(node_type):
    """[...] number of active continuous tree parameters of each heap
    node_type [..., M] (the HMC dimension; autogp_tpu/tree.py:141)."""
    with trace.sync("tree.arity"):
        ar = torch.as_tensor(C.PARAM_ARITY, device=node_type.device)
    return ar[node_type].sum(dim=-1)


def param_mask(node_type):
    """[..., M, 3] {0,1} mask of active continuous parameter slots."""
    # A host-to-device copy waits for the device's queue.
    with trace.sync("tree.arity"):
        ar = torch.as_tensor(C.PARAM_ARITY,
                             device=node_type.device)[node_type]
    return (torch.arange(C.MAX_PARAMS, device=node_type.device)
            < ar[..., None]).to(torch.float32)
