"""Symbolic covariance-kernel algebra (reference: src/GP.jl).

These classes are the user-facing, interpretable representation of a GP
covariance kernel: an expression tree over six primitive kernels and three
binary operators. All *inference* runs on the tensor-trace encoding
(autogp_tpu_torch.tree); the symbolic form is used for construction,
serialization, decomposition, and reporting — exactly the role choicemaps
play in the reference.

`eval_cov` here is a float64 numpy evaluator (the oracle used by tests);
the batched torch evaluator lives in autogp_tpu_torch.gp_math.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Type

import numpy as np

from autogp_tpu_torch.transforms import LinearTransform


class Node:
    """Abstract covariance kernel (GP.jl:39)."""

    @property
    def size(self) -> int:
        raise NotImplementedError

    @property
    def depth(self) -> int:
        raise NotImplementedError

    def __add__(self, other: "Node") -> "Plus":
        return Plus(self, other)

    def __mul__(self, other: "Node") -> "Times":
        return Times(self, other)

    def isapprox(self, other: "Node", rtol=1e-9, atol=0.0) -> bool:
        if type(self) is not type(other):
            return False
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if isinstance(a, Node):
                if not a.isapprox(b, rtol=rtol, atol=atol):
                    return False
            else:
                if not np.allclose(a, b, rtol=rtol, atol=atol):
                    return False
        return True

    def __repr__(self):
        return pretty(self)


class LeafNode(Node):
    """Primitive covariance kernel (GP.jl:45)."""

    @property
    def size(self) -> int:
        return 1

    @property
    def depth(self) -> int:
        return 1


class BinaryOpNode(Node):
    """Composite covariance kernel (GP.jl:51)."""

    @property
    def size(self) -> int:
        return 1 + self.left.size + self.right.size

    @property
    def depth(self) -> int:
        return 1 + max(self.left.depth, self.right.depth)


@dataclasses.dataclass(frozen=True, repr=False)
class WhiteNoise(LeafNode):
    """k(t,t') = I[t = t'] * value (GP.jl:131)."""
    value: float


@dataclasses.dataclass(frozen=True, repr=False)
class Constant(LeafNode):
    """k(t,t') = value (GP.jl:157)."""
    value: float


@dataclasses.dataclass(frozen=True, repr=False)
class Linear(LeafNode):
    """k(t,t') = bias + amplitude*(t-intercept)(t'-intercept) (GP.jl:185)."""
    intercept: float
    bias: float = 1.0
    amplitude: float = 1.0


@dataclasses.dataclass(frozen=True, repr=False)
class SquaredExponential(LeafNode):
    """k(t,t') = amplitude * exp(-.5 (t-t')^2 / l^2) (GP.jl:228)."""
    lengthscale: float
    amplitude: float = 1.0


@dataclasses.dataclass(frozen=True, repr=False)
class GammaExponential(LeafNode):
    """k(t,t') = amplitude * exp(-(|t-t'|/l)^gamma), 0<gamma<=2 (GP.jl:269)."""
    lengthscale: float
    gamma: float
    amplitude: float = 1.0

    def __post_init__(self):
        if not (0 < self.gamma <= 2):
            raise ValueError("GammaExponential requires 0 < gamma <= 2")


@dataclasses.dataclass(frozen=True, repr=False)
class Periodic(LeafNode):
    """k(t,t') = amp * exp(-2/l^2 sin^2(pi/period |t-t'|)) (GP.jl:315)."""
    lengthscale: float
    period: float
    amplitude: float = 1.0


@dataclasses.dataclass(frozen=True, repr=False)
class Plus(BinaryOpNode):
    """k = k_left + k_right (GP.jl:358)."""
    left: Node
    right: Node


@dataclasses.dataclass(frozen=True, repr=False)
class Times(BinaryOpNode):
    """k = k_left * k_right (GP.jl:404)."""
    left: Node
    right: Node


@dataclasses.dataclass(frozen=True, repr=False)
class ChangePoint(BinaryOpNode):
    """tanh-sigmoid switch between kernels at `location` (GP.jl:466)."""
    left: Node
    right: Node
    location: float
    scale: float


def sigma_cp(x, location, scale):
    """.5 * (1 + tanh((location - x)/scale)) (GP.jl:481)."""
    return 0.5 * (1.0 + np.tanh((location - x) / scale))


# ---------------------------------------------------------------------------
# eval_cov — float64 numpy oracle (GP.jl:135-503)
# ---------------------------------------------------------------------------

def eval_cov(node: Node, ts1, ts2=None) -> np.ndarray:
    """Covariance matrix of `node` on ts1 x ts2 (ts2 defaults to ts1)."""
    t1 = np.asarray(ts1, dtype=np.float64)
    t2 = t1 if ts2 is None else np.asarray(ts2, dtype=np.float64)
    symmetric = ts2 is None
    K = _eval_cov(node, t1[:, None], t2[None, :])
    if symmetric:
        # GP.jl:502 symmetrizes the ChangePoint matrix; harmless elsewhere.
        K = 0.5 * (K + K.T)
    return K


def _eval_cov(node: Node, t1, t2):
    if isinstance(node, WhiteNoise):
        return (t1 == t2) * node.value
    if isinstance(node, Constant):
        return node.value * np.ones(np.broadcast_shapes(t1.shape, t2.shape))
    if isinstance(node, Linear):
        return node.bias + node.amplitude * (t1 - node.intercept) * (t2 - node.intercept)
    if isinstance(node, SquaredExponential):
        dt = t1 - t2
        return node.amplitude * np.exp(-0.5 * dt * dt / node.lengthscale ** 2)
    if isinstance(node, GammaExponential):
        dt = np.abs(t1 - t2)
        return node.amplitude * np.exp(-(dt / node.lengthscale) ** node.gamma)
    if isinstance(node, Periodic):
        dt = np.abs(t1 - t2)
        freq = math.pi / node.period
        return node.amplitude * np.exp(
            (-2.0 / node.lengthscale ** 2) * np.sin(freq * dt) ** 2)
    if isinstance(node, Plus):
        return _eval_cov(node.left, t1, t2) + _eval_cov(node.right, t1, t2)
    if isinstance(node, Times):
        return _eval_cov(node.left, t1, t2) * _eval_cov(node.right, t1, t2)
    if isinstance(node, ChangePoint):
        s1 = sigma_cp(t1, node.location, node.scale)
        s2 = sigma_cp(t2, node.location, node.scale)
        kl = _eval_cov(node.left, t1, t2)
        kr = _eval_cov(node.right, t1, t2)
        return s1 * kl * s2 + (1 - s1) * kr * (1 - s2)
    raise TypeError(f"Unknown node type: {type(node)}")


def compute_cov_matrix_vectorized(node: Node, noise: float, ts) -> np.ndarray:
    """eval_cov + noise*I (GP.jl:666-668)."""
    ts = np.asarray(ts, dtype=np.float64)
    return eval_cov(node, ts) + noise * np.eye(len(ts))


def compute_cov_matrix(node: Node, noise: float, ts) -> np.ndarray:
    """Non-vectorized compute_cov_matrix (GP.jl:674-684): pairwise scalar
    eval_cov + noise on the diagonal. Matches the reference exactly: the
    scalar path does NOT apply the vectorized path's ChangePoint
    symmetrization (GP.jl:502), so the two can differ at ~1e-16 for
    ChangePoint kernels."""
    ts = np.asarray(ts, dtype=np.float64)
    K = _eval_cov(node, ts[:, None], ts[None, :])
    return K + noise * np.eye(len(ts))


# ---------------------------------------------------------------------------
# reparameterize / rescale (GP.jl:142-517)
# ---------------------------------------------------------------------------

def reparameterize(node: Node, t: LinearTransform) -> Node:
    """Input warping: k(at+b, au+b; th) == k(t, u; th') (GP.jl:64-73)."""
    if isinstance(node, (WhiteNoise, Constant)):
        return node
    if isinstance(node, Linear):
        return Linear((node.intercept - t.intercept) / t.slope,
                      node.bias, t.slope ** 2 * node.amplitude)
    if isinstance(node, SquaredExponential):
        return SquaredExponential(node.lengthscale / abs(t.slope),
                                  node.amplitude)
    if isinstance(node, GammaExponential):
        return GammaExponential(node.lengthscale / abs(t.slope),
                                node.gamma, node.amplitude)
    if isinstance(node, Periodic):
        return Periodic(node.lengthscale, node.period / abs(t.slope),
                        node.amplitude)
    if isinstance(node, Plus):
        return reparameterize(node.left, t) + reparameterize(node.right, t)
    if isinstance(node, Times):
        return reparameterize(node.left, t) * reparameterize(node.right, t)
    if isinstance(node, ChangePoint):
        return ChangePoint(reparameterize(node.left, t),
                           reparameterize(node.right, t),
                           (node.location - t.intercept) / t.slope,
                           node.scale / t.slope)
    raise TypeError(f"Unknown node type: {type(node)}")


def rescale(node: Node, t: LinearTransform) -> Node:
    """Output scaling: Y = aX + b => kernel with params th' (GP.jl:76-85)."""
    s2 = t.slope ** 2
    if isinstance(node, WhiteNoise):
        return WhiteNoise(s2 * node.value)
    if isinstance(node, Constant):
        return Constant(s2 * node.value)
    if isinstance(node, Linear):
        return Linear(node.intercept, s2 * node.bias, s2 * node.amplitude)
    if isinstance(node, SquaredExponential):
        return SquaredExponential(node.lengthscale, s2 * node.amplitude)
    if isinstance(node, GammaExponential):
        return GammaExponential(node.lengthscale, node.gamma,
                                s2 * node.amplitude)
    if isinstance(node, Periodic):
        return Periodic(node.lengthscale, node.period, s2 * node.amplitude)
    if isinstance(node, Plus):
        return rescale(node.left, t) + rescale(node.right, t)
    if isinstance(node, Times):
        # Only rescale one of the two factors (GP.jl:431-436).
        return rescale(node.left, t) * node.right
    if isinstance(node, ChangePoint):
        return ChangePoint(rescale(node.left, t), rescale(node.right, t),
                           node.location, node.scale)
    raise TypeError(f"Unknown node type: {type(node)}")


# ---------------------------------------------------------------------------
# unroll / extract_kernel / split_kernel_sop (GP.jl:106-656)
# ---------------------------------------------------------------------------

def unroll(node: Node) -> List[Node]:
    """Flat list of all intermediate kernels, post-order (GP.jl:111-113)."""
    if isinstance(node, LeafNode):
        return [node]
    return unroll(node.left) + unroll(node.right) + [node]


def extract_kernel(node: Node, leaf_type: Type[LeafNode],
                   retain: bool = True) -> Node:
    """Keep only leaves of `leaf_type` (or the complement) (GP.jl:533-563)."""
    k = _extract_helper(node, leaf_type, retain)
    return Constant(0.0) if k is None else k


def _dummy_operand(node: BinaryOpNode) -> Node:
    if isinstance(node, Times):
        return Constant(1.0)
    return Constant(0.0)  # Plus and ChangePoint (GP.jl:552-554)


def _extract_helper(node: Node, leaf_type, retain: bool) -> Optional[Node]:
    if isinstance(node, LeafNode):
        if (type(node) is leaf_type) == retain:
            return node
        return None
    l = _extract_helper(node.left, leaf_type, retain)
    r = _extract_helper(node.right, leaf_type, retain)
    l = _dummy_operand(node) if l is None else l
    r = _dummy_operand(node) if r is None else r
    if isinstance(node, ChangePoint):
        return ChangePoint(l, r, node.location, node.scale)
    return type(node)(l, r)


def has_leaf(node: Node, leaf_type) -> bool:
    if isinstance(node, LeafNode):
        return type(node) is leaf_type
    return has_leaf(node.left, leaf_type) or has_leaf(node.right, leaf_type)


def split_kernel_sop(node: Node, leaf_type) -> Tuple[Node, Node]:
    """Sum-of-products split by base-kernel type (GP.jl:566-656)."""
    node_a, node_b = _split_sop(node, leaf_type)
    node_a = Constant(0.0) if node_a is None else node_a
    node_b = Constant(0.0) if node_b is None else node_b
    return node_a, node_b


def _merge_plus(a, b):
    if a is None and b is None:
        return None
    if b is None:
        return a
    if a is None:
        return b
    return a + b


def _merge_cp(node: ChangePoint, a, b):
    if a is None and b is None:
        return None
    if b is None:
        return ChangePoint(a, Constant(0.0), node.location, node.scale)
    if a is None:
        return ChangePoint(Constant(0.0), b, node.location, node.scale)
    return ChangePoint(a, b, node.location, node.scale)


def _split_sop(node: Node, leaf_type):
    if isinstance(node, LeafNode):
        if type(node) is leaf_type:
            return node, None
        return None, node
    la, lb = _split_sop(node.left, leaf_type)
    ra, rb = _split_sop(node.right, leaf_type)
    if isinstance(node, Times):
        def mult(a, b):
            return None if (a is None or b is None) else a * b
        terms = [mult(la, ra), mult(la, rb), mult(lb, ra), mult(lb, rb)]
        l_sop = _merge_plus(terms[0], terms[1])
        l_sop = _merge_plus(l_sop, terms[2])
        return l_sop, terms[3]
    if isinstance(node, Plus):
        return _merge_plus(la, ra), _merge_plus(lb, rb)
    if isinstance(node, ChangePoint):
        return _merge_cp(node, la, ra), _merge_cp(node, lb, rb)
    raise TypeError(f"Unknown node type: {type(node)}")


# ---------------------------------------------------------------------------
# pretty printing (GP.jl:1018-1070)
# ---------------------------------------------------------------------------

def pretty(node: Node) -> str:
    if isinstance(node, WhiteNoise):
        return f"WN({node.value:1.2f})"
    if isinstance(node, Constant):
        return f"CONST({node.value:1.2f})"
    if isinstance(node, Linear):
        return (f"LIN({node.intercept:1.2f}; "
                f"{node.bias:1.2f}, {node.amplitude:1.2f})")
    if isinstance(node, SquaredExponential):
        return f"SE({node.lengthscale:1.2f}; {node.amplitude:1.2f})"
    if isinstance(node, GammaExponential):
        return (f"GE({node.lengthscale:1.2f}, {node.gamma:1.2f}; "
                f"{node.amplitude:1.2f})")
    if isinstance(node, Periodic):
        return (f"PER({node.lengthscale:1.2f}, {node.period:1.2f}; "
                f"{node.amplitude:1.2f})")
    if isinstance(node, Plus):
        return f"({pretty(node.left)} + {pretty(node.right)})"
    if isinstance(node, Times):
        return f"({pretty(node.left)} * {pretty(node.right)})"
    if isinstance(node, ChangePoint):
        return (f"CP({pretty(node.left)}, {pretty(node.right)}, "
                f"{node.location:1.2f}, {node.scale:1.2e})")
    raise TypeError(f"Unknown node type: {type(node)}")


def _op_label(node: BinaryOpNode) -> str:
    if isinstance(node, Plus):
        return "+"
    if isinstance(node, Times):
        return "×"
    return f"CP({node.location:1.2f}, {node.scale:1.2e})"


def pretty_tree(node: Node, indent: str = "", last: bool = True,
                first: bool = True) -> str:
    """Multi-line tree rendering (GP.jl:1050-1066)."""
    prefix = "" if first else indent + ("└── " if last
                                        else "├── ")
    if isinstance(node, LeafNode):
        return prefix + pretty(node) + "\n"
    out = prefix + _op_label(node) + "\n"
    child_indent = "" if first else indent + ("    " if last else "│   ")
    out += pretty_tree(node.left, child_indent, last=False, first=False)
    out += pretty_tree(node.right, child_indent, last=True, first=False)
    return out
