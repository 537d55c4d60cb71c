"""Configuration of the prior over GP kernel structures.

Mirrors `GPConfig` in the reference (GP.jl:1099-1138) with one addition
for fixed shapes: a static tree-depth cap (needed for fixed-shape tensor
traces). The tables and formulas are the JAX package's
(autogp_tpu/config.py), value for value; tests/test_torch_import.py holds
the two copies equal.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

# Integer codes for node types (GP.jl:1101-1108). 0 = inactive slot.
INACTIVE = 0
CONSTANT = 1
LINEAR = 2
SQUARED_EXPONENTIAL = 3
GAMMA_EXPONENTIAL = 4
PERIODIC = 5
PLUS = 6
TIMES = 7
CHANGEPOINT = 8
# WhiteNoise exists in the kernel algebra (GP.jl:131) but is never sampled by
# the prior; it gets code 9 in the tensor encoding.
WHITE_NOISE = 9

NUM_TYPES = 10  # codes 0..9

LEAF_CODES = (CONSTANT, LINEAR, SQUARED_EXPONENTIAL, GAMMA_EXPONENTIAL,
              PERIODIC, WHITE_NOISE)
OP_CODES = (PLUS, TIMES, CHANGEPOINT)

# Maximum number of continuous parameters any node type carries.
MAX_PARAMS = 3

# Number of continuous parameters per node type, in Julia fieldnames order
# (Model.jl:92-96 iterates fieldnames):
#   Constant:(value,) Linear:(intercept,bias,amplitude)
#   SquaredExponential:(lengthscale,amplitude)
#   GammaExponential:(lengthscale,gamma,amplitude)
#   Periodic:(lengthscale,period,amplitude)
#   ChangePoint:(location,)  [scale fixed at .001, Model.jl:121]
#   WhiteNoise:(value,)
PARAM_ARITY = np.array([0, 1, 3, 2, 3, 3, 0, 0, 1, 1], dtype=np.int32)

# Transform kind for each (node_type, param_slot):
#   0 = unused, 1 = wildcard log-normal, 2 = period log-normal,
#   3 = gamma logit-normal  (Model.jl:35-48)
KIND_UNUSED, KIND_WILDCARD, KIND_PERIOD, KIND_GAMMA = 0, 1, 2, 3
PARAM_KIND = np.zeros((NUM_TYPES, MAX_PARAMS), dtype=np.int32)
PARAM_KIND[CONSTANT] = [KIND_WILDCARD, 0, 0]
PARAM_KIND[LINEAR] = [KIND_WILDCARD, KIND_WILDCARD, KIND_WILDCARD]
PARAM_KIND[SQUARED_EXPONENTIAL] = [KIND_WILDCARD, KIND_WILDCARD, 0]
PARAM_KIND[GAMMA_EXPONENTIAL] = [KIND_WILDCARD, KIND_GAMMA, KIND_WILDCARD]
PARAM_KIND[PERIODIC] = [KIND_WILDCARD, KIND_PERIOD, KIND_WILDCARD]
PARAM_KIND[CHANGEPOINT] = [KIND_WILDCARD, 0, 0]   # :location is wildcard
PARAM_KIND[WHITE_NOISE] = [KIND_WILDCARD, 0, 0]

# Fixed ChangePoint squashing scale in the prior (Model.jl:121).
CHANGEPOINT_SCALE = 1e-3

# Observation-noise jitter added after the noise transform (Model.jl:22).
MODEL_JITTER = 1e-5
# Jitter for the sum-GP joint posterior (GP.jl:760).
SUM_GP_JITTER = 1e-8
# float32 deviation: on the f32 path the sum-GP joint gram needs a jitter
# above the single-precision noise floor for its Cholesky pivots to stay
# positive; predictive covariances from infer_gp_sum differ from the
# reference's 1e-8 by up to ~1e-5 absolute on the diagonal there (float64
# matches the reference exactly; see docs/api.md "Numerical deviations").
SUM_GP_JITTER_F32 = 1e-5
# The jitters the port's GP-sum joint tries in turn on float32 blocks, each
# particle keeping the first that factorizes (gp_math.sum_gp_jitters):
# SUM_GP_JITTER up by tens to SUM_GP_JITTER_F32.
SUM_GP_JITTERS_F32 = (1e-8, 1e-7, 1e-6, 1e-5)


def _normalize(x) -> Tuple[float, ...]:
    a = np.asarray(x, dtype=np.float64)
    return tuple(a / a.sum())


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Prior configuration (GP.jl:1099-1138).

    `node_dist_leaf` is over codes 1..5; `node_dist_nocp` over 1..7;
    `node_dist_cp` over 1..8. Defaults disable Constant and
    SquaredExponential exactly as the reference does (GP.jl:1121-1123).

    Fixed-shape addition:
      - `static_max_depth`: static cap on tree depth used for the tensor
        trace when `max_depth == -1` ("unbounded" in the reference). All
        shapes derive from it; the prior forces a leaf at this depth.
        Default 5 clips ~6.1% of the reference's unbounded prior mass
        (6: ~2.9%, 7: ~1.4%; BENCH.md "Pricing the depth cap"). The
        port's kernels take depth caps up to 8 (ops/cov.py MAX_DEPTH).
    """
    node_dist_leaf: Tuple[float, ...] = _normalize([0., 1, 0, 1, 1])
    node_dist_nocp: Tuple[float, ...] = _normalize([0., 6, 0, 6, 6, 5, 5])
    node_dist_cp: Tuple[float, ...] = _normalize([0., 6, 0, 6, 6, 4, 4, 2])
    max_branch: int = 2
    max_depth: int = -1
    changepoints: bool = True
    noise: Optional[float] = None
    prior: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=lambda: {
            "gamma": {"scale": 2.0, "mu": 0.0, "sigma": 1.0},
            "period": {"mu": -1.5, "sigma": 1.0},
            "wildcard": {"mu": -1.5, "sigma": 1.0},
        })
    # --- fixed-shape addition ---
    static_max_depth: int = 5

    def __post_init__(self):
        if self.max_branch != 2:
            raise ValueError("only max_branch=2 is supported")
        if self.max_depth == 0 or self.max_depth < -1:
            raise ValueError("max_depth must be -1 or positive")
        object.__setattr__(self, "node_dist_leaf",
                           _normalize(self.node_dist_leaf))
        object.__setattr__(self, "node_dist_nocp",
                           _normalize(self.node_dist_nocp))
        object.__setattr__(self, "node_dist_cp",
                           _normalize(self.node_dist_cp))
        if self.max_depth == -1:
            # Deviation from the reference (GP.jl:1119 max_depth=-1 is truly
            # unbounded): fixed-shape tensor traces need a static cap, so the
            # prior forces a leaf at depth `static_max_depth`. For the default
            # config the clipped prior mass is ~6.1% at depth 5
            # (tests/test_config.py quantifies it). warnings dedups by
            # call site, so this fires once per process in practice.
            import warnings
            warnings.warn(
                f"max_depth=-1 ('unbounded') is truncated at "
                f"static_max_depth={self.static_max_depth} in the tensor-"
                f"trace encoding: the prior forces a leaf at that depth, "
                f"deviating from the reference's unbounded prior on deeper "
                f"trees. Pass a larger static_max_depth to reduce the "
                f"clipped mass.", UserWarning, stacklevel=3)

    def replace(self, **kw) -> "GPConfig":
        return dataclasses.replace(self, **kw)

    @property
    def cache_key(self) -> tuple:
        """Canonical hashable identity for keying compiled-closure caches.

        `id(config)` is unsafe: a GC'd config's id can be recycled by a
        different config, silently returning functions closed over stale
        tables. Content-keyed caching is exact.
        """
        prior_key = tuple(sorted(
            (k, tuple(sorted(v.items()))) for k, v in self.prior.items()))
        return (self.node_dist_leaf, self.node_dist_nocp, self.node_dist_cp,
                self.max_branch, self.max_depth, self.changepoints,
                self.noise, prior_key, self.static_max_depth)

    @property
    def depth_cap(self) -> int:
        """Static depth bound for the tensor trace."""
        return self.max_depth if self.max_depth > 0 else self.static_max_depth

    @property
    def max_nodes(self) -> int:
        """Number of heap slots in the tensor trace (2^D - 1)."""
        return (1 << self.depth_cap) - 1

    # --- node-distribution tables, padded to length 8 (codes 1..8) ---

    def node_dist_table(self) -> np.ndarray:
        """[3, 8] rows: leaf-only, no-changepoint, changepoint dists."""
        t = np.zeros((3, 8), dtype=np.float64)
        t[0, :len(self.node_dist_leaf)] = self.node_dist_leaf
        t[1, :len(self.node_dist_nocp)] = self.node_dist_nocp
        t[2, :len(self.node_dist_cp)] = self.node_dist_cp
        return t

    def transform_table(self) -> np.ndarray:
        """[4, 3] rows indexed by KIND_*: (mu, sigma, scale)."""
        t = np.zeros((4, 3), dtype=np.float64)
        t[KIND_WILDCARD] = [self.prior["wildcard"]["mu"],
                            self.prior["wildcard"]["sigma"], 0.0]
        t[KIND_PERIOD] = [self.prior["period"]["mu"],
                          self.prior["period"]["sigma"], 0.0]
        t[KIND_GAMMA] = [self.prior["gamma"]["mu"],
                         self.prior["gamma"]["sigma"],
                         self.prior["gamma"]["scale"]]
        return t

    def to_dict(self) -> dict:
        return {
            "node_dist_leaf": list(self.node_dist_leaf),
            "node_dist_nocp": list(self.node_dist_nocp),
            "node_dist_cp": list(self.node_dist_cp),
            "max_branch": self.max_branch,
            "max_depth": self.max_depth,
            "changepoints": self.changepoints,
            "noise": self.noise,
            "prior": self.prior,
            "static_max_depth": self.static_max_depth,
        }

    @staticmethod
    def from_dict(d: dict) -> "GPConfig":
        return GPConfig(**d)


# Heap index arithmetic (0-based). Gen uses 1-based get_child
# (child = (idx-1)*b + i + 1, Model.jl:101); 0-based: children of i are
# 2i+1 and 2i+2.
def left_child(i: int):
    return 2 * i + 1


def right_child(i: int):
    return 2 * i + 2


def parent(i: int):
    return (i - 1) // 2


def depth_of_index(i: int) -> int:
    """1-based depth of a 0-based heap index (GP.jl:1141)."""
    return int(np.floor(np.log2(i + 1))) + 1
