"""Lightweight distribution objects returned by the predict API.

Stand-ins for Distributions.jl's MvNormal / MixtureModel as used by the
reference API (api.jl:497-596, GP.jl:996-1012). Numpy/scipy-based: these
carry results back to the user after the device-side math has run.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
from scipy.stats import norm


@dataclasses.dataclass
class MvNormal:
    mean: np.ndarray   # [n]
    cov: np.ndarray    # [n, n]

    def __post_init__(self):
        self.mean = np.asarray(self.mean, dtype=np.float64)
        self.cov = np.asarray(self.cov, dtype=np.float64)

    @property
    def dim(self) -> int:
        return len(self.mean)

    def var(self) -> np.ndarray:
        return np.diag(self.cov)

    def logpdf(self, x) -> float:
        x = np.asarray(x, dtype=np.float64)
        L = np.linalg.cholesky(self.cov)
        d = x - self.mean
        a = np.linalg.solve(L, d)
        return float(-0.5 * (self.dim * np.log(2 * np.pi)
                             + 2 * np.sum(np.log(np.diag(L)))
                             + a @ a))

    def sample(self, rng=None, size=None):
        rng = np.random.default_rng() if rng is None else rng
        return rng.multivariate_normal(self.mean, self.cov, size=size,
                                       method="cholesky")

    def quantile(self, p):
        """Marginal quantiles (Distributions.quantile at GP.jl:1006-1012).

        p may be a scalar or a list; returns [n] or [n, len(p)].
        """
        std = np.sqrt(np.clip(np.diag(self.cov), 0.0, None))
        if np.isscalar(p):
            return norm.ppf(p, loc=self.mean, scale=std)
        return np.stack([norm.ppf(q, loc=self.mean, scale=std)
                         for q in np.asarray(p)], axis=1)


def mixture_marginal_quantile(weights, means, stds, q: float,
                              tol: float = 1e-5, max_iter: int = 10 ** 6):
    """Inverse marginal mixture-of-normals CDF via the reference's
    bracketed bisection (Statistics.quantile at api.jl:559-596).

    weights [P], means/stds [P, n]. Returns (x [n], success). Only the
    marginal moments enter — this is the O(p)-transfer backend of both
    MixtureMvNormal.quantile and api.predict_quantile.
    """
    weights = np.asarray(weights, dtype=np.float64)
    means = np.asarray(means, dtype=np.float64)
    stds = np.asarray(stds, dtype=np.float64)
    n = means.shape[1]

    def marginal_cdf(x):
        return np.sum(weights[:, None]
                      * norm.cdf(x[None, :], loc=means, scale=stds), axis=0)

    x = np.zeros(n)
    x_max = np.full(n, np.inf)
    x_min = np.full(n, -np.inf)
    success = False
    it = 0
    while it < max_iter:
        eps = marginal_cdf(x) - q
        if np.all(np.abs(eps) < tol):
            success = True
            break
        x_max = np.where(eps > 0, x, x_max)
        x_min = np.where(eps < 0, x, x_min)
        x_hi = np.minimum(x_max, 2.0 ** np.sign(x) * x + (x == 0))
        x_lo = np.maximum(x_min, 2.0 ** (-np.sign(x)) * x - (x == 0))
        x_hi_mid = (x + x_hi) / 2.0
        x_lo_mid = (x + x_lo) / 2.0
        x = np.where(np.abs(eps) < tol, x,
                     np.where(eps < 0, x_hi_mid, x_lo_mid))
        it += 1
    return x, success


@dataclasses.dataclass
class MixtureMvNormal:
    """Particle-weighted mixture of MvNormals (api.jl:497-522)."""
    components: List[MvNormal]
    weights: np.ndarray

    def __post_init__(self):
        self.weights = np.asarray(self.weights, dtype=np.float64)

    @property
    def n_components(self) -> int:
        return len(self.components)

    @property
    def dim(self) -> int:
        return self.components[0].dim

    def mean(self) -> np.ndarray:
        mus = np.stack([c.mean for c in self.components])
        return self.weights @ mus

    def logpdf(self, x) -> float:
        logps = np.array([c.logpdf(x) for c in self.components])
        m = logps.max()
        return float(m + np.log(np.sum(self.weights * np.exp(logps - m))))

    def sample(self, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        i = rng.choice(self.n_components, p=self.weights / self.weights.sum())
        return self.components[i].sample(rng=rng)

    def marginal_cdf(self, x) -> np.ndarray:
        """Per-dimension mixture CDF at x ([n])."""
        x = np.asarray(x, dtype=np.float64)
        out = np.zeros_like(x)
        for w, c in zip(self.weights, self.components):
            std = np.sqrt(np.clip(np.diag(c.cov), 0.0, None))
            out = out + w * norm.cdf(x, loc=c.mean, scale=std)
        return out

    def quantile(self, q: float, tol: float = 1e-5,
                 max_iter: int = 10 ** 6):
        """Inverse marginal mixture CDF via the reference's bracketed
        bisection (Statistics.quantile at api.jl:559-596).

        Returns (x [n], success).
        """
        means = np.stack([c.mean for c in self.components])
        stds = np.stack([np.sqrt(np.clip(np.diag(c.cov), 0.0, None))
                         for c in self.components])
        return mixture_marginal_quantile(self.weights, means, stds, q,
                                         tol=tol, max_iter=max_iter)
