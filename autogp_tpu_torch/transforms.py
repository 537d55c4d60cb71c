"""Affine and log data transforms (reference: src/Transforms.jl)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LinearTransform:
    """y = slope * x + intercept (Transforms.jl:34-40)."""
    slope: float
    intercept: float

    def apply(self, x):
        return self.slope * np.asarray(x, dtype=np.float64) + self.intercept

    def unapply(self, x):
        return (np.asarray(x, dtype=np.float64) - self.intercept) / self.slope

    def invert(self) -> "LinearTransform":
        return LinearTransform(1.0 / self.slope, -self.intercept / self.slope)

    def unapply_mean(self, mean):
        return self.unapply(mean)

    def unapply_var(self, var):
        return np.asarray(var, dtype=np.float64) / self.slope ** 2

    def unapply_mean_var(self, mean, var):
        return self.unapply_mean(mean), self.unapply_var(var)

    @staticmethod
    def from_minmax(data, lo: float, hi: float) -> "LinearTransform":
        """Map data range onto [lo, hi] (Transforms.jl:55-65)."""
        d = np.asarray(data, dtype=np.float64)
        d = d[~np.isnan(d)]
        if d.size < 2:
            raise ValueError("Cannot scale with <2 values.")
        tmin, tmax = d.min(), d.max()
        slope = (hi - lo) / (tmax - tmin)
        return LinearTransform(slope, -slope * tmin + lo)

    @staticmethod
    def from_mean_width(data, width: float) -> "LinearTransform":
        """Center data at 0 within [-width, width] (Transforms.jl:71-81)."""
        d = np.asarray(data, dtype=np.float64)
        d = d[~np.isnan(d)]
        if d.size < 2:
            raise ValueError("Cannot scale with <2 values.")
        a = d.max() - d.min()
        return LinearTransform(width / a, -(width * d.mean()) / a)

    def to_dict(self):
        return {"slope": float(self.slope), "intercept": float(self.intercept)}

    @staticmethod
    def from_dict(d):
        return LinearTransform(d["slope"], d["intercept"])


@dataclasses.dataclass(frozen=True)
class LogTransform:
    """y = log(x) (Transforms.jl:84-91)."""

    def apply(self, x):
        return np.log(np.asarray(x, dtype=np.float64))

    def unapply(self, x):
        return np.exp(np.asarray(x, dtype=np.float64))

    def unapply_mean_var(self, mean, var):
        mean = np.asarray(mean, dtype=np.float64)
        var = np.asarray(var, dtype=np.float64)
        m = np.exp(mean + var / 2)
        v = (np.exp(var) - 1) * np.exp(2 * mean + var)
        return m, v


def apply_chain(transforms, x):
    for t in transforms:
        x = t.apply(x)
    return x


def unapply_chain(transforms, x):
    for t in reversed(transforms):
        x = t.unapply(x)
    return x
