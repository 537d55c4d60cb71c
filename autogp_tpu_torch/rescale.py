"""Legacy scaler API (reference: src/Rescale.jl).

Kept for surface parity with the reference, which retains this module even
though the main API uses Transforms.LinearTransform (SURVEY.md §1 notes it
is unused outside its module). Prefer autogp_tpu_torch.transforms.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class Scaler:
    def apply(self, x):
        raise NotImplementedError

    def unapply(self, x):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class LinearScaler(Scaler):
    """Scale data linearly onto [lo, hi] (Rescale.jl:32)."""
    vmin: float
    vmax: float
    lo: float = 0.0
    hi: float = 1.0

    @staticmethod
    def fit(data, lo: float = 0.0, hi: float = 1.0) -> "LinearScaler":
        d = np.asarray(data, dtype=np.float64)
        return LinearScaler(float(d.min()), float(d.max()), lo, hi)

    def apply(self, x):
        x = np.asarray(x, dtype=np.float64)
        return self.lo + (self.hi - self.lo) * (x - self.vmin) \
            / (self.vmax - self.vmin)

    def unapply(self, x):
        x = np.asarray(x, dtype=np.float64)
        return self.vmin + (x - self.lo) * (self.vmax - self.vmin) \
            / (self.hi - self.lo)


@dataclasses.dataclass(frozen=True)
class MeanScaler(Scaler):
    """Center at the mean and scale by the range (Rescale.jl:60)."""
    mean: float
    width: float
    scale: float = 1.0

    @staticmethod
    def fit(data, scale: float = 1.0) -> "MeanScaler":
        d = np.asarray(data, dtype=np.float64)
        return MeanScaler(float(d.mean()), float(d.max() - d.min()), scale)

    def apply(self, x):
        x = np.asarray(x, dtype=np.float64)
        return self.scale * (x - self.mean) / self.width

    def unapply(self, x):
        x = np.asarray(x, dtype=np.float64)
        return self.mean + x * self.width / self.scale
