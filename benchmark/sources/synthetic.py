"""A weekly series: trend * t + sum_k a_k sin(2 pi t / p_k) + noise * eps,
t = 0 .. n - 1, eps standard normal from the seed."""

import numpy as np


def series(spec: dict, seed: int):
    n = int(spec["n"])
    t = np.arange(n, dtype=np.float64)
    y = spec["trend"] * t
    for a, p in zip(spec["amplitudes"], spec["periods"]):
        y = y + a * np.sin(2 * np.pi * t / p)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    return t, y + spec["noise"] * rng.standard_normal(n)
