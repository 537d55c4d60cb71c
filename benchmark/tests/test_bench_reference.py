"""The plain reference against the port's float64 path on the CPU, on
small trees of every kind the prior draws (the reference itself never
calls the port)."""

import math

import numpy as np
import pytest
import torch

from benchmark import check, workload as W
from benchmark.reference import gp as ref

CONFIG = W.load_json(W.ROOT / "configs" / "config4.json")


@pytest.fixture(scope="module")
def port():
    import autogp_tpu_torch as A
    from autogp_tpu_torch import model as M
    cfg = A.GPConfig(changepoints=True, max_depth=5, prior=CONFIG["prior"])
    tables = M.prior_tables(cfg, "cpu", torch.float64)
    return A, M, cfg, tables


def draw(port, P, seed):
    A, M, cfg, tables = port
    gen = torch.Generator().manual_seed(seed)
    nt, pz = M.sample_tree(gen, P, tables, torch.float64, "cpu")
    nz = torch.randn(P, generator=gen, dtype=torch.float64)
    return nt, pz, nz


def data(n, seed=0):
    t, y = W.series({"n": n, "trend": 0.02, "periods": [52, 13],
                     "amplitudes": [3.0, 1.5], "noise": 0.5}, seed)
    (ts, ti), (ys, yi) = check.transforms(t, y)
    return (torch.as_tensor(ts * t + ti), torch.as_tensor(ys * y + yi))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lml_matches_the_port(port, seed):
    A, M, cfg, tables = port
    nt, pz, nz = draw(port, 16, seed)
    ts, xs = data(40)
    mask = torch.ones_like(ts)
    got = M.lml(nt, pz, nz, ts, xs, mask, cfg, tables)
    want = ref.lml(ref.Model(CONFIG), nt, pz, nz, ts, xs)
    ok = torch.isfinite(want)
    assert ok.sum() >= 12
    torch.testing.assert_close(got[ok], want[ok], rtol=1e-9, atol=1e-9)


def test_every_code_is_drawn(port):
    nt, _, _ = draw(port, 256, 7)
    assert set(torch.unique(nt).tolist()) >= {0, 2, 4, 5, 6, 7, 8}


@pytest.mark.parametrize("seed", [3, 4])
def test_posterior_matches_the_port(port, seed):
    A, M, cfg, tables = port
    from autogp_tpu_torch import gp_math
    nt, pz, nz = draw(port, 8, seed)
    ts, xs = data(40)
    tp = torch.linspace(1.0, 1.2, 6, dtype=torch.float64)
    mask = torch.ones_like(ts)
    pt = M.transform_params(nt, pz, tables)
    noise = M.transform_noise(nz, cfg)
    L, alpha = gp_math.train_cholesky_masked(nt, pt, noise, ts, xs, mask,
                                             tables.depth_cap)
    mu, sd = gp_math.posterior_marginals_from_factor(
        nt, pt, L, alpha, mask, ts, tp, noise, tables.depth_cap)
    mu_r, sd_r = ref.posterior(ref.Model(CONFIG), nt, pz, nz, ts, xs, tp)
    ok = torch.isfinite(mu_r).all(1)
    torch.testing.assert_close(mu[ok], mu_r[ok], rtol=1e-7, atol=1e-9)
    torch.testing.assert_close(sd[ok], sd_r[ok], rtol=1e-7, atol=1e-9)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.0000002], dtype=torch.float32)
    got = ref.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, -3.0]


def test_transforms_map_time_onto_the_unit_interval():
    (ts, ti), (ys, yi) = check.transforms(np.array([3.0, 5.0, 7.0]),
                                          np.array([1.0, 2.0, 6.0]))
    assert (ts * 3 + ti, ts * 7 + ti) == (0.0, 1.0)
    assert math.isclose(ys * 3.0 + yi, 0.0)
