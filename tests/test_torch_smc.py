"""SMC with data annealing in the port (CPU, float64): ports of the JAX
package's reweight and resampling tests, and small port-only fits without
and with HMC."""

import warnings

import numpy as np
import pytest
import torch

import autogp_tpu_torch as A
from autogp_tpu_torch import config as C
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.inference import smc

F64 = torch.float64


@pytest.fixture(autouse=True)
def _torch_cpu_f64():
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _setup(**kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = C.GPConfig(**kw)
    return cfg, TM.prior_tables(cfg, "cpu", F64)


def _ds(ts, xs, n, pad_to=32):
    return smc.make_dataset(ts, xs, n=n, pad_to=pad_to, dtype=F64,
                            device="cpu")


def test_reweight_matches_direct_lml():
    """Port of tests/test_inference.py:166-187: weights after each reweight
    equal the directly computed LMLs (rtol 1e-9, float64)."""
    cfg, tab = _setup(max_depth=3)
    rng = np.random.default_rng(0)
    n = 24
    ts = np.linspace(0, 1, n)
    xs = np.sin(6 * ts) + 0.1 * rng.standard_normal(n)
    gen = torch.Generator().manual_seed(0)
    parts = smc.initialize(gen, 16, _ds(ts, xs, 0), cfg, tab)
    np.testing.assert_allclose(parts.log_weights.numpy(), 0.0, atol=1e-12)
    p1 = smc.reweight(parts, _ds(ts, xs, 10), cfg, tab)
    direct1 = smc.lml_all(parts, _ds(ts, xs, 10), cfg, tab)
    np.testing.assert_allclose(p1.log_weights.numpy(), direct1.numpy(),
                               rtol=1e-9)
    p2 = smc.reweight(p1, _ds(ts, xs, 24), cfg, tab)
    direct2 = smc.lml_all(parts, _ds(ts, xs, 24), cfg, tab)
    np.testing.assert_allclose(p2.log_weights.numpy(), direct2.numpy(),
                               rtol=1e-9)


def test_reweight_clamps_failed_lml():
    """A non-finite new LML sets the weight to -inf and the cached LML to
    the finite BAD_LML sentinel (smc.py:234-247)."""
    cfg, tab = _setup(max_depth=3)
    gen = torch.Generator().manual_seed(1)
    ts = np.linspace(0, 1, 16)
    parts = smc.initialize(gen, 4, _ds(ts, np.sin(ts), 0), cfg, tab)
    parts = parts.replace(noise_z=torch.tensor([0.0, float("nan"), 0., 0.]))
    out = smc.reweight(parts, _ds(ts, np.sin(ts), 16), cfg, tab)
    assert out.log_weights[1] == float("-inf")
    assert out.lml[1] == smc.BAD_LML
    assert torch.isfinite(out.log_weights[[0, 2, 3]]).all()


def test_resampling_semantics():
    """Port of tests/test_inference.py:190-216."""
    cfg, tab = _setup(max_depth=3)
    gen = torch.Generator().manual_seed(5)
    parts = smc.initialize(gen, 8, _ds(np.zeros(4), np.zeros(4), 0), cfg,
                           tab)
    lw = torch.tensor([10., 0., 0., 0., 0., 0., 0., 0.], dtype=F64)
    parts = parts.replace(log_weights=lw)
    assert float(smc.effective_sample_size(lw)) < 1.1
    new, did = smc.maybe_resample(gen, parts, ess_threshold=4.0)
    assert bool(did)
    np.testing.assert_allclose(new.log_weights.numpy(), 0.0)
    lse = float(torch.logsumexp(lw, 0))
    np.testing.assert_allclose(float(new.log_ml_est), lse - np.log(8),
                               rtol=1e-12)
    assert (new.parents.numpy() == 0).mean() > 0.8
    # High ESS: no resample, and `parents` persists from the LAST resample.
    old_parents = torch.tensor([3, 3, 1, 0, 7, 7, 7, 2])
    parts2 = parts.replace(log_weights=torch.zeros(8, dtype=F64),
                           parents=old_parents)
    new2, did2 = smc.maybe_resample(gen, parts2, ess_threshold=4.0)
    assert not bool(did2)
    np.testing.assert_array_equal(new2.parents.numpy(), old_parents.numpy())


def test_small_fit_end_to_end():
    """Port-only fit through the API (N=32, P=8, n_mcmc=4, n_hmc=0, with
    per-move checks): finite LMLs, cached LMLs equal fresh ones,
    validate_particles with round trips passes, and the best particle
    beats the best of the prior."""
    cfg, _ = _setup(static_max_depth=4)
    rng = np.random.default_rng(1)
    n = 32
    ts = np.linspace(0, 1, n)
    xs = np.sin(2 * np.pi * 4 * ts) + 0.05 * rng.standard_normal(n)
    A.seed(0)
    prior = A.GPModel(ts, xs, n_particles=8, config=cfg, device="cpu")
    full = prior._dataset()
    prior_best = float(smc.lml_all(prior.particles, full, cfg,
                                   prior.tables).max())
    m = A.GPModel(ts, xs, n_particles=8, config=cfg, device="cpu")
    A.fit_smc(m, schedule=[8, 16, 32], n_mcmc=4, n_hmc=0, check=True)
    parts = m.particles
    assert parts.params.dtype == F64
    assert torch.isfinite(parts.lml).all()
    fresh = smc.lml_all(parts, full, cfg, m.tables)
    np.testing.assert_allclose(parts.lml.numpy(), fresh.numpy(), rtol=1e-9)
    smc.validate_particles(parts, cfg, tables=m.tables)
    assert float(parts.lml.max()) > prior_best
    assert np.isfinite(m.log_marginal_likelihood_estimate())
    assert np.isclose(m.particle_weights().sum(), 1.0)


def test_hmc_fit_end_to_end():
    """fit_smc with n_hmc=2 through the API (N=32, P=6, depth 3, two
    rounds): HMC ran (sweeps in round_stats), the cached LMLs are finite and equal fresh ones (rtol 1e-9,
    float64), and validate_particles with round trips passes."""
    cfg, _ = _setup(max_depth=3)
    rng = np.random.default_rng(2)
    n = 32
    ts = np.linspace(0, 1, n)
    xs = np.sin(2 * np.pi * 2 * ts) + 0.1 * rng.standard_normal(n)
    A.seed(3)
    m = A.GPModel(ts, xs, n_particles=6, config=cfg, device="cpu")
    A.fit_smc(m, schedule=[16, 32], n_mcmc=3, n_hmc=2,
              hmc_config={"L_param": 4, "L_noise": 4})
    assert [r["step"] for r in m.round_stats] == [16, 32]
    assert sum(r["hmc_sweeps"] for r in m.round_stats) > 0
    parts = m.particles
    assert torch.isfinite(parts.lml).all()
    fresh = smc.lml_all(parts, m._dataset(), cfg, m.tables)
    np.testing.assert_allclose(parts.lml.numpy(), fresh.numpy(), rtol=1e-9)
    smc.validate_particles(parts, cfg, tables=m.tables)
