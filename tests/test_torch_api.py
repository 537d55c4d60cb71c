"""The slice as a whole: a model fitted by the JAX package is carried into
the port with from_dict(autogp_tpu.to_dict(m)) and must give the same
LMLs, weights, log-ML estimate and predictions (CPU, float64), and carry
back the other way."""

import warnings

import numpy as np
import pytest
import torch

import autogp_tpu
import autogp_tpu_torch
from autogp_tpu_torch.inference import smc

F64 = torch.float64


def assert_trees_close(a: dict, b: dict, rtol: float):
    """Two kernel trees in the to_dict form: same node types and fields,
    parameters within `rtol`."""
    assert a["type"] == b["type"] and a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, dict):
            assert_trees_close(v, b[k], rtol)
        elif k != "type":
            np.testing.assert_allclose(v, b[k], rtol=rtol)


@pytest.fixture(autouse=True)
def _torch_cpu_f64():
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.default_rng(0)
    n = 64
    ds = np.linspace(0, 4, n)
    y = np.sin(3 * ds) + 0.3 * ds + 0.1 * rng.standard_normal(n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = autogp_tpu.GPConfig(static_max_depth=4)
    autogp_tpu.seed(0)
    m = autogp_tpu.GPModel(ds, y, n_particles=8, config=cfg)
    autogp_tpu.fit_smc(m, schedule=[64], n_mcmc=2, n_hmc=0)
    return m


def test_jax_model_carries_into_the_port(jax_model):
    jm = jax_model
    pm = autogp_tpu_torch.from_dict(autogp_tpu.to_dict(jm), device="cpu",
                                    dtype=F64)
    assert pm.dtype == F64 and pm.device.type == "cpu"
    # LMLs recomputed by the port, and by a port reweight on the same data
    # (weights unchanged), equal JAX's cached ones: rtol 1e-9, float64
    # factors of the same grams in a different order.
    jl = np.asarray(jm.particles.lml)
    np.testing.assert_allclose(pm.particles.lml.numpy(), jl, rtol=1e-9)
    rw = smc.reweight(pm.particles, pm._dataset(), pm.config, pm.tables)
    np.testing.assert_allclose(rw.lml.numpy(), jl, rtol=1e-9)
    np.testing.assert_allclose(rw.log_weights.numpy(),
                               np.asarray(jm.particles.log_weights),
                               rtol=1e-9, atol=1e-9)
    # The same particles carried as arrays (no symbolic round trip).
    parts = autogp_tpu_torch.particles_from_numpy(
        np.asarray(jm.particles.node_type), np.asarray(jm.particles.params),
        np.asarray(jm.particles.noise_z),
        np.asarray(jm.particles.log_weights), np.asarray(jm.particles.lml),
        np.asarray(jm.particles.log_ml_est),
        np.asarray(jm.particles.parents), device="cpu", dtype=F64)
    np.testing.assert_allclose(
        smc.lml_all(parts, pm._dataset(), pm.config, pm.tables).numpy(), jl,
        rtol=1e-9)
    # Weights and log-ML estimate travel in the dict: 1e-8 bounds their
    # float64 round trip through the dict's lists.
    np.testing.assert_allclose(pm.particle_weights(), jm.particle_weights(),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(pm.log_marginal_likelihood_estimate(),
                               jm.log_marginal_likelihood_estimate(),
                               rtol=1e-8)
    np.testing.assert_allclose(pm.observation_noise_variances(),
                               jm.observation_noise_variances(), rtol=1e-8)
    # Predictions: means and marginal quantiles in data space, 1e-8 (the
    # posterior marginals of the same factor, float64 on both sides).
    ds_future = np.linspace(4, 5, 12)
    qs = [.1, .5, .9]
    pj = autogp_tpu.predict(jm, ds_future, quantiles=qs)
    pp = autogp_tpu_torch.predict(pm, ds_future, quantiles=qs)
    assert list(pp.columns) == list(pj.columns)
    for col in pj.columns:
        np.testing.assert_allclose(pp[col].to_numpy(np.float64),
                                   pj[col].to_numpy(np.float64), rtol=1e-8,
                                   atol=1e-10, err_msg=col)


def test_port_model_carries_back_to_jax(jax_model):
    pm = autogp_tpu_torch.from_dict(autogp_tpu.to_dict(jax_model),
                                    device="cpu", dtype=F64)
    back = autogp_tpu.from_dict(autogp_tpu_torch.to_dict(pm))
    # The two packages' Node classes differ: kernels cross as dicts.
    for a, b in zip(back.covariance_kernels(), pm.covariance_kernels()):
        assert_trees_close(autogp_tpu.api._kernel_to_dict(a),
                           autogp_tpu_torch.api._kernel_to_dict(b),
                           rtol=1e-12)
    np.testing.assert_allclose(np.asarray(back.particles.lml),
                               pm.particles.lml.numpy(), rtol=1e-9)
    np.testing.assert_allclose(back.particle_weights(),
                               pm.particle_weights(), rtol=1e-12)
    np.testing.assert_allclose(back.log_marginal_likelihood_estimate(),
                               pm.log_marginal_likelihood_estimate(),
                               rtol=1e-12)


def test_device_is_explicit():
    """A CUDA model on a machine without a card raises; nothing falls back
    to the CPU. (Skips where a card is present.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        autogp_tpu_torch.GPModel(np.arange(8.0), np.arange(8.0),
                                 n_particles=2, device="cuda")


def test_device_defaults_to_the_card():
    """GPModel and from_dict default to device="cuda": without a card
    they raise and never build anything on the CPU. (Skips where a card
    is present.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        autogp_tpu_torch.GPModel(np.arange(8.0), np.arange(8.0),
                                 n_particles=2)
    m = autogp_tpu_torch.GPModel(np.arange(8.0), np.sin(np.arange(8.0)),
                                 n_particles=2, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        autogp_tpu_torch.from_dict(autogp_tpu_torch.to_dict(m))


def test_smc_callback_sees_the_observed_prefix():
    """callbacks.make_smc_callback (the port's copy) hands the callback an
    intermediate GPModel over the observed prefix, with the fitted
    model's transforms and particles."""
    from autogp_tpu_torch import callbacks
    ds = np.linspace(0, 1, 8)
    m = autogp_tpu_torch.GPModel(ds, np.sin(4 * ds), n_particles=3,
                                 device="cpu")
    seen = {}

    def fn(**kw):
        seen.update(kw)
    cb = callbacks.make_smc_callback(fn, m)
    perm = np.arange(8)[::-1]
    cb(particles=m.particles, permutation=perm, step=5, schedule=[5, 8],
       rejuvenated=False, resampled=True, elapsed=0.0, verbose=False)
    sub = seen["model"]
    np.testing.assert_array_equal(sub.ds, ds[perm][:5])
    np.testing.assert_array_equal(seen["ds_next"], ds[perm][5:])
    assert sub.particles is m.particles and sub.device == m.device
    assert sub.ds_transform == m.ds_transform


def test_num_particles_is_module_level():
    """The module-level accessor of autogp_tpu.api.num_particles
    (api.py:252), exported like the JAX package's."""
    m = autogp_tpu_torch.GPModel(np.arange(6.0), np.sin(np.arange(6.0)),
                                 n_particles=3, device="cpu")
    assert autogp_tpu_torch.num_particles(m) == m.num_particles == 3
    assert autogp_tpu_torch.num_particles(m) == autogp_tpu.num_particles(
        autogp_tpu.GPModel(np.arange(6.0), np.sin(np.arange(6.0)),
                           n_particles=3))


def test_log_transform_is_exported():
    """LogTransform is exported as autogp_tpu/__init__.py:13 exports it,
    and round-trips as the JAX package's does."""
    x = np.array([0.5, 1.0, 7.0])
    t, tj = autogp_tpu_torch.LogTransform(), autogp_tpu.LogTransform()
    np.testing.assert_array_equal(t.apply(x), tj.apply(x))
    np.testing.assert_allclose(t.unapply(t.apply(x)), x, rtol=1e-15)


def test_fit_smc_hmc_compact_gives_the_same_fit():
    """fit_smc(hmc_compact=False) runs each HMC sweep on all particles,
    keeping the live ones' results (the reference's chunk width P); from
    the same seed it gives the compacted fit's particles and round
    statistics (float64; values to 1e-12, the same per-particle
    arithmetic in batches of other sizes)."""
    ds = np.linspace(0, 2, 24)
    y = np.sin(3 * ds) + 0.1 * np.random.default_rng(2).standard_normal(24)
    fits = []
    for compact in (True, False):
        autogp_tpu_torch.seed(4)
        m = autogp_tpu_torch.GPModel(ds, y, n_particles=6, device="cpu")
        autogp_tpu_torch.fit_smc(m, schedule=[12, 24], n_mcmc=2, n_hmc=3,
                                 hmc_compact=compact)
        fits.append(m)
    a, b = fits
    assert a.round_stats == b.round_stats
    assert sum(r["hmc_sweeps"] for r in a.round_stats) > 0
    assert torch.equal(a.particles.node_type, b.particles.node_type)
    for f in ("params", "noise_z", "lml", "log_weights"):
        np.testing.assert_allclose(getattr(b.particles, f).numpy(),
                                   getattr(a.particles, f).numpy(),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
