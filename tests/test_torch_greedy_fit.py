"""fit_greedy and fit_greedy_mcmc of the port: fit_greedy against the JAX
package's on test_fit_greedy_smoke's data (CPU, float64, the same seed:
the same structure at each stage, AICs within 1e-6), and ports of
tests/test_api.py's test_fit_greedy_smoke and test_fit_greedy_mcmc."""

import warnings

import numpy as np
import pytest
import torch

import autogp_tpu
import autogp_tpu_torch as A

F64 = torch.float64


@pytest.fixture(autouse=True)
def _torch_cpu():
    torch.set_num_threads(1)


def _smoke_data():
    rng = np.random.default_rng(5)
    n = 24
    ds = np.linspace(0, 1, n)
    return ds, 2.0 * ds + 0.05 * rng.standard_normal(n)


def _kernel_dicts(pkg, model):
    return [pkg.api._kernel_to_dict(k)
            for k in model.covariance_kernels(reparameterize=False)]


def test_fit_greedy_matches_the_jax_package():
    """Both packages draw nz0 and every candidate's leaf parameters from
    their global numpy default_rng, in the same order: from the same
    seed each stage keeps the same structure, with AICs within 1e-6
    relative and the final kernel's parameters within 1e-5."""
    ds, y = _smoke_data()
    stages = {}
    for name, pkg, kw in (("jax", autogp_tpu, {}),
                          ("port", A, {"device": "cpu"})):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cfg = pkg.GPConfig(max_depth=3, changepoints=False)
        pkg.seed(7)
        m = pkg.GPModel(ds, y, n_particles=1, config=cfg, **kw)
        seen = []
        pkg.fit_greedy(m, max_depth=2, callback_fn=lambda **k: seen.append(
            (k["step"], k["aic"], _kernel_dicts(pkg, k["model"]))))
        stages[name] = seen
    assert len(stages["jax"]) == len(stages["port"]) == 2
    for (sj, aj, kj), (sp, ap, kp) in zip(stages["jax"], stages["port"]):
        assert sj == sp
        np.testing.assert_allclose(ap, aj, rtol=1e-6)
        _assert_same_kernels(kj, kp, rtol=1e-5)


def _assert_same_kernels(a, b, rtol):
    """Kernel trees in the to_dict form: same node types, parameters
    within rtol."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["type"] == y["type"] and x.keys() == y.keys()
        for k, v in x.items():
            if isinstance(v, dict):
                _assert_same_kernels([v], [y[k]], rtol)
            elif k != "type":
                np.testing.assert_allclose(v, y[k], rtol=rtol)


def test_fit_greedy_smoke():
    """Port of test_fit_greedy_smoke (tests/test_api.py:376): one particle
    only, two callback steps, AIC non-increasing, a Linear component for a
    near-linear series; per-stage counts in round_stats."""
    ds, y = _smoke_data()
    cfg = A.GPConfig(max_depth=3, changepoints=False)
    A.seed(7)
    m = A.GPModel(ds, y, n_particles=1, config=cfg, device="cpu")
    with pytest.raises(ValueError):
        A.fit_greedy(A.GPModel(ds, y, n_particles=2, config=cfg,
                               device="cpu"))
    steps = []
    A.fit_greedy(m, max_depth=2, callback_fn=lambda **kw: steps.append(
        (kw["step"], kw["aic"])))
    assert [s[0] for s in steps] == [1, 2]
    assert steps[1][1] <= steps[0][1]
    k = m.covariance_kernels(reparameterize=False)[0]
    assert any(isinstance(leaf, A.GP.Linear) for leaf in A.GP.unroll(k))
    assert [r["step"] for r in m.round_stats] == [1, 2]
    assert m.round_stats[0]["candidates"] == 3
    assert all(r["probes"] > 0 for r in m.round_stats)
    assert m.particles.lml.dtype == F64 and m.num_particles == 1
    assert np.isfinite(m.particles.lml.numpy()).all()


def test_fit_greedy_mcmc():
    """Port of test_fit_greedy_mcmc (tests/test_api.py:397): the hybrid
    chain's AIC is non-increasing and strictly lower on accepted steps,
    some step accepts on the seeded workload, n_parallel = 2, check=True;
    the applicability errors."""
    rng = np.random.default_rng(7)
    n = 32
    ds = np.linspace(0, 1, n)
    y = np.sin(2 * np.pi * 3 * ds) + 0.05 * rng.standard_normal(n)
    cfg = A.GPConfig(max_depth=3, changepoints=False)
    A.seed(3)
    m = A.GPModel(ds, y, n_particles=1, config=cfg, device="cpu")
    with pytest.raises(ValueError):
        A.fit_greedy_mcmc(A.GPModel(ds, y, n_particles=2, config=cfg,
                                    device="cpu"), n_mcmc=1)
    with pytest.raises(ValueError):
        A.fit_greedy_mcmc(A.GPModel(ds, y, n_particles=1,
                                    config=A.GPConfig(max_depth=3),
                                    device="cpu"), n_mcmc=1)
    with pytest.raises(ValueError):
        A.fit_greedy_mcmc(m, n_mcmc=1, n_parallel=0)
    steps = []
    A.fit_greedy_mcmc(m, n_mcmc=6, n_parallel=2, check=True,
                      callback_fn=lambda **kw: steps.append(
                          (kw["step"], kw["aic"], kw["accepted"])))
    assert [s[0] for s in steps] == list(range(1, 7))
    aics = [s[1] for s in steps]
    assert all(a2 <= a1 for a1, a2 in zip(aics, aics[1:]))
    for (_, a1, _), (_, a2, acc) in zip(steps, steps[1:]):
        if acc:
            assert a2 < a1
    assert any(s[2] for s in steps), "no step accepted on seeded workload"
    assert np.isfinite(aics[-1])
    assert np.isfinite(m.particles.lml.numpy()).all()
