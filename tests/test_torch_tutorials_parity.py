"""The port's tutorial fits against the JAX package on the real datasets
(tsdl.161, M1266, iclaims), on the CPU in float64.

Each flow of autogp_tpu_torch/scripts/tutorials/ runs in FAST mode; its
fitted model is carried to the JAX package by to_dict -> from_dict, and
the two packages' answers on the same model agree, rtol 1e-9: predict
(means and quantiles), predict_proba, predict_quantile (tol 1e-10) and
predict_mvn (weights, means, covariances); on M1266 also decompose's
fragments, split_kernel_sop by Periodic and predict_sum; on iclaims the
log-normal-corrected direct-space means.
"""

import numpy as np
import pytest
import torch

import autogp_tpu
import autogp_tpu_torch as A
from autogp_tpu_torch.scripts.tutorials import (
    decomposition, iclaims, overview)

RTOL = 1e-9
Q = [0.025, 0.975]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fit(flow):
    r = flow.run(True, device="cpu")
    return r, autogp_tpu.from_dict(A.to_dict(r["model"]))


@pytest.fixture(scope="module")
def tsdl161():
    return _fit(overview)


@pytest.fixture(scope="module")
def m1266():
    return _fit(decomposition)


@pytest.fixture(scope="module")
def iclaims_fit():
    return _fit(iclaims)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _kernel_dicts(pkg, model):
    return [pkg.api._kernel_to_dict(k)
            for k in model.covariance_kernels(reparameterize=False)]


def _same_trees(a, b):
    assert a["type"] == b["type"] and a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, dict):
            _same_trees(v, b[k])
        elif k != "type":
            np.testing.assert_allclose(v, b[k], rtol=1e-12)


def _same_predictions(pm, jm, ds, ds_test, y_test):
    cols = ["weight", "y_mean"] + [f"y_{q}" for q in Q]
    _close(A.predict(pm, ds, quantiles=Q)[cols].to_numpy(),
           autogp_tpu.predict(jm, ds, quantiles=Q)[cols].to_numpy())
    _close(A.predict_proba(pm, ds_test, y_test)["logp"].to_numpy(),
           autogp_tpu.predict_proba(jm, ds_test, y_test)["logp"].to_numpy())
    for q in (0.025, 0.5, 0.975):
        _close(A.predict_quantile(pm, ds, q, tol=1e-10)[0],
               autogp_tpu.predict_quantile(jm, ds, q, tol=1e-10)[0])
    pv, jv = A.predict_mvn(pm, ds_test), autogp_tpu.predict_mvn(jm, ds_test)
    _close(pv.weights, jv.weights)
    for a, b in zip(pv.components, jv.components):
        _close(a.mean, b.mean)
        _close(a.cov, b.cov)


@pytest.mark.parametrize("name", ["tsdl161", "m1266", "iclaims_fit"])
def test_predict_family_matches_the_jax_package(request, name):
    r, jm = request.getfixturevalue(name)
    pm, test = r["model"], r["df_test"]
    assert pm.dtype == torch.float64
    _close(pm.particle_weights(), jm.particle_weights())
    _close(pm.particles.lml.numpy(), np.asarray(jm.particles.lml))
    ds = r["ds_query"][::4]
    _same_predictions(pm, jm, ds, test["ds"], test["y"].to_numpy())


def test_m1266_decomposition_matches_the_jax_package(m1266):
    r, jm = m1266
    pm = r["model"]
    js, ps = autogp_tpu.decompose(jm), A.decompose(pm)
    assert len(js) == len(ps) == pm.num_particles
    for j, p in zip(js, ps):
        for a, b in zip(_kernel_dicts(autogp_tpu, j), _kernel_dicts(A, p)):
            _same_trees(a, b)
        _close(p.particles.lml.numpy(), np.asarray(j.particles.lml))
    for j, p in zip(autogp_tpu.split_kernel_sop(jm, autogp_tpu.GP.Periodic),
                    A.split_kernel_sop(pm, A.GP.Periodic)):
        for a, b in zip(_kernel_dicts(autogp_tpu, j), _kernel_dicts(A, p)):
            _same_trees(a, b)
        _close(p.particles.lml.numpy(), np.asarray(j.particles.lml))
    cols = ["y_mean"] + [f"y_{q}" for q in Q]
    ds = r["ds_sum"]
    got = A.predict_sum(pm, ds, A.GP.Periodic, quantiles=Q)
    want = autogp_tpu.predict_sum(jm, ds, autogp_tpu.GP.Periodic,
                                  quantiles=Q)
    assert (got["component"].to_numpy() == want["component"].to_numpy()).all()
    _close(got[cols].to_numpy(), want[cols].to_numpy())


def test_iclaims_lognormal_means_match_the_jax_package(iclaims_fit):
    """The flow's direct-space means, exp(mu + s^2 / 2) weighted over the
    particles, from the JAX package's predict_mvn on the carried model."""
    r, jm = iclaims_fit
    mvn = autogp_tpu.predict_mvn(jm, r["ds_q"])
    lt = autogp_tpu.LogTransform()
    want = np.zeros(mvn.dim)
    for w, c in zip(mvn.weights, mvn.components):
        want += w * lt.unapply_mean_var(c.mean, np.diag(c.cov))[0]
    _close(r["correct"], want)
    assert np.all(r["bias"] >= -1e-8)
