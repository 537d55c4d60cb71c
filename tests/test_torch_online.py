"""The streaming API and the online script of the port, on the CPU in
float64: add_data, remove_data, maybe_resample, predict_mvn,
predict_quantile and predict_proba against the JAX package on particles
carried across as a dict; fit_smc's callback sequence; the MCMC-only
entries' invariants; and the CLI's `main` on a small CSV."""

import os
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import autogp_tpu
import autogp_tpu_torch
from autogp_tpu_torch import tree as TT
from autogp_tpu_torch.inference import smc
from autogp_tpu_torch.scripts import online

F64 = torch.float64


@pytest.fixture(autouse=True)
def _torch_cpu_f64():
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _series(n, seed=0):
    rng = np.random.default_rng(seed)
    ds = np.linspace(0, 4, n)
    return ds, np.sin(3 * ds) + 0.3 * ds + 0.1 * rng.standard_normal(n)


@pytest.fixture(scope="module")
def jax_model():
    ds, y = _series(48)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = autogp_tpu.GPConfig(static_max_depth=4)
    autogp_tpu.seed(0)
    m = autogp_tpu.GPModel(ds[:40], y[:40], n_particles=6, config=cfg)
    autogp_tpu.fit_smc(m, schedule=[40], n_mcmc=2, n_hmc=0)
    return m


def _pair(jax_model):
    """Fresh copies of the fitted model in both packages (the streaming
    calls change their model)."""
    d = autogp_tpu.to_dict(jax_model)
    return (autogp_tpu.from_dict(d),
            autogp_tpu_torch.from_dict(d, device="cpu", dtype=F64))


def _assert_state_close(pm, jm, rtol=1e-8):
    np.testing.assert_allclose(pm.particles.lml.numpy(),
                               np.asarray(jm.particles.lml), rtol=rtol)
    np.testing.assert_allclose(pm.particles.log_weights.numpy(),
                               np.asarray(jm.particles.log_weights),
                               rtol=rtol, atol=1e-9)
    np.testing.assert_allclose(pm.particle_weights(), jm.particle_weights(),
                               rtol=rtol, atol=1e-12)


def test_add_and_remove_data_match_jax(jax_model):
    """add_data then remove_data reweight as the JAX package does (rtol
    1e-8: float64 factors of the same grams; 46 points cross the 32-point
    bucket into the 64-point one)."""
    ds, y = _series(48)
    jm, pm = _pair(jax_model)
    autogp_tpu.add_data(jm, ds[40:46], y[40:46])
    autogp_tpu_torch.add_data(pm, ds[40:46], y[40:46])
    assert len(pm.ds) == 46 and pm._dataset().ts.shape[0] == 64
    _assert_state_close(pm, jm)
    np.testing.assert_allclose(
        pm.particles.lml.numpy(),
        smc.lml_all(pm.particles, pm._dataset(), pm.config,
                    pm.tables).numpy(), rtol=1e-12)
    autogp_tpu.remove_data(jm, ds[5:20])
    autogp_tpu_torch.remove_data(pm, ds[5:20])
    assert len(pm.ds) == 31 and pm._dataset().ts.shape[0] == 32
    _assert_state_close(pm, jm)
    with pytest.raises(ValueError, match="No such time points"):
        autogp_tpu_torch.remove_data(pm, np.array([123.0]))


def test_maybe_resample_matches_jax(jax_model):
    """Below the threshold nothing changes; above it both packages fold
    the same normalizer into log_ml_est (rtol 1e-8), zero the weights and
    copy particles from valid parents. The draws differ by design."""
    ds, y = _series(48)
    jm, pm = _pair(jax_model)
    autogp_tpu.add_data(jm, ds[40:44], y[40:44])
    autogp_tpu_torch.add_data(pm, ds[40:44], y[40:44])
    before = pm.particles
    assert autogp_tpu_torch.maybe_resample(pm, 0.0) is False
    assert torch.equal(pm.particles.log_weights, before.log_weights)
    assert torch.equal(pm.particles.node_type, before.node_type)
    P = pm.num_particles
    assert autogp_tpu.maybe_resample(jm, P + 1.0) is True
    assert autogp_tpu_torch.maybe_resample(pm, P + 1.0) is True
    np.testing.assert_allclose(pm.log_marginal_likelihood_estimate(),
                               jm.log_marginal_likelihood_estimate(),
                               rtol=1e-8)
    assert (pm.particles.log_weights == 0).all()
    par = pm.particles.parents
    assert ((par >= 0) & (par < P)).all()
    assert torch.equal(pm.particles.node_type, before.node_type[par])
    assert torch.equal(pm.particles.lml, before.lml[par])


def test_predict_family_matches_jax(jax_model):
    """predict_mvn (means and full covariances), predict_quantile and
    predict_proba against the JAX package on the same particles: rtol 1e-8
    (joint-Cholesky posteriors in float64 on both sides; covariances to
    1e-8 of their largest entry)."""
    ds, y = _series(48)
    jm, pm = _pair(jax_model)
    ds_new, y_new = ds[40:], y[40:]
    mj = autogp_tpu.predict_mvn(jm, ds_new)
    mp = autogp_tpu_torch.predict_mvn(pm, ds_new)
    np.testing.assert_allclose(mp.weights, mj.weights, rtol=1e-8)
    for cp, cj in zip(mp.components, mj.components):
        np.testing.assert_allclose(cp.mean, cj.mean, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(cp.cov, cj.cov, rtol=0,
                                   atol=1e-8 * np.abs(cj.cov).max())
    mj2 = autogp_tpu.predict_mvn(jm, ds_new, noise_pred=0.0)
    mp2 = autogp_tpu_torch.predict_mvn(pm, ds_new, noise_pred=0.0)
    np.testing.assert_allclose(mp2.components[0].cov, mj2.components[0].cov,
                               rtol=0, atol=1e-8 * np.abs(
                                   mj2.components[0].cov).max())
    for q in (0.1, 0.5):
        np.testing.assert_allclose(
            autogp_tpu_torch.predict_quantile(pm, ds_new, q)[0],
            autogp_tpu.predict_quantile(jm, ds_new, q)[0], rtol=1e-8,
            atol=1e-8)
    pj = autogp_tpu.predict_proba(jm, ds_new, y_new)
    pp = autogp_tpu_torch.predict_proba(pm, ds_new, y_new)
    assert list(pp.columns) == list(pj.columns)
    for col in pj.columns:
        np.testing.assert_allclose(pp[col].to_numpy(np.float64),
                                   pj[col].to_numpy(np.float64), rtol=1e-8,
                                   err_msg=col)
    # The mixture's own log density agrees with the per-particle one.
    np.testing.assert_allclose(
        [c.logpdf(y_new) for c in mp.components], pp["logp"], rtol=1e-6)
    empty = autogp_tpu_torch.predict_proba(pm, ds_new[:0], y_new[:0])
    assert (empty["logp"] == 0).all()
    with pytest.raises(ValueError, match="Quantile"):
        autogp_tpu_torch.predict_quantile(pm, ds_new, 1.0)


def test_fit_smc_callback_sequence_and_keywords():
    """callback_fn is called at step 0 and after every round with the
    keywords of the JAX package's SMC loop; `elapsed` grows; the particles at the
    last call are the fitted ones; step 0 sees prior particles on no
    data (every LML 0)."""
    ds, y = _series(12, seed=1)
    autogp_tpu_torch.seed(3)
    m = autogp_tpu_torch.GPModel(ds, y, n_particles=4, device="cpu")
    calls = []
    autogp_tpu_torch.fit_smc(m, schedule=[4, 8, 12], n_mcmc=1, n_hmc=1,
                             shuffle=True,
                             callback_fn=lambda **kw: calls.append(kw))
    assert [c["step"] for c in calls] == [0, 4, 8, 12]
    for c in calls:
        assert set(c) == {"particles", "ts", "xs", "permutation", "schedule",
                          "step", "elapsed", "rejuvenated", "resampled",
                          "verbose"}
        assert c["schedule"] == [4, 8, 12]
        assert isinstance(c["rejuvenated"], bool)
        assert isinstance(c["resampled"], bool)
    perm = calls[0]["permutation"]
    assert sorted(perm.tolist()) == list(range(12))
    np.testing.assert_allclose(calls[0]["ts"], m._ds_numeric()[perm])
    assert not calls[0]["rejuvenated"] and calls[1]["rejuvenated"]
    assert (calls[0]["particles"].lml == 0).all()
    el = [c["elapsed"] for c in calls]
    assert all(b > a for a, b in zip(el, el[1:]))
    assert calls[-1]["particles"] is m.particles


def _assert_lml_fresh(m):
    fresh = smc.lml_all(m.particles, m._dataset(), m.config, m.tables)
    np.testing.assert_allclose(m.particles.lml.numpy(), fresh.numpy(),
                               rtol=1e-10)


def test_mcmc_entries_keep_cached_lml_fresh():
    """mcmc_structure, fit_mcmc and mcmc_parameters on a 20-point model
    (the 32-point bucket, so HMC takes the dense gradient route): the
    cached LMLs equal a fresh evaluation afterwards, counts have one entry
    per particle, and fit_mcmc calls back only on steps that accepted."""
    ds, y = _series(20, seed=2)
    autogp_tpu_torch.seed(5)
    m = autogp_tpu_torch.GPModel(ds, y, n_particles=6, device="cpu")
    n_acc = autogp_tpu_torch.mcmc_structure(m, n_mcmc=3, n_hmc=2,
                                            check=True)
    assert n_acc.shape == (6,) and (n_acc >= 0).all() and (n_acc <= 3).all()
    _assert_lml_fresh(m)
    before = m.particles.params.clone()
    n_hmc_acc = autogp_tpu_torch.mcmc_parameters(m, n_hmc=2)
    assert n_hmc_acc.shape == (6,) and (n_hmc_acc <= 2).all()
    same = (m.particles.params == before).flatten(1).all(1).numpy()
    assert same[n_hmc_acc == 0].all() and not same[n_hmc_acc > 0].any()
    _assert_lml_fresh(m)
    steps = []
    out = autogp_tpu_torch.fit_mcmc(
        m, n_mcmc=3, n_hmc=1,
        callback_fn=lambda **kw: steps.append((kw["step"], kw["elapsed"],
                                               kw["model"])))
    assert out is m
    assert all(1 <= s <= 3 and e > 0 and mm is m for s, e, mm in steps)
    _assert_lml_fresh(m)


def test_mcmc_structure_no_data_preserves_prior():
    """With no observations the posterior is the prior: 15 mcmc_structure
    steps with one short HMC sweep each, from 256 prior particles at depth 3,
    keep the tree-size and root-type distributions and unit-variance
    whitened parameters (thresholds of test_mh_no_data_preserves_prior)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = autogp_tpu_torch.GPConfig(max_depth=3)
    ds, y = _series(8)
    autogp_tpu_torch.seed(7)
    full = autogp_tpu_torch.GPModel(ds, y, n_particles=256, config=cfg,
                                    device="cpu")
    empty = smc.make_dataset(ds, y, n=0, dtype=F64, device="cpu")
    prior = smc.initialize(torch.Generator().manual_seed(2), 256, empty, cfg,
                           full.tables)
    m = autogp_tpu_torch.GPModel._from_state(
        prior, cfg, ds[:0], y[:0], full.ds_transform, full.y_transform)
    assert (m.particles.lml == 0).all()
    nt0 = m.particles.node_type.clone()
    n_acc = autogp_tpu_torch.mcmc_structure(
        m, n_mcmc=15, n_hmc=1, hmc_config={"L_param": 2, "L_noise": 2})
    nt1 = m.particles.node_type
    assert n_acc.mean() / 15 > 0.5
    s0 = TT.subtree_sizes(nt0)[:, 0].numpy()
    s1 = TT.subtree_sizes(nt1)[:, 0].numpy()
    assert abs(s0.mean() - s1.mean()) < 0.45, (s0.mean(), s1.mean())
    f0 = np.bincount(nt0[:, 0].numpy(), minlength=9)[1:] / 256
    f1 = np.bincount(nt1[:, 0].numpy(), minlength=9)[1:] / 256
    assert np.abs(f0 - f1).max() < 0.12, (f0, f1)
    z = m.particles.params[TT.param_mask(nt1) > 0]
    assert abs(float(z.std()) - 1.0) < 0.15 and abs(float(z.mean())) < 0.15
    assert (m.particles.lml == 0).all()


def test_online_cli_writes_one_file_per_step(tmp_path, monkeypatch, capsys):
    """The CLI's main on a 40-point CSV with device="cpu" and 4 particles:
    36 training points on a strided schedule, 4 held out, 5 future points;
    one gp.NNN file per step (step 0 included) with finite predictions,
    the test log density filled in from step 1 on, parents in range."""
    ds, y = _series(40, seed=4)
    csv = tmp_path / "series.csv"
    np.savetxt(csv, np.c_[np.arange(40.0), y], delimiter=",")
    for k, v in {"DATASET": str(csv), "TIMETYPE": "NUMERIC",
                 "N_PARTICLES": "4", "SEED": "1", "N_MCMC": "1",
                 "N_HMC": "1", "N_TEST": "4", "N_FUTURE": "5",
                 "SCHEDULE_STEP": "12"}.items():
        monkeypatch.setenv(k, v)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = online.main(device="cpu", log_root=str(tmp_path / "logs"))
    assert m.device.type == "cpu" and len(m.ds) == 36
    (log_dir,) = os.listdir(tmp_path / "logs")
    files = sorted(f for f in os.listdir(tmp_path / "logs" / log_dir)
                   if f.startswith("gp."))
    assert files == ["gp.000", "gp.012", "gp.024", "gp.036"]
    assert "SCHEDULE [12, 24, 36]" in open(
        tmp_path / "logs" / log_dir / "config").read()
    for f in files:
        df = pd.read_csv(tmp_path / "logs" / log_dir / f)
        # 36 train + 4 test + 5 future query points per particle.
        assert len(df) == 4 * 45
        assert np.isfinite(df[["y_mean", "y_0.025", "y_0.975"]]
                           .to_numpy()).all()
        assert set(df["ds_type"]) <= {"ds_obs", "ds_next", "ds_test"}
        assert df["parent"].between(1, 4).all()
        if f == "gp.000":
            assert (df["logp_test"] == 0).all()
            # No observation yet: every particle predicts the prior mean.
            assert df.groupby("particle")["y_mean"].nunique().max() == 1
        else:
            assert np.isfinite(df["logp_test"]).all()
            assert (df["logp_test"] != 0).all()
    assert "gp.036" in capsys.readouterr().out


def test_online_helpers():
    """extend_data continues a regular grid and refuses an irregular one;
    per_point_schedule always ends at n_train."""
    fut, yf = online.extend_data(np.arange(5.0), 3)
    np.testing.assert_array_equal(fut, [5.0, 6.0, 7.0])
    assert np.isnan(yf).all()
    with pytest.raises(ValueError, match="freq"):
        online.extend_data(np.array([0.0, 1.0, 3.0]), 2)
    assert online.per_point_schedule(5) == [1, 2, 3, 4, 5]
    assert online.per_point_schedule(10, 4) == [4, 8, 10]
    assert online.per_point_schedule(3, 4) == [3]


def test_online_cli_defaults_to_the_card(tmp_path, monkeypatch):
    """main() without device="cpu" asks for the card: without one it
    raises before any step file is written. (Skips where a card is
    present.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    csv = tmp_path / "series.csv"
    np.savetxt(csv, np.c_[np.arange(8.0), np.arange(8.0)], delimiter=",")
    monkeypatch.setenv("DATASET", str(csv))
    monkeypatch.setenv("TIMETYPE", "NUMERIC")
    with pytest.raises(RuntimeError, match="cuda"):
        online.main(log_root=str(tmp_path / "logs"))
    assert not (tmp_path / "logs").exists()
