"""The predict family's float64 route on the CPU.

A model below float64 (the card's float32) computes every posterior in
float64: its float32 particles are cast exactly, transformed with float64
prior tables and conditioned on float64 data. These tests hold that route
to three things:

(a) a float32 case that the float32 route got wrong (its posterior
    variance cancels to 0, so the quantiles are NaN and the mean is many
    predictive standard deviations off), now finite and at the plain
    reference (`benchmark/reference/gp.py`);
(b) a float32 and a float64 model that hold the same float32-representable
    particles give the same forecasts from all four entry points;
(c) the same forecasts agree with the plain reference.

Tolerances, in units of the reference's predictive standard deviation
(`check.forecast_gap`'s unit): 1e-6. Both sides are float64 and differ in
the order of their sums and in their factorization (the reference factors
only the active points); the widest gap measured on these cases is 2e-8,
while the float32 route misses case (a) by more than 5.
"""

import math

import numpy as np
import pytest
import torch

import autogp_tpu_torch as A
from autogp_tpu_torch import api, gp_math
from autogp_tpu_torch import kernels as GP
from autogp_tpu_torch import model as M
from autogp_tpu_torch.distributions import mixture_marginal_quantile
from benchmark import check
from benchmark import workload as W
from benchmark.reference import gp as ref

CONFIG = W.load_json(W.ROOT / "configs" / "config5.json")
CFG = A.GPConfig(changepoints=True, max_depth=5, prior=CONFIG["prior"])
QS = [0.025, 0.975]
GAP = 1e-6          # predictive std units, float64 against float64
WEIGHT_RTOL = 1e-6  # a float32 model normalizes its weights in float32


def _series(n, seed=0):
    """The benchmark's weekly series shape: trend, periods 52 and 13,
    noise 0.5."""
    t = np.arange(n, dtype=np.float64)
    y = (0.02 * t + 3.0 * np.sin(2 * np.pi * t / 52.0)
         + 1.5 * np.sin(2 * np.pi * t / 13.0)
         + 0.5 * np.random.default_rng(seed).standard_normal(n))
    return t, y


def _model(t, y, particles_of, dtype):
    m = A.GPModel(t, y, n_particles=1, config=CFG, device="cpu",
                  dtype=dtype, _defer_init=True)
    m.particles = particles_of(m)
    return m


# (a) The float32 route's failure: a linear trend of large amplitude beside a periodic
# component, the noise at its prior's z = -6, on 64 points. The float32
# factor leaves colsum(V^2) within rounding of Kpp + noise, so the
# variance cancels.
CANCEL_N = 64
CANCEL_KERNELS = [
    GP.Plus(GP.Linear(0.5, 1.0, 1000.0), GP.Periodic(1.0, 13 / 63, 1.0)),
    GP.Plus(GP.Linear(0.5, 1000.0, 1.0),
            GP.Plus(GP.Periodic(1.0, 52 / 63, 1.0),
                    GP.Periodic(1.0, 13 / 63, 1.0))),
]
CANCEL_NOISE_Z = -6.0


def cancelling_model(device="cpu"):
    """The cancelling case as a float32 model on `device`, and its 100 query
    times after the data."""
    t, y = _series(CANCEL_N + 100)
    m = A.GPModel(t[:CANCEL_N], y[:CANCEL_N], n_particles=len(CANCEL_KERNELS),
                  config=CFG, device=device, dtype=torch.float32,
                  _defer_init=True)
    m.particles = api._particles_from_kernels(
        CANCEL_KERNELS, np.full(len(CANCEL_KERNELS), CANCEL_NOISE_Z), m, CFG)
    return m, t[CANCEL_N:]


def _record(m, future, df=None):
    """What `check.readings` takes, for a model holding all its data."""
    return {"t": m.ds, "y": m.y, "t_fit": m.ds, "y_fit": m.y,
            "future": future, "particles": m.particles, "df": df}


def _reference(m, future):
    """The reference's ([P, p, 1 + q] forecast table, [P, p] std), data
    space."""
    ctx = check.Context(ref.Model(CONFIG), _record(m, future), "cpu")
    return check.reference_forecast(ctx, QS, 64)


def _gap(m, future, df):
    table_ref, std_ref = _reference(m, future)
    table = check.forecast_table(df, m.num_particles, len(future), QS)
    live = torch.isfinite(std_ref).all(dim=1) & (std_ref > 0).all(dim=1)
    return check.forecast_gap(table, table_ref, std_ref, live), live


def test_a_cancelling_float32_case_is_finite_and_at_the_reference():
    m, future = cancelling_model()
    assert torch.isfinite(m.particles.lml).all()
    # The float32 route, as it ran before: factor and moments in float32.
    d, p = m._dataset(), m.particles
    pt = M.transform_params(p.node_type, p.params, m.tables)
    noise = M.transform_noise(p.noise_z, CFG)
    L, alpha = gp_math.train_cholesky_masked(
        p.node_type, pt, noise, d.ts, d.xs, d.mask, CFG.depth_cap)
    tsp = torch.as_tensor(m._ds_numeric(future), dtype=torch.float32)
    mu32, _ = gp_math.posterior_marginals_from_factor(
        p.node_type, pt, L, alpha, d.mask, d.ts, tsp, noise, CFG.depth_cap)
    table_ref, std_ref = _reference(m, future)
    mean32 = m.y_transform.unapply(mu32.double().numpy())
    miss = (np.abs(mean32 - table_ref[..., 0].numpy())
            / std_ref.numpy()).max(axis=1)
    assert (miss > 1.0).all(), miss

    df = A.predict(m, future, quantiles=QS)
    cols = ["y_mean"] + [f"y_{q}" for q in QS]
    assert np.isfinite(df[cols].to_numpy()).all()
    gap, live = _gap(m, future, df)
    assert bool(live.all())
    assert gap <= GAP, gap


def _drawn(seed, P=8, n=64, p=16):
    """A float32 and a float64 model holding the same prior-drawn,
    float32-representable particles and log weights; the query times and
    held-out values after the data."""
    t, y = _series(n + p, seed)
    tables = M.prior_tables(CFG, "cpu", torch.float64)
    gen = torch.Generator().manual_seed(seed)
    nt, pz = M.sample_tree(gen, P, tables, torch.float64, "cpu")
    nz = torch.randn(P, generator=gen, dtype=torch.float64)
    lw = torch.randn(P, generator=gen, dtype=torch.float64)

    def r32(a):
        return a.float().double().numpy()

    def particles_of(m):
        return api.particles_from_numpy(
            nt.numpy(), r32(pz), r32(nz), r32(lw), np.zeros(P),
            np.float64(0.0), np.arange(P), device="cpu", dtype=m.dtype)

    return ({dt: _model(t[:n], y[:n], particles_of, dt)
             for dt in (torch.float32, torch.float64)}, t[n:], y[n:])


SEEDS = [3, 4, 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_and_float64_models_agree_on_predict(seed):
    models, future, _ = _drawn(seed)
    a, b = (A.predict(models[dt], future, quantiles=QS)
            for dt in (torch.float32, torch.float64))
    cols = ["y_mean"] + [f"y_{q}" for q in QS]
    np.testing.assert_allclose(a[cols].to_numpy(), b[cols].to_numpy(),
                               rtol=1e-12, atol=0, equal_nan=True)
    np.testing.assert_allclose(a["weight"], b["weight"], rtol=WEIGHT_RTOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_and_float64_models_agree_on_predict_mvn(seed):
    models, future, _ = _drawn(seed)
    a, b = (A.predict_mvn(models[dt], future)
            for dt in (torch.float32, torch.float64))
    for ca, cb in zip(a.components, b.components):
        np.testing.assert_allclose(ca.mean, cb.mean, rtol=1e-12,
                                   equal_nan=True)
        np.testing.assert_allclose(ca.cov, cb.cov, rtol=1e-12, atol=1e-15,
                                   equal_nan=True)
    np.testing.assert_allclose(a.weights, b.weights, rtol=WEIGHT_RTOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_and_float64_models_agree_on_predict_proba(seed):
    models, future, held = _drawn(seed)
    a, b = (A.predict_proba(models[dt], future, held)
            for dt in (torch.float32, torch.float64))
    np.testing.assert_allclose(a["logp"], b["logp"], rtol=1e-12,
                               equal_nan=True)
    np.testing.assert_allclose(a["weight"], b["weight"], rtol=WEIGHT_RTOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_and_float64_models_agree_on_predict_quantile(seed):
    """The mixture's quantile moves with the weights, which a float32
    model normalizes in float32: 1e-6 of the widest predictive std."""
    models, future, _ = _drawn(seed)
    (a, ok_a), (b, ok_b) = (A.predict_quantile(models[dt], future, 0.9,
                                                tol=1e-10)
                            for dt in (torch.float32, torch.float64))
    assert ok_a and ok_b
    _, std_ref = _reference(models[torch.float64], future)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-6 * float(std_ref.max()))


@pytest.mark.parametrize("seed", SEEDS)
def test_predict_matches_the_reference(seed):
    models, future, _ = _drawn(seed)
    m = models[torch.float32]
    gap, live = _gap(m, future, A.predict(m, future, quantiles=QS))
    assert int(live.sum()) >= 4
    assert gap <= GAP, gap


@pytest.mark.parametrize("seed", SEEDS)
def test_predict_mvn_matches_the_reference(seed):
    """Each component's mean and marginal std against the reference's
    posterior (noise included, as predict_mvn's default noise_pred)."""
    models, future, _ = _drawn(seed)
    m = models[torch.float32]
    table_ref, std_ref = _reference(m, future)
    dist = A.predict_mvn(m, future)
    mean = np.stack([c.mean for c in dist.components])
    std = np.sqrt(np.stack([np.diagonal(c.cov) for c in dist.components]))
    live = np.isfinite(std_ref.numpy()).all(axis=1)
    assert live.sum() >= 4
    s = std_ref.numpy()[live]
    assert (np.abs(mean[live] - table_ref[..., 0].numpy()[live]) / s).max() \
        <= GAP
    assert (np.abs(std[live] - s) / s).max() <= GAP


@pytest.mark.parametrize("seed", SEEDS)
def test_predict_quantile_matches_the_reference(seed):
    """The mixture quantile of the reference's marginals, by the same
    bisection: 1e-6 of the widest predictive std."""
    models, future, _ = _drawn(seed)
    m = models[torch.float32]
    table_ref, std_ref = _reference(m, future)
    live = torch.isfinite(std_ref).all(dim=1).numpy()
    w = m.particle_weights()
    assert np.isclose(w[live].sum(), 1.0, rtol=1e-6), "a dead heavy particle"
    want, ok_want = mixture_marginal_quantile(
        w[live], table_ref[..., 0].numpy()[live], std_ref.numpy()[live],
        0.9, tol=1e-10)
    got, ok_got = A.predict_quantile(m, future, 0.9, tol=1e-10)
    assert ok_want and ok_got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(std_ref.max()))


def _reference_logpdf(m, future, held):
    """[P] log densities of the held-out values under the reference's
    joint posterior predictive, data space: plain float64 conditioning on
    the reference's covariance."""
    rec = _record(m, future)
    ctx = check.Context(ref.Model(CONFIG), rec, "cpu")
    _, yp = ctx.points(future, held)
    nt, pz, nz = ctx.node_type, ctx.params_z, ctx.noise_z
    noise = ctx.model.noise(nz)
    n, p = ctx.ts.shape[0], ctx.tp.shape[0]
    Ktt = ref.covariance(ctx.model, nt, pz, ctx.ts, ctx.ts) \
        + noise[:, None, None] * torch.eye(n, dtype=torch.float64)
    Kpt = ref.covariance(ctx.model, nt, pz, ctx.tp, ctx.ts)
    Kpp = ref.covariance(ctx.model, nt, pz, ctx.tp, ctx.tp) \
        + noise[:, None, None] * torch.eye(p, dtype=torch.float64)
    L, info = torch.linalg.cholesky_ex(Ktt)
    V = torch.linalg.solve_triangular(L, Kpt.mT, upper=False)
    a = torch.linalg.solve_triangular(
        L, ctx.xs.expand(nt.shape[0], n)[..., None], upper=False)
    mean = (V.mT @ a)[..., 0]
    cov = Kpp - V.mT @ V
    Lc, info_c = torch.linalg.cholesky_ex(0.5 * (cov + cov.mT))
    z = torch.linalg.solve_triangular(Lc, (yp - mean)[..., None],
                                      upper=False)[..., 0]
    lp = (-0.5 * (z * z).sum(-1) - torch.log(torch.diagonal(
        Lc, dim1=-2, dim2=-1)).sum(-1) - 0.5 * p * math.log(2 * math.pi))
    lp = lp + p * math.log(abs(ctx.y_slope))
    ok = (info == 0) & (info_c == 0)
    return torch.where(ok, lp, torch.full_like(lp, float("nan"))).numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_predict_proba_matches_the_reference(seed):
    """Log densities within 1e-6 (absolute; they are O(10-100))."""
    models, future, held = _drawn(seed)
    m = models[torch.float32]
    got = A.predict_proba(m, future, held)["logp"].to_numpy()
    want = _reference_logpdf(m, future, held)
    live = np.isfinite(want)
    assert live.sum() >= 4
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-6)
