"""The decomposition API of the port against the JAX package's on the CPU
in float64: ports of tests/test_api.py's decompose / extract / split,
GP-sum and predict_sum tests, on models carried from the JAX package by
to_dict / from_dict; the GP-sum posterior against the direct conditional;
components deeper than kernel 1's bound (the plain version takes any
depth) against the float64 host oracle."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autogp_tpu
import autogp_tpu_torch as A
from autogp_tpu import gp_math as JGM
from autogp_tpu_torch import gp_math as TGM
from autogp_tpu_torch import model as TM
from autogp_tpu_torch import tree as TT
from autogp_tpu_torch.ops import cov

F64 = torch.float64
GP = A.GP


@pytest.fixture(autouse=True)
def _torch_cpu():
    torch.set_num_threads(1)


def _dicts(pkg, model):
    return [pkg.api._kernel_to_dict(k)
            for k in model.covariance_kernels(reparameterize=False)]


def _same_trees(a, b, rtol=1e-12):
    assert a["type"] == b["type"] and a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, dict):
            _same_trees(v, b[k], rtol)
        elif k != "type":
            np.testing.assert_allclose(v, b[k], rtol=rtol)


def _same_models(jm, pm, lml_rtol=1e-9):
    """The same kernels (as dicts), noises, weights and LMLs."""
    assert jm.num_particles == pm.num_particles
    for a, b in zip(_dicts(autogp_tpu, jm), _dicts(A, pm)):
        _same_trees(a, b)
    np.testing.assert_allclose(pm.particles.lml.numpy(),
                               np.asarray(jm.particles.lml), rtol=lml_rtol)
    np.testing.assert_allclose(pm.particle_weights(), jm.particle_weights(),
                               rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(pm.particles.noise_z.numpy(),
                               np.asarray(jm.particles.noise_z), rtol=1e-12)


@pytest.fixture(scope="module")
def models():
    """make_model of tests/test_api.py (40 points, 4 prior particles,
    max_depth 3, seed 7) in the JAX package and carried into the port."""
    rng = np.random.default_rng(0)
    ds = np.linspace(-10, 10, 40)
    y = rng.standard_normal(40)
    autogp_tpu.seed(7)
    jm = autogp_tpu.GPModel(ds, y, n_particles=4,
                            config=autogp_tpu.GPConfig(max_depth=3))
    pm = A.from_dict(autogp_tpu.to_dict(jm), device="cpu", dtype=F64)
    return jm, pm


def test_decompose_and_extract(models):
    """Port of test_decompose_and_extract: every fragment model, the
    extracted model and both split models equal the JAX package's (the
    same kernels, weights, noises; LMLs to 1e-9), on the parent's device;
    a fragment model per particle, with equal weights."""
    jm, pm = models
    js, ps = autogp_tpu.decompose(jm), A.decompose(pm)
    assert len(ps) == len(js) == 4
    for k, j, p in zip(pm.covariance_kernels(reparameterize=False), js, ps):
        assert p.num_particles == len(GP.unroll(k))
        assert p.device == pm.device and p.dtype == F64
        assert p.config.noise == 1e-10
        np.testing.assert_allclose(p.particle_weights(),
                                   1.0 / p.num_particles)
        _same_models(j, p)
    pe = A.extract_kernel(pm, GP.Linear)
    _same_models(autogp_tpu.extract_kernel(jm, autogp_tpu.GP.Linear), pe)
    for k in pe.covariance_kernels(reparameterize=False):
        for leaf in GP.unroll(k):
            if isinstance(leaf, GP.LeafNode):
                assert isinstance(leaf, (GP.Linear, GP.Constant))
    ja, jb = autogp_tpu.split_kernel_sop(jm, autogp_tpu.GP.Periodic)
    pa, pb = A.split_kernel_sop(pm, GP.Periodic)
    _same_models(ja, pa)
    _same_models(jb, pb)
    assert A.num_particles(pa) == A.num_particles(pb) == 4


def test_split_deeper_than_the_cap():
    """A split deeper than the model's depth cap (the JAX package's
    encoding raises there): both sides' sums balanced, the models' cap
    raised to hold them, each side's covariance the float64 oracle's of
    GP.split_kernel_sop."""
    k = ((GP.SquaredExponential(0.3, 1.1) + GP.Linear(0.2, 0.4, 0.6))
         * GP.Periodic(0.5, 0.3, 0.9)) * (
             GP.Periodic(0.2, 0.6, 1.2) + GP.GammaExponential(0.4, 1.2, 0.7))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = A.GPConfig(static_max_depth=k.depth)
    ds = np.linspace(0, 5, 30)
    m = A.GPModel(ds, np.sin(ds), n_particles=1, config=cfg, device="cpu")
    m = A.gp_model_from_kernels(m, [k])
    want = GP.split_kernel_sop(k, GP.Periodic)
    assert max(w.depth for w in want) > cfg.depth_cap
    parts = A.split_kernel_sop(m, GP.Periodic)
    t = m._ds_numeric()
    for part, w in zip(parts, want):
        assert part.config.depth_cap > cfg.depth_cap
        got = part.covariance_kernels(reparameterize=False)[0]
        np.testing.assert_allclose(GP.eval_cov(got, t), GP.eval_cov(w, t),
                                   rtol=1e-12)
        assert np.isfinite(part.particles.lml.numpy()).all()


def _sum_case():
    rng = np.random.default_rng(3)
    ts = np.linspace(0, 5, 25)
    tsp = np.linspace(0, 6.5, 30)
    noise = 0.01
    ks = [GP.Linear(0.1, 1.3, 0.7) * GP.Periodic(0.96, 0.21, 1.1),
          GP.GammaExponential(0.42, 0.58, 3.2)]
    Ksum = GP.compute_cov_matrix_vectorized(ks[0] + ks[1], noise, ts)
    xs = rng.multivariate_normal(np.zeros(len(ts)), Ksum)
    Ktt = np.stack([GP.eval_cov(k, ts) for k in ks])
    Ktp = np.stack([GP.eval_cov(k, ts, tsp) for k in ks])
    Kpp = np.stack([GP.eval_cov(k, tsp) for k in ks])
    return ks, ts, tsp, noise, xs, Ktt, Ktp, Kpp


def test_infer_gp_sum_matches_direct_posterior():
    """Port of test_infer_gp_sum_matches_direct_posterior
    (test_GP.jl:150-240): X(T*)'s block equals the direct conditional; the
    latent blocks sum to it with noise_pred = 0; and the whole (mu, cov)
    equals the JAX package's infer_gp_sum_from_blocks to 1e-10."""
    ks, ts, tsp, noise, xs, Ktt, Ktp, Kpp = _sum_case()
    n, p, m_ = len(ts), len(tsp), len(ks)
    z = np.concatenate([ts, tsp])
    Kz = GP.eval_cov(ks[0] + ks[1], z)
    K11 = Kz[:n, :n] + noise * np.eye(n)
    K12 = Kz[:n, n:]
    cov_direct = Kz[n:, n:] - K12.T @ np.linalg.solve(K11, K12)
    cov_direct = 0.5 * (cov_direct + cov_direct.T) + noise * np.eye(p)
    mu_direct = K12.T @ np.linalg.solve(K11, xs)

    def run(noise_pred):
        mu, cv = TGM.infer_gp_sum_from_blocks(
            *(torch.as_tensor(a)[None] for a in (Ktt, Ktp, Kpp)),
            torch.tensor([noise], dtype=F64), torch.as_tensor(xs),
            torch.ones(n, dtype=F64),
            noise_pred=(None if noise_pred is None
                        else torch.tensor([noise_pred], dtype=F64)))
        return mu[0].numpy(), cv[0].numpy()

    mu, cv = run(None)
    X = slice(m_ * p, (m_ + 1) * p)
    np.testing.assert_allclose(cv[X, X], cov_direct, atol=1e-5)
    np.testing.assert_allclose(mu[X], mu_direct, atol=1e-6)
    mu_j, cv_j = JGM.infer_gp_sum_from_blocks(
        jnp.asarray(Ktt), jnp.asarray(Ktp), jnp.asarray(Kpp), noise,
        jnp.asarray(xs), jnp.ones(n))
    np.testing.assert_allclose(mu, np.asarray(mu_j), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(cv, np.asarray(cv_j), rtol=1e-10,
                               atol=1e-12)
    _, cv0 = run(0.0)
    total = sum(cv0[i * p:(i + 1) * p, j * p:(j + 1) * p]
                for i in range(m_) for j in range(m_))
    np.testing.assert_allclose(total, cv0[X, X], atol=1e-5)


def test_predict_sum_dataframe(models):
    """Port of test_predict_sum_dataframe, held to the JAX package's
    frame: the same columns and rows, means to 1e-8, quantiles to 1e-7;
    component 0 (the whole) is the sum of the two latent means."""
    jm, pm = models
    ds_pred = np.linspace(8, 12, 5)
    qs = [0.1, 0.9]
    dj = autogp_tpu.predict_sum(jm, ds_pred, autogp_tpu.GP.Periodic,
                                quantiles=qs)
    dp = A.predict_sum(pm, ds_pred, GP.Periodic, quantiles=qs)
    assert set(dp["component"]) == {0, 1, 2} and len(dp) == 4 * 3 * 5
    assert list(dp.columns) == list(dj.columns)
    for col in ("ds", "component", "particle", "weight"):
        np.testing.assert_allclose(dp[col].to_numpy(np.float64),
                                   dj[col].to_numpy(np.float64), rtol=1e-9)
    np.testing.assert_allclose(dp["y_mean"], dj["y_mean"], rtol=1e-8,
                               atol=1e-10)
    for q in qs:
        np.testing.assert_allclose(dp[f"y_{q}"], dj[f"y_{q}"], rtol=1e-7,
                                   atol=1e-9)
    mix, idx = A.predict_mvn_sum(pm, ds_pred, GP.Periodic)
    for c in mix.components:
        np.testing.assert_allclose(
            c.mean[idx["Y"]], c.mean[idx["F"][0]] + c.mean[idx["F"][1]],
            rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("noise_pred", [None, 0.0])
def test_predict_mvn_sum_matches_the_jax_package(models, noise_pred):
    """Port of test_predict_mvn_sum_device_matches_host_blocks: the port's
    mixture against the JAX package's, means to 1e-8 and covariances to
    1e-7 (relative, float64), and against the float64 host construction
    of the blocks from the symbolic kernels."""
    jm, pm = models
    ds_pred = np.linspace(8, 12, 6)
    mj, ij = autogp_tpu.predict_mvn_sum(jm, ds_pred, autogp_tpu.GP.Periodic,
                                        noise_pred=noise_pred)
    mp, ip = A.predict_mvn_sum(pm, ds_pred, GP.Periodic,
                               noise_pred=noise_pred)
    np.testing.assert_array_equal(ij["Y"], ip["Y"])
    np.testing.assert_allclose(mp.weights, mj.weights, rtol=1e-9)
    for a, b in zip(mp.components, mj.components):
        np.testing.assert_allclose(a.mean, b.mean, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(a.cov, b.cov, rtol=1e-7, atol=1e-12)
    ts, xs, tsp = pm._ds_numeric(), pm._y_numeric(), pm._ds_numeric(ds_pred)
    noises = pm.observation_noise_variances(reparameterize=False)
    for i, k in enumerate(pm.covariance_kernels(reparameterize=False)):
        nodes = list(GP.split_kernel_sop(k, GP.Periodic))
        blocks = [torch.as_tensor(np.stack([f(kk) for kk in nodes]))[None]
                  for f in (lambda kk: GP.eval_cov(kk, ts),
                            lambda kk: GP.eval_cov(kk, ts, tsp),
                            lambda kk: GP.eval_cov(kk, tsp))]
        npred = None if noise_pred is None else torch.tensor([noise_pred])
        mu, cv = TGM.infer_gp_sum_from_blocks(
            *blocks, torch.tensor([noises[i]]), torch.as_tensor(xs),
            torch.ones(len(ts), dtype=F64), noise_pred=npred)
        mu, cv = pm.y_transform.unapply_mean_var(mu[0].numpy(), cv[0].numpy())
        mu[ip["F"][0]] += pm.y_transform.intercept / pm.y_transform.slope
        np.testing.assert_allclose(mp.components[i].mean, mu, rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(mp.components[i].cov, cv, rtol=1e-7,
                                   atol=1e-12)


def test_predict_mvn_sum_deep_components():
    """Components deeper than kernel 1's bound of 8 levels, which the
    plain version takes on the CPU (on the card cov_tape raises): a
    particle whose Periodic split is 9 levels deep, against the float64
    host construction of its blocks."""
    inner = GP.ChangePoint(GP.Periodic(0.3, 0.2, 1.0),
                           GP.Linear(0.1, 0.2, 0.3), 0.4, 1e-3)
    k = inner
    for i in range(3):
        k = (k + GP.SquaredExponential(0.2 + 0.1 * i, 0.8)) * (
            GP.Periodic(0.4, 0.3 + 0.1 * i, 0.9) + GP.Linear(0.2, 0.3, 0.4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = A.GPConfig(static_max_depth=k.depth)
    ds = np.linspace(0, 3, 20)
    m = A.GPModel(ds, np.cos(2 * ds), n_particles=1, config=cfg,
                  device="cpu")
    m = A.gp_model_from_kernels(m, [k])
    comps = A.api.sum_components(m, GP.Periodic)[0]
    assert max(c.depth for c in comps) > cov.MAX_DEPTH
    ds_pred = np.linspace(3, 3.5, 4)
    mix, idx = A.predict_mvn_sum(m, ds_pred, GP.Periodic)
    ts, xs, tsp = m._ds_numeric(), m._y_numeric(), m._ds_numeric(ds_pred)
    nodes = GP.split_kernel_sop(k, GP.Periodic)
    blocks = [torch.as_tensor(np.stack([f(kk) for kk in nodes]))[None]
              for f in (lambda kk: GP.eval_cov(kk, ts),
                        lambda kk: GP.eval_cov(kk, ts, tsp),
                        lambda kk: GP.eval_cov(kk, tsp))]
    noise = m.observation_noise_variances(reparameterize=False)
    mu, cv = TGM.infer_gp_sum_from_blocks(
        *blocks, torch.tensor(noise), torch.as_tensor(xs),
        torch.ones(len(ts), dtype=F64))
    mu, cv = m.y_transform.unapply_mean_var(mu[0].numpy(), cv[0].numpy())
    mu[idx["F"][0]] += m.y_transform.intercept / m.y_transform.slope
    np.testing.assert_allclose(mix.components[0].mean, mu, rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(mix.components[0].cov, cv, rtol=1e-7,
                               atol=1e-10)


def test_balance_sums_preserves_covariance():
    """Port of test_balance_sums_preserves_covariance."""
    k = (GP.Periodic(0.7, 0.3, 1.1) + GP.Linear(0.2, 0.5, 0.9)
         + GP.GammaExponential(0.4, 0.6, 0.8) + GP.Constant(0.3)
         + GP.SquaredExponential(0.5, 1.2))
    b = A.api._balance_sums(k)
    assert b.depth < k.depth
    ts = np.linspace(0, 3, 17)
    np.testing.assert_allclose(GP.eval_cov(b, ts), GP.eval_cov(k, ts),
                               rtol=1e-12)


def test_constant_zero_pad_transforms_to_zero():
    """A Constant(0) pad encodes as z = -inf; its float64 transform is
    exactly 0, the rest of the heap finite."""
    cfg = A.GPConfig(max_depth=2)
    with np.errstate(divide="ignore"):
        nt, pz = TT.node_to_tensor(GP.Constant(0.0) + GP.Periodic(1, 1, 1),
                                   cfg)
    assert pz[1, 0] == -np.inf
    pt = TM.transform_params(torch.as_tensor(nt)[None],
                             torch.as_tensor(pz)[None],
                             TM.prior_tables(cfg, "cpu", F64))
    assert torch.isfinite(pt).all() and float(pt[0, 1, 0]) == 0.0
    np.testing.assert_allclose(pt[0, 2].numpy(), [1.0, 1.0, 1.0],
                               rtol=1e-12)


def test_gp_sum_jitters_tried_per_particle():
    """`jitter` as a sequence: each particle keeps the first jitter whose
    joint factorizes. Particle 1's latent blocks are shifted down by the
    posterior's smallest eigenvalue plus 5e-7 (negative eigenvalues, as
    float32 rounding of the blocks leaves them): SUM_GP_JITTER alone gives
    it NaN; the float32 sequence gives both particles what their own first
    working jitter gives, bitwise, and particle 0 the reference's 1e-8
    result."""
    ks, ts, tsp, noise, xs, Ktt, Ktp, Kpp = _sum_case()
    p = len(tsp)
    blocks = [torch.as_tensor(b)[None] for b in (Ktt, Ktp, Kpp)]
    _, cv0 = TGM.infer_gp_sum_from_blocks(
        *blocks, torch.tensor([noise]), torch.as_tensor(xs),
        torch.ones(len(ts), dtype=F64))
    shift = float(torch.linalg.eigvalsh(cv0[0])[0]) + 5e-7
    shifted = Kpp - shift * np.eye(p)
    blocks = [torch.as_tensor(np.stack(b)) for b in
              ((Ktt, Ktt), (Ktp, Ktp), (Kpp, shifted))]

    def run(jitter, sel=slice(None)):
        return TGM.infer_gp_sum_from_blocks(
            *(b[sel] for b in blocks), torch.full((2,), noise,
                                                  dtype=F64)[sel],
            torch.as_tensor(xs), torch.ones(len(ts), dtype=F64),
            jitter=jitter)

    ladder = TGM.sum_gp_jitters(torch.float32)
    assert ladder == (1e-8, 1e-7, 1e-6, 1e-5) == A.config.SUM_GP_JITTERS_F32
    assert TGM.sum_gp_jitters(F64) == (1e-8,)
    _, cv_ref = run((1e-8,))
    assert torch.isfinite(cv_ref[0]).all() and torch.isnan(cv_ref[1]).all()
    mu, cv = run(ladder)
    assert torch.isfinite(cv).all()
    assert torch.equal(cv[0], cv_ref[0])
    first = next(j for j in ladder
                 if torch.isfinite(run((j,), slice(1, 2))[1]).all())
    assert first > 1e-8
    mu1, cv1 = run((first,), slice(1, 2))
    assert torch.equal(cv[1], cv1[0]) and torch.equal(mu[1], mu1[0])
