"""Parameter and noise HMC of the port (autogp_tpu_torch.inference.hmc),
held to the JAX package on the CPU in float64.

The samplers cannot replay JAX's threefry draws, so the deterministic
trajectory functions are fed the JAX package's own momenta and uniforms:
the test splits each particle's key as hmc.py does (k_mom, k_acc =
split(key); normal(k_mom) * pmask; uniform(k_acc)) and hands the draws to
the port. Stationarity with no data and batch independence (what the
port's per-sweep compaction relies on) are held by their own oracles.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autogp_tpu import config as JC
from autogp_tpu import model as JM
from autogp_tpu import tree as JT
from autogp_tpu.inference import hmc as JH
from autogp_tpu_torch import config as C
from autogp_tpu_torch import kernels as K
from autogp_tpu_torch import model as TM
from autogp_tpu_torch import tree as TT
from autogp_tpu_torch.inference import hmc, smc

F64 = torch.float64


@pytest.fixture(autouse=True)
def _torch_cpu_f64():
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _cfgs(**kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return C.GPConfig(**kw), JC.GPConfig(**kw)


def _setup(N, P, seed):
    """Prior trees (depth 3), noise and data of N points (3/4 active):
    numpy arrays for both packages plus the port's cached LMLs."""
    cfg, jcfg = _cfgs(max_depth=3)
    tab = TM.prior_tables(cfg, "cpu", F64)
    gen = torch.Generator().manual_seed(seed)
    nt, pz = TM.sample_tree(gen, P, tab, F64, "cpu")
    rng = np.random.default_rng(seed)
    nz = rng.normal(-1.0, 0.5, P)
    n = 3 * N // 4
    ts, xs = np.linspace(0, 1, n), np.zeros(n)
    xs[:] = np.sin(2 * np.pi * 2 * ts) + 0.1 * rng.standard_normal(n)
    data = smc.make_dataset(ts, xs, n=n, pad_to=N, dtype=F64, device="cpu")
    d = (data.ts, data.xs, data.mask)
    lml = TM.lml(nt, pz, torch.as_tensor(nz), *d, cfg, tab)
    arrays = (nt.numpy(), pz.numpy(), nz, lml.numpy())
    jd = tuple(jnp.asarray(t.numpy()) for t in d)
    return cfg, jcfg, tab, JM.prior_tables(jcfg), d, jd, arrays


def _keys(P, seed):
    return jax.random.split(jax.random.PRNGKey(seed), P)


def test_params_trajectory_matches_jax():
    """params_trajectory on JAX's draws against hmc_params_step, P=6,
    N=32, eps=0.1, L=5: positions and LMLs within 1e-9, accept decisions
    equal (float64; the same leapfrog in the same arithmetic order, the
    gradient from LmlTapeFused's plain path vs XLA autodiff)."""
    P, eps, L = 6, 0.1, 5
    cfg, jcfg, tab, jtab, d, jd, (nt, pz, nz, lml) = _setup(32, P, seed=3)
    keys = _keys(P, 17)
    step = jax.jit(jax.vmap(lambda k, a, b, c, l: JH.hmc_params_step(
        k, a, b, c, l, jd, jcfg, jtab, eps, L)))
    jq, jl, jacc = step(keys, jnp.asarray(nt), jnp.asarray(pz),
                        jnp.asarray(nz), jnp.asarray(lml))

    def draws(k, a):
        k_mom, k_acc = jax.random.split(k)
        pmask = JT.param_mask(a).astype(jnp.float64)
        return (jax.random.normal(k_mom, (a.shape[0], 3), jnp.float64)
                * pmask, jax.random.uniform(k_acc))
    mom0, u = jax.vmap(draws)(keys, jnp.asarray(nt))
    q, lm, acc = hmc.params_trajectory(
        torch.as_tensor(nt), torch.as_tensor(pz), torch.as_tensor(nz),
        torch.as_tensor(lml), d, cfg, tab, eps, L,
        torch.tensor(np.asarray(mom0)), torch.tensor(np.asarray(u)))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(lm.numpy(), np.asarray(jl), rtol=1e-9)
    assert 0 < int(acc.sum()) < P    # both branches of the test ran


@pytest.mark.parametrize("N", [32, 64], ids=["autograd", "K0"])
def test_noise_trajectory_matches_jax(N):
    """noise_trajectory on JAX's draws against hmc_noise_step, P=6,
    eps=0.3, L=5, at N=32 (noise gradient by autograd) and N=64 (K0
    assembled once, closed-form gradient): noise and LMLs within 1e-9,
    accept decisions equal."""
    P, eps, L = 6, 0.3, 5
    cfg, jcfg, tab, jtab, d, jd, (nt, pz, nz, lml) = _setup(N, P, seed=N)
    keys = _keys(P, N + 1)
    step = jax.jit(jax.vmap(lambda k, a, b, c, l: JH.hmc_noise_step(
        k, a, b, c, l, jd, jcfg, jtab, eps, L)))
    jz, jl, jacc = step(keys, jnp.asarray(nt), jnp.asarray(pz),
                        jnp.asarray(nz), jnp.asarray(lml))

    def draws(k):
        k_mom, k_acc = jax.random.split(k)
        return (jax.random.normal(k_mom, (), jnp.float64),
                jax.random.uniform(k_acc))
    mom0, u = jax.vmap(draws)(keys)
    z, lm, acc = hmc.noise_trajectory(
        torch.as_tensor(nt), torch.as_tensor(pz), torch.as_tensor(nz),
        torch.as_tensor(lml), d, cfg, tab, eps, L,
        torch.tensor(np.asarray(mom0)), torch.tensor(np.asarray(u)))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(lm.numpy(), np.asarray(jl), rtol=1e-9)


def test_hmc_no_data_stationary_normal():
    """Port of tests/test_inference.py:129-163: with empty data the
    parameter and noise kernels target N(0, 1) exactly. 128 chains of
    Linear * Periodic from a fixed point, 8 rounds of 5 sweeps with
    eps * L ~ pi / 2 (nearly independent draws): the mean of the 7 x 128
    final values within 0.1 of 0 and their std within 0.1 of 1 (~3
    standard errors)."""
    cfg, _ = _cfgs(max_depth=2)
    tab = TM.prior_tables(cfg, "cpu", F64)
    P = 128
    nt, pz = TT.node_to_tensor(K.Linear(0.5) * K.Periodic(1.0, 1.0), cfg)
    nt = torch.as_tensor(nt).expand(P, -1).clone()
    pz = torch.as_tensor(pz).expand(P, -1, -1).clone()
    nz = torch.zeros(P)
    data = smc.make_dataset(np.zeros(0), np.zeros(0), n=0, pad_to=8,
                            dtype=F64, device="cpu")
    d = (data.ts, data.xs, data.mask)
    lml = torch.zeros(P)
    cfg_h = hmc.HMCConfig(n_exit=10 ** 9, eps_param=0.157, L_param=10,
                          eps_noise=0.157, L_noise=10)
    gen = torch.Generator().manual_seed(4)
    for _ in range(8):
        pz, nz, lml, _, sweeps = hmc.rejuvenate_parameters(
            gen, nt, pz, nz, lml, d, cfg, tab, 5, cfg_h, infer_noise=True)
        assert (sweeps == 5).all()
    pmask = TT.param_mask(nt).numpy()
    flat = np.concatenate([pz.numpy()[pmask > 0], nz.numpy()])
    assert abs(flat.mean()) < 0.1, flat.mean()
    assert abs(flat.std() - 1.0) < 0.1, flat.std()


def test_hmc_compaction_matches_uncompacted():
    """Port of test_hmc_compaction_matches_uncompacted: each sweep runs on
    the gathered live particles only, with per-lane rows of batch-wide
    draws, so a particle's result must not depend on which others run.
    The batch with four particles enabled against the same batch with
    only particle i enabled, for each of the four: equal to 1e-12
    (float64; the same per-particle arithmetic in batches of different
    sizes); disabled particles are untouched and some HMC ran."""
    P = 6
    cfg, _, tab, _, d, _, (nt, pz, nz, lml) = _setup(32, P, seed=5)
    nt, pz, nz, lml = map(torch.as_tensor, (nt, pz, nz, lml))
    cfg_h = hmc.HMCConfig(L_param=3, L_noise=3, n_exit=1)

    def run(enabled):
        return hmc.rejuvenate_parameters(
            torch.Generator().manual_seed(11), nt, pz, nz, lml, d, cfg, tab,
            3, cfg_h, infer_noise=True, enabled=enabled)
    enabled = torch.tensor([True, False, True, True, False, True])
    out = run(enabled)
    assert int(out[4].sum()) > 0
    for i in range(P):
        if not enabled[i]:
            assert torch.equal(out[0][i], pz[i]) and out[4][i] == 0
            continue
        one = run(torch.arange(P) == i)
        for a, b in zip(out, one):
            np.testing.assert_allclose(a[i].numpy(), b[i].numpy(),
                                       rtol=1e-12, atol=1e-14)
