"""Parameter HMC on the iclaims fit, held to the JAX package's sampler.

In chip_smoke.py's full-budget iclaims fit (autogp_tpu_torch/scripts/
tutorials/iclaims.py: P = 8, linear_schedule(354, .20), n_mcmc=50,
n_hmc=10) on an H100, parameter HMC with the reference's step (eps 0.02,
L 10) accepts 440 of 441 and 251 of 331 trajectories in the 71- and
142-point rounds and none from the 213-point round on. This file replays
the first trajectory of the 284-point round (the first round above 256
points; one live particle) on the CPU in float64 through the JAX
package's `hmc_params_step` and through the port's `params_trajectory`
fed the same draws, from the state read off the card (float32): both
packages reject both trajectories in float64 too, so the rejections are
the sampler's (its step on this posterior), not the card's float32.

Marked slow: the depth-5 heap at N = 512 takes 8-11 minutes on the CPU,
the JAX package's compile and float64 gradients most of it.
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
from autogp_tpu_torch import api
from autogp_tpu_torch import config as C
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.inference import hmc, smc
from autogp_tpu_torch.scripts.tutorials import _common

F64 = torch.float64

# Times(Linear, Times(Linear, Plus(Periodic, Plus(Linear, Linear)))) by
# heap slot (node type, z-space parameters), and the z-space noise.
STATE = {
    0: (C.TIMES, (0.0, 0.0, 0.0)),
    1: (C.LINEAR, (-0.8013361692428589, -0.2729651927947998,
                   -0.12031883746385574)),
    2: (C.TIMES, (0.0, 0.0, 0.0)),
    5: (C.LINEAR, (0.08782946318387985, 0.40000811219215393,
                   0.7216885089874268)),
    6: (C.PLUS, (0.0, 0.0, 0.0)),
    13: (C.PERIODIC, (-0.6853798627853394, -0.41665637493133545,
                      -0.7228582501411438)),
    14: (C.PLUS, (0.0, 0.0, 0.0)),
    29: (C.LINEAR, (-0.2530513405799866, -0.6185780167579651,
                    -0.7267672419548035)),
    30: (C.LINEAR, (-1.429768443107605, 0.0015929446090012789,
                    -1.6115952730178833))}
NOISE_Z = -5.039220809936523


@pytest.fixture(autouse=True)
def _torch_cpu_f64():
    torch.set_num_threads(1)


def _data():
    """The iclaims flow's training data (log weekly claims, the first 354
    weeks), shuffled as fit_smc shuffles it after api.seed(10), its first
    284 points in the 512 bucket, rescaled by GPModel."""
    df = _common.load_iclaims()
    y = np.log(df["y"].to_numpy())
    df_train, _ = _common.train_test_split(df.assign(y=y), 0.8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = api.GPModel(df_train["ds"], df_train["y"].to_numpy(),
                        n_particles=1, device="cpu")
    perm = np.random.default_rng(10).permutation(len(df_train))
    return smc.make_dataset(m._ds_numeric()[perm], m._y_numeric()[perm],
                            n=284, pad_to=512, dtype=F64, device="cpu")


@pytest.mark.slow  # 450-650 s on the CPU (see the module docstring)
def test_iclaims_params_trajectory_agrees_with_jax():
    """Two trajectories from the recorded state, on two JAX keys: the JAX
    package's hmc_params_step rejects both, and the port's
    params_trajectory on the same draws (k_mom, k_acc = split(key),
    normal(k_mom) * pmask, uniform(k_acc)) rejects the same ones and
    returns the start unchanged. The data are the card's up to float32 rounding
    (sum of the times and first values, rtol 1e-6), and the state's LML
    is the card's cached one (rtol 1e-4)."""
    data = _data()
    ts, xs, mask = data.ts, data.xs, data.mask
    assert int(mask.sum()) == 284 and ts.shape[0] == 512
    np.testing.assert_allclose(float(ts.sum()), 140.43909319257364,
                               rtol=1e-6)
    np.testing.assert_allclose(
        xs[:4].numpy(), [-0.21500177681446075, -0.2576393485069275,
                         -0.08230092376470566, 0.12134511023759842],
        rtol=1e-6)
    P = 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg, jcfg = C.GPConfig(), JC.GPConfig()
    tab, jtab = TM.prior_tables(cfg, "cpu", F64), JM.prior_tables(jcfg)
    assert cfg.depth_cap == 5
    nt = np.zeros((P, 31), np.int64)
    pz = np.zeros((P, 31, 3))
    for slot, (t, v) in STATE.items():
        nt[:, slot], pz[:, slot] = t, v
    nz = np.full(P, NOISE_Z)
    d = (ts, xs, mask)
    lml = TM.lml(torch.as_tensor(nt), torch.as_tensor(pz),
                 torch.as_tensor(nz), *d, cfg, tab)
    np.testing.assert_allclose(lml.numpy(), 404.20269775390625, rtol=1e-4)
    keys = jax.random.split(jax.random.PRNGKey(284), P)
    step = jax.jit(jax.vmap(
        lambda k, a, b, c, l, dd: JH.hmc_params_step(
            k, a, b, c, l, dd, jcfg, jtab, 0.02, 10),
        in_axes=(0, 0, 0, 0, 0, None)))
    jq, jl, jacc = step(keys, jnp.asarray(nt), jnp.asarray(pz),
                        jnp.asarray(nz), jnp.asarray(lml.numpy()),
                        tuple(jnp.asarray(t.numpy()) for t in d))

    def draws(k, a):
        k_mom, k_acc = jax.random.split(k)
        pmask = JT.param_mask(a).astype(jnp.float64)
        return (jax.random.normal(k_mom, (a.shape[0], 3), jnp.float64)
                * pmask, jax.random.uniform(k_acc))
    mom0, u = jax.vmap(draws)(keys, jnp.asarray(nt))
    q, lm, acc = hmc.params_trajectory(
        torch.as_tensor(nt), torch.as_tensor(pz), torch.as_tensor(nz), lml,
        d, cfg, tab, 0.02, 10, torch.tensor(np.asarray(mom0)),
        torch.tensor(np.asarray(u)))
    assert not np.asarray(jacc).any()
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(q.numpy(), pz)
    np.testing.assert_array_equal(np.asarray(jq), pz)
    assert torch.equal(lm, lml)
