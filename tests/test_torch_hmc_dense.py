"""Parameter HMC on dense data, held to the JAX package's own sampler.

In chip_smoke.py's config-4 fit (seed 1) on an H100, parameter HMC with
the reference's step (eps 0.02, L 10) accepts no trajectory from the
512-point round on. This file replays the first trajectory of that round
on the CPU in float64 through the JAX package's `hmc_params_step` and
through the port's `params_trajectory` fed the same draws.

The state is the one read off the card (float32) at that trajectory:
five of the six first particles of its 24-particle batch are copies of
the tree below, the sixth is that tree times a Linear kernel, whose
depth-4 heap costs several times more to replay on the CPU and is left
out. The tree fits in a depth-3 heap, which changes neither its LML nor
its gradient (only the structure prior, which HMC does not read).
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

F64 = torch.float64

# Plus(GammaExponential, Plus(Linear, Periodic)) as heap node types, its
# z-space parameters by heap slot, and the z-space noise.
NODE_TYPES = [C.PLUS, C.GAMMA_EXPONENTIAL, C.PLUS, 0, 0, C.LINEAR,
              C.PERIODIC]
PARAMS_Z = {
    1: (-0.014835238456726074, 1.273634433746338, -0.7302975654602051),
    5: (-0.5002483129501343, -0.07137741148471832, 0.6745887398719788),
    6: (0.7335150837898254, -0.7817524075508118, 0.7357357740402222)}
NOISE_Z = -5.870829105377197


@pytest.fixture(autouse=True)
def _torch_cpu_f64():
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _data():
    """chip_smoke.py's series (numpy seed 0), shuffled as fit_smc does
    after api.seed(1), its first 512 points, rescaled by GPModel."""
    rng = np.random.default_rng(0)
    rng.standard_normal(1024)             # chip_smoke.py's phase-4 draw
    t = np.arange(1024, dtype=np.float64)
    y = (0.02 * t + 3.0 * np.sin(2 * np.pi * t / 52.0)
         + 1.5 * np.sin(2 * np.pi * t / 13.0)
         + 0.5 * rng.standard_normal(1024))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = api.GPModel(t, y, n_particles=1, device="cpu")
    perm = np.random.default_rng(1).permutation(1024)
    return smc.make_dataset(m._ds_numeric()[perm], m._y_numeric()[perm],
                            n=512, pad_to=512, dtype=F64, device="cpu")


def test_dense_data_params_trajectory_rejected_like_jax():
    """Two trajectories from the recorded state, on two JAX keys: the JAX
    package's hmc_params_step rejects both, and the port's
    params_trajectory on the same draws (k_mom, k_acc = split(key),
    normal(k_mom) * pmask, uniform(k_acc)) rejects the same ones and
    returns the start unchanged. The data are the card's up to float32
    rounding: their sum and first values are those the card held (rtol
    1e-6), and the state's LML is the card's cached one (rtol 1e-4: the
    card's LML is of float32 data)."""
    data = _data()
    ts, xs, mask = data.ts, data.xs, data.mask
    assert int(mask.sum()) == 512
    np.testing.assert_allclose(float(ts.sum()), 257.98338198754936,
                               rtol=1e-6)
    np.testing.assert_allclose(
        xs[:4].numpy(), [-0.15156613290309906, -0.051624082028865814,
                         -0.011215233244001865, -0.16154998540878296],
        rtol=1e-6)
    P = 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg, jcfg = C.GPConfig(max_depth=3), JC.GPConfig(max_depth=3)
    tab, jtab = TM.prior_tables(cfg, "cpu", F64), JM.prior_tables(jcfg)
    nt = np.tile(np.asarray(NODE_TYPES, np.int64), (P, 1))
    pz = np.zeros((P, len(NODE_TYPES), 3))
    for slot, v in PARAMS_Z.items():
        pz[:, slot] = v
    nz = np.full(P, NOISE_Z)
    d = (ts, xs, mask)
    lml = TM.lml(torch.as_tensor(nt), torch.as_tensor(pz),
                 torch.as_tensor(nz), *d, cfg, tab)
    # The card's cached LML of this state, up to the float32 data.
    np.testing.assert_allclose(lml.numpy(), 996.2282104492188, rtol=1e-4)
    keys = jax.random.split(jax.random.PRNGKey(512), P)
    step = jax.jit(jax.vmap(
        lambda k, a, b, c, l, dd: JH.hmc_params_step(
            k, a, b, c, l, dd, jcfg, jtab, 0.02, 10),
        in_axes=(0, 0, 0, 0, 0, None)))
    jq, jl, jacc = step(keys, jnp.asarray(nt), jnp.asarray(pz),
                        jnp.asarray(nz), jnp.asarray(lml.numpy()),
                        tuple(jnp.asarray(t.numpy()) for t in d))
    assert not np.asarray(jacc).any()
    np.testing.assert_array_equal(np.asarray(jq), pz)

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
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(q.numpy(), pz)
    assert torch.equal(lm, lml)
