"""greedy_mcmc_rejuvenate of the port fed the JAX package's proposals: the
reference draws its subtree-replace proposal from a jax.random key, which
a torch.Generator cannot replay, so the test rebuilds each key's proposal
with the JAX package's own samplers and hands it to the port; the
optimized result, the AIC and the accept decision must be the
reference's (CPU, float64)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autogp_tpu import config as JC
from autogp_tpu import model as JM
from autogp_tpu import tree as JT
from autogp_tpu.inference import greedy as JG
from autogp_tpu.inference import moves as JMV
from autogp_tpu.inference import smc as JS
from autogp_tpu_torch import config as TC
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.inference import greedy as TG
from autogp_tpu_torch.inference import smc as TS

F64 = torch.float64


@pytest.fixture(autouse=True)
def _torch_cpu():
    torch.set_num_threads(1)


def test_greedy_mcmc_rejuvenate_matches_the_jax_package():
    """Six keys from one state Plus(Linear, Periodic) at depth cap 3 on a
    40-point near-linear series (the 64-point bucket: the fused gradient
    route): for each key the JAX package's greedy_mcmc_rejuvenate, and
    the port's on the proposal that key draws. Same accept decisions,
    AICs, LMLs and optimized parameters within 1e-8 relative; some
    proposals accepted and some rejected (the state's AIC is its own
    optimum's).

    The series is smooth on purpose: on a stiff proposal the reference's
    full 0.1 steps overshoot (the score falls to ~-1e5 before the
    backtracking finds a gain), so each accepted round multiplies a
    rounding difference by ~1e2 and ten rounds turn the two packages'
    1e-15 into 1e-3 (ROADMAP.md Queue 3, watch list)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jc = JC.GPConfig(max_depth=3, changepoints=False)
        tc = TC.GPConfig(max_depth=3, changepoints=False)
    n = 40
    ts = np.linspace(0, 1, n)
    xs = 2.0 * ts + 0.05 * np.random.default_rng(5).standard_normal(n)
    xs = (xs - xs.mean()) / (xs.max() - xs.min())
    jtab, ttab = JM.prior_tables(jc), TM.prior_tables(tc, "cpu", F64)
    jd = JS.make_dataset(ts, xs, dtype=jnp.float64)
    td = TS.make_dataset(ts, xs, dtype=F64, device="cpu")

    nt = np.zeros(tc.max_nodes, np.int64)
    pz = np.zeros((tc.max_nodes, 3))
    nt[:3] = [6, 2, 5]
    pz[1] = [0.1, -0.2, 0.3]
    pz[2] = [-0.4, 0.2, 0.1]
    nz = -1.0
    # The state after its own <= 10-round optimization (as
    # fit_greedy_mcmc starts), in the port; its AIC and LML feed both.
    res = TG.map_optimize(torch.as_tensor(nt)[None],
                          torch.as_tensor(pz)[None],
                          torch.tensor([nz], dtype=F64), td, tc, ttab, True,
                          max_rounds=TG.MAX_OPT_MCMC)
    pz, nz = res.params_z[0].numpy(), float(res.noise_z[0])
    lml = float(res.lml[0])
    aic = float(TG.compute_aic(res.lml[0], TG.n_params(nt, True)))

    keys = jax.random.split(jax.random.PRNGKey(11), 6)
    jnt, jpz = jnp.asarray(nt, jnp.int32), jnp.asarray(pz)

    def proposal(key):   # the first lines of JG.greedy_mcmc_rejuvenate
        k_pick, k_sub = jax.random.split(key)
        sizes = JT.subtree_sizes(jnt).astype(jpz.dtype)
        idx, _ = JMV.sample_pick_node(k_pick, jnt, sizes, False,
                                      jtab.depth_cap)
        gate = JMV.cp_gate_at(jnt, idx, jc.changepoints)
        return JM.sample_subtree(k_sub, jnt, jpz, jtab, root_idx=idx,
                                 root_cp_allowed=gate)

    nt2, pz2 = jax.jit(jax.vmap(proposal))(keys)
    want = jax.jit(jax.vmap(lambda k: JG.greedy_mcmc_rejuvenate(
        k, jnt, jpz, jnp.float64(nz), jnp.float64(aic), jnp.float64(lml),
        jd, jc, jtab, False, True)))(keys)
    w_nt, w_pz, w_nz, w_aic, w_lml, w_acc = map(np.asarray, want)

    got = TG.greedy_mcmc_rejuvenate(
        torch.as_tensor(nt), torch.as_tensor(pz),
        torch.tensor(nz, dtype=F64), torch.tensor(aic, dtype=F64),
        torch.tensor(lml, dtype=F64),
        (torch.as_tensor(np.asarray(nt2), dtype=torch.int64),
         torch.as_tensor(np.asarray(pz2))), td, tc, ttab, True)
    g_nt, g_pz, g_nz, g_aic, g_lml, g_acc = (t.numpy() for t in got)
    np.testing.assert_array_equal(g_acc, w_acc)
    assert 0 < w_acc.sum() < len(w_acc)
    np.testing.assert_array_equal(g_nt, w_nt)
    np.testing.assert_allclose(g_aic, w_aic, rtol=1e-8)
    np.testing.assert_allclose(g_lml, w_lml, rtol=1e-8)
    np.testing.assert_allclose(g_nz, w_nz, rtol=1e-8)
    np.testing.assert_allclose(g_pz, w_pz, rtol=1e-8, atol=1e-10)
