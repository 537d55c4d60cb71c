"""The port's HMC ground-truth experiment (BASELINE config 2's workload)
against scripts/experiment_hmc.py (CPU, float64).

The port of tests/test_experiment_hmc.py, and the Bayes-rule terms and the
prior draw's scores equal to the JAX script's on the same seed: both
packages simulate the same observations with numpy."""

import os
import sys

import numpy as np
import pytest
import torch

from autogp_tpu import GP as JGP
from autogp_tpu_torch.scripts import experiment_hmc

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "scripts"))


@pytest.fixture(autouse=True)
def _torch_cpu_f64():
    torch.set_num_threads(1)
    yield


def test_hmc_ground_truth_recovery_fast():
    """Port of test_hmc_ground_truth_recovery_fast: bench 1 at n = 160,
    64 observed, 40 steps; the Bayes-rule oracle is asserted inside run()
    at the float64 tolerance."""
    m = experiment_hmc.run(bench=1, n=160, n_obs=64, n_steps=40, seed=0,
                           verbose=False, device="cpu")
    assert abs(m["lp_true"] - m["lp_bayes"]) < max(
        1e-6 * abs(m["lp_bayes"]), 1e-3)
    assert m["acc_rate"] > 0.2, m
    assert m["lml_final"] > m["lml_init"], m
    gap0 = m["lp_true"] - m["lp_init"]
    gap1 = m["lp_true"] - m["lp_final"]
    assert gap0 > 0, m
    assert gap1 < 0.3 * gap0, m


def test_bayes_terms_match_the_jax_script():
    """Bench 2 (Linear + Periodic) on the same seed: lp_bayes, lp_true and
    the prior draw's lp_init and lml_init equal the JAX script's within
    rtol 1e-9 (one HMC step each; the steps' draws differ)."""
    import experiment_hmc as jax_script

    kw = dict(bench=2, n=160, n_obs=64, n_steps=1, seed=0, verbose=False)
    mj = jax_script.run(**kw)
    mp = experiment_hmc.run(**kw, device="cpu")
    for k in ("lp_bayes", "lp_true", "lp_init", "lml_init"):
        np.testing.assert_allclose(mp[k], mj[k], rtol=1e-9, err_msg=k)
    assert mp["lp_bayes"] != mp["lp_true"]


def test_config2_problem_is_the_baseline_data():
    """config2_problem draws BASELINE config 2's observations as
    scripts/bench_configs.py:181-190 does (the JAX package's covariance
    evaluator, numpy seed 2), and encodes in a depth-3 heap."""
    ts, xs, node, cfg = experiment_hmc.config2_problem()
    rng = np.random.default_rng(2)
    jnode = JGP.Linear(0.3, 0.9, 0.8) + JGP.Periodic(0.8, 0.25, 1.1)
    want = rng.multivariate_normal(
        np.zeros(500), JGP.compute_cov_matrix_vectorized(jnode, 0.05, ts))
    np.testing.assert_array_equal(xs, want)
    assert ts.shape == (500,) and cfg.max_depth == 3
    assert str(node) == str(jnode)


def test_float32_driver_on_config2_joint_gram():
    """The blocked driver on config 2's float32 joint gram (1000 of 1024
    points, condition ~6e5): the LML within 2e-2 of float64 on the same
    float32 gram (float32 trailing updates gave 0.17)."""
    from autogp_tpu_torch.ops import chol
    from autogp_tpu_torch.scripts import chol_ab
    K, x = chol_ab.joint_gram(0, "cpu")
    ref = chol_ab.lml(*chol.chol_solve_diag(K.double(), x.double()))
    assert abs(chol_ab.lml(*chol.chol_solve_diag(K, x)) - ref) < 2e-2
