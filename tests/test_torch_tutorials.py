"""The port's executable tutorials (autogp_tpu_torch/scripts/tutorials/)
on the vendored datasets, in FAST mode on the CPU in float64.

The counterpart of tests/test_tutorials.py for the port: each flow runs
with the JAX flow's FAST sizes and seeds and keeps its script's own
asserts (callbacks: the band narrows; decomposition: the parts sum to the
whole; greedy_mcmc: the AIC does not increase; iclaims: the quantiles are
ordered and the log-normal mean bias is >= 0). The full-budget iclaims
fit runs on the card in chip_smoke.py (phase `tutorials`).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from autogp_tpu_torch.scripts.tutorials import (
    callbacks, decomposition, greedy_mcmc, iclaims, overview)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _on_cpu_f64(model):
    assert model.device.type == "cpu" and model.dtype == torch.float64


def test_overview():
    r = overview.run(True, device="cpu")
    m = r["model"]
    _on_cpu_f64(m)
    assert m.num_particles == 2 and len(m.ds) == len(r["df"])
    assert r["mvn"].n_components == 2
    assert r["mvn"].dim == len(r["df_test"])
    assert np.isfinite(r["logps"]["logp"].to_numpy()).all()


def test_decomposition():
    r = decomposition.run(True, device="cpu")
    _on_cpu_f64(r["model"])
    assert len(r["decomposed"]) == 2 and len(r["frags"]) >= 1
    np.testing.assert_allclose(r["overall"], r["parts"], rtol=1e-4,
                               atol=1e-6)


def test_callbacks():
    r = callbacks.run(True, device="cpu")
    h = r["history"]
    _on_cpu_f64(r["model"])
    assert [x["step"] for x in h][0] == 0
    assert h[-1]["mean_band"] < h[0]["mean_band"]


def test_iclaims():
    r = iclaims.run(True, device="cpu")
    _on_cpu_f64(r["model"])
    assert np.all(r["lo"] <= r["md"]) and np.all(r["md"] <= r["hi"])
    assert np.all(r["bias"] >= -1e-8)
    assert len(r["ds_q"]) == len(r["lo"]) == r["mvn"].dim


def test_greedy_mcmc_and_mcmc_parts():
    """fit_greedy_mcmc (AIC non-increasing) and fit_mcmc (its callback at
    each step some chain accepted) of the greedy_mcmc flow."""
    r = greedy_mcmc.run(True, device="cpu", parts=("greedy_mcmc", "mcmc"))
    a = r["hybrid_aics"]
    assert len(a) >= 1 and all(y <= x + 1e-9 for x, y in zip(a, a[1:]))
    assert r["steps_seen"] and r["steps_seen"] == sorted(r["steps_seen"])
    _on_cpu_f64(r["model2"])


@pytest.mark.slow  # fit_greedy(max_depth=2) on 48 points: ~95 s, one core
def test_greedy_search_part():
    r = greedy_mcmc.run(True, device="cpu", parts=("greedy",))
    aics = [a for _, a in r["aic_trace"]]
    assert aics and all(b <= a + 1e-9 for a, b in zip(aics, aics[1:]))


def test_iclaims_main_prints_its_marker():
    """`python -m autogp_tpu_torch.scripts.tutorials.iclaims` with
    AUTOGP_TUTORIAL_FAST=1 runs the flow on the CPU and prints the JAX
    flow's OK marker."""
    env = dict(os.environ, AUTOGP_TUTORIAL_FAST="1", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "autogp_tpu_torch.scripts.tutorials.iclaims"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "ICLAIMS TUTORIAL OK" in proc.stdout
