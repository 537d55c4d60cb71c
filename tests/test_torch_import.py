"""The PyTorch port never imports jax or the JAX package, and its copies
of the JAX package's JAX-free modules keep the same tables.

The import checks run in a subprocess: tests/conftest.py imports jax into
this process, so sys.modules here says nothing about the port."""

import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import autogp_tpu_torch
from autogp_tpu import config as JC
from autogp_tpu_torch import config as TC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    names = ["autogp_tpu_torch"]
    for info in pkgutil.walk_packages(autogp_tpu_torch.__path__,
                                      prefix="autogp_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_without_jax():
    names = _all_modules()
    assert "autogp_tpu_torch.ops.cov" in names
    assert "autogp_tpu_torch.inference.smc" in names
    assert "autogp_tpu_torch.inference.greedy" in names
    assert "autogp_tpu_torch.scripts.online" in names
    assert "autogp_tpu_torch.inference.smc_depth" in names
    assert "autogp_tpu_torch.scripts.experiment_hmc" in names
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m in ('jax', 'autogp_tpu')\n"
            "             or m.startswith(('jax.', 'autogp_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_import_leaves_the_jax_package_out():
    """`import autogp_tpu_torch`, its greedy and depth-annealing engines,
    its online script and its HMC experiment load neither jax nor any
    autogp_tpu module (the eight JAX-free modules are copies, not
    re-exports)."""
    code = ("import sys, autogp_tpu_torch\n"
            "import autogp_tpu_torch.inference.greedy\n"
            "import autogp_tpu_torch.inference.smc_depth\n"
            "import autogp_tpu_torch.scripts.online\n"
            "import autogp_tpu_torch.scripts.experiment_hmc\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m in ('jax', 'autogp_tpu')\n"
            "             or m.startswith(('jax.', 'autogp_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_mesh_import_leaves_the_jax_package_out():
    """`import autogp_tpu_torch.parallel.mesh` (the particle mesh over
    torch.distributed) loads neither jax nor any autogp_tpu module."""
    code = ("import sys, autogp_tpu_torch.parallel.mesh as m\n"
            "assert m.particle_mesh and m.shard_particles\n"
            "assert m.replicate_dataset and m.gather_particles\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n in ('jax', 'autogp_tpu')\n"
            "             or n.startswith(('jax.', 'autogp_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


TABLES = ["NUM_TYPES", "MAX_PARAMS", "PARAM_ARITY", "PARAM_KIND",
          "CHANGEPOINT_SCALE", "MODEL_JITTER", "SUM_GP_JITTER", "LEAF_CODES",
          "OP_CODES", "KIND_GAMMA", "KIND_PERIOD", "KIND_WILDCARD", "INACTIVE",
          "CONSTANT", "LINEAR", "SQUARED_EXPONENTIAL", "GAMMA_EXPONENTIAL",
          "PERIODIC", "PLUS", "TIMES", "CHANGEPOINT", "WHITE_NOISE"]


@pytest.mark.parametrize("name", TABLES)
def test_config_tables_equal_the_jax_package(name):
    """Each module-level table and constant of autogp_tpu_torch.config
    equals autogp_tpu.config's, value for value."""
    a, b = getattr(TC, name), getattr(JC, name)
    if isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert a == b


@pytest.mark.parametrize("kw", [{}, {"max_depth": 3},
                                {"changepoints": False, "noise": 0.1}],
                         ids=["default", "depth3", "nocp_noise"])
def test_gpconfig_priors_equal_the_jax_package(kw):
    """GPConfig defaults, priors and derived tables (node distributions,
    transform table, depth cap) of the two packages, value for value."""
    a, b = TC.GPConfig(**kw), JC.GPConfig(**kw)
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    assert fa == fb
    np.testing.assert_array_equal(a.node_dist_table(), b.node_dist_table())
    np.testing.assert_array_equal(a.transform_table(), b.transform_table())
    assert (a.depth_cap, a.max_nodes) == (b.depth_cap, b.max_nodes)
