"""Shared helpers of the port's executable tutorials.

The counterpart of docs/tutorials/_common.py on autogp_tpu_torch. Every
tutorial of this package has a `run(fast, device=None, dtype=None)` that
returns what its asserts read, and a `__main__` that honours:

  AUTOGP_TUTORIAL_FAST=1  -- smoke mode: the JAX flows' FAST sizes (few
                             particles, tiny MCMC budgets), on the CPU in
                             float64, as the JAX flows run it;
  AUTOGP_TUTORIAL_CPU=1   -- the full budget on the CPU.

Otherwise `__main__` runs on the card (float32). Plotting
(AUTOGP_TUTORIAL_PLOT) is not ported.

The loaders and `train_test_split` are this package's own copies of the
JAX flows' (docs/tutorials/_common.py), reading the same vendored CSVs in
docs/tutorials/assets/; that module is not imported, since its
`maybe_force_cpu` imports jax.
"""

import os

import pandas as pd

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
ASSETS = os.path.join(_REPO, "docs", "tutorials", "assets")

FAST = os.environ.get("AUTOGP_TUTORIAL_FAST") == "1"


def main_device():
    """The device a tutorial's `__main__` runs on: the CPU in FAST mode or
    with AUTOGP_TUTORIAL_CPU=1 (docs/tutorials/_common.py
    maybe_force_cpu), else the card."""
    cpu = FAST or os.environ.get("AUTOGP_TUTORIAL_CPU") == "1"
    return "cpu" if cpu else "cuda"


def load_tsdl161():
    """Monthly airline passengers (tsdl.161.csv; overview tutorial)."""
    df = pd.read_csv(os.path.join(ASSETS, "tsdl.161.csv"), header=None,
                     names=["ds", "y"], parse_dates=["ds"])
    return df


def load_m1266():
    """M3-competition monthly series M1266 (decomposition tutorial)."""
    df = pd.read_csv(os.path.join(ASSETS, "M1266.csv"), index_col=0,
                     parse_dates=["ds"])
    return df[["ds", "y"]].reset_index(drop=True)


def load_iclaims():
    """Weekly US unemployment insurance claims (iclaims tutorial)."""
    df = pd.read_csv(os.path.join(ASSETS, "iclaims.csv"), header=None,
                     names=["ds", "y"], parse_dates=["ds"])
    return df


def train_test_split(df, frac=0.8):
    n_train = int(len(df) * frac)
    return df.iloc[:n_train], df.iloc[n_train:]
