"""The general generator and the units of work it drives.

A cell is a configuration file (`configs/<config>.json`: the model and
inference settings as run) and a traffic file (`workloads/<traffic>.json`:
the series, the particles, the loop). The traffic's "kind" names the loop,
`kinds/<kind>.py`, which gives the class `Unit` (set-up and units of
work), `end_to_end(window_s, durations)` (the window's end-to-end
metrics) and `TRACE_SHARE` (the share of --seconds whose units a traced
run profiles; 0: one unit); the series' "source" names `sources/<source>.py`, whose
`series(spec, seed)` makes the data. A new loop or data source is a new
file there.

One seeding scheme holds for every traffic: the traffic file pins the
seeds of its data and of its fits or posteriors, so that every run does
the same work; --seed orders that work, draws what each unit draws beyond
it (a stream's updates) and picks the units that the check judges.
A traffic with "forecast": {"points": 0} runs no forecast (`api.predict`
is left out of the unit).
"""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def seed_rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *tags]))


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed from (seed, tags)."""
    return int(np.random.SeedSequence([seed, *tags]).generate_state(
        2, np.uint32).astype(np.uint64) @ np.array([1 << 31, 1],
                                                    dtype=np.uint64))


def load_module(folder: str, name: str):
    """`<folder>/<name>.py` of the benchmark, loaded by its file name."""
    path = ROOT / folder / f"{name}.py"
    if not path.exists():
        raise ValueError(f"no {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kinds() -> list:
    return sorted(p.stem for p in (ROOT / "kinds").glob("*.py")
                  if p.stem != "__init__")


def series(spec: dict, seed: int):
    """(t, y) float64 [n] of a traffic file's "series" (by its "source",
    "synthetic" where it names none), drawn from `seed`."""
    return load_module("sources", spec.get("source", "synthetic")).series(
        spec, seed)


class Unit:
    """The program's side of one cell: set-up and units of work."""

    def __init__(self, A, config: dict, traffic: dict, seed: int, device):
        self.A, self.cfg, self.traffic = A, config, traffic
        self.seed, self.device = seed, device
        self.P = int(traffic["n_particles"])
        g = config["gp_config"]
        self.gp_config = A.GPConfig(
            changepoints=g["changepoints"], max_depth=g["max_depth"],
            static_max_depth=g["static_max_depth"], prior=config["prior"])
        self.hmc = dict(config["hmc"])
        f = traffic["forecast"]
        self.n_future = int(f["points"])
        self.quantiles = list(f["quantiles"])

    def forecast(self, model, ds):
        """The forecast at ds, or None where the traffic asks for none."""
        if not self.n_future:
            return None
        return self.A.api.predict(model, ds, quantiles=self.quantiles)

    def fit_smc(self, model, schedule, n_mcmc, n_hmc):
        self.A.fit_smc(model, schedule, n_mcmc, n_hmc,
                       shuffle=self.cfg["shuffle"],
                       adaptive_resampling=self.cfg["adaptive_resampling"],
                       hmc_config=self.hmc)

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # The units that make one pass over the traffic's pinned work: a timed
    # window ends with a whole number of passes.
    cycle = 1

    def snapshot(self):
        return None

    def restore(self, state):
        pass


def make_unit(A, config, traffic, seed, device) -> Unit:
    return load_module("kinds", traffic["kind"]).Unit(A, config, traffic,
                                                      seed, device)


def end_to_end(traffic, window_s: float, durations) -> dict:
    """The window's end-to-end metrics, as the traffic's kind computes
    them."""
    return load_module("kinds", traffic["kind"]).end_to_end(window_s,
                                                            durations)


def window(unit: Unit, seconds: float, on_unit=None, cycle: int = 1):
    """Units back to back until `seconds` have passed; the window ends with
    the unit running then, or, with `cycle`, with the first whole number
    of cycles of that many units after it, so that every run does the same
    units in another order. Returns (window seconds, [unit seconds]).
    `on_unit(index, record, seconds)` sees each unit's record."""
    durations = []
    t_start = time.perf_counter()
    index = 0
    while True:
        t0 = time.perf_counter()
        record = unit.run(index)
        t1 = time.perf_counter()
        durations.append(t1 - t0)
        if on_unit is not None:
            on_unit(index, record, t1 - t0)
        index += 1
        if t1 - t_start >= seconds and index % cycle == 0:
            return t1 - t_start, durations
