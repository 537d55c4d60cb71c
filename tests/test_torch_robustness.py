"""NaN robustness of the port's initialization and pre-fit workflow (CPU,
float64): ports of tests/test_robustness.py:60 and :100, with
autogp_tpu_torch.model.lml monkeypatched as the JAX tests patch theirs.

smc.initialize redraws lanes whose LML or weight is not finite up to
`max_retries` times, then clamps a lane still bad to weight -inf and the
finite BAD_LML, so the user-facing weights and estimates stay NaN-free.
"""

import numpy as np
import torch

import autogp_tpu_torch as A
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.config import GPConfig
from autogp_tpu_torch.inference import smc

F64 = torch.float64


def _data(n=24, pad_to=32, seed=0):
    rng = np.random.default_rng(seed)
    ts = np.linspace(0, 1, n)
    xs = np.sin(7 * ts) + 0.1 * rng.standard_normal(n)
    return ts, xs, smc.make_dataset(ts, xs, pad_to=pad_to, dtype=F64,
                                    device="cpu")


def _bad_by_params(pz):
    """[P] pseudo-random in the draw, deterministic in the seed (the JAX
    tests' sin(1e3 * sum(params)) > 0, per particle)."""
    return torch.sin(1e3 * pz.sum(dim=(1, 2))) > 0.0


def test_initialize_retries_then_clamps(monkeypatch):
    """Port of tests/test_robustness.py:60: all-NaN lanes end with weight
    -inf and BAD_LML; a flaky LML clears within max_retries."""
    torch.set_num_threads(1)
    cfg = GPConfig(max_depth=2, noise=0.12345)
    tab = TM.prior_tables(cfg, "cpu", F64)
    _, _, data = _data()
    orig_lml = TM.lml

    def always_nan(nt, pz, nz, ts, xs, mask, config, tables):
        return float("nan") * orig_lml(nt, pz, nz, ts, xs, mask, config,
                                       tables)

    monkeypatch.setattr(TM, "lml", always_nan)
    parts = smc.initialize(torch.Generator().manual_seed(1), 4, data, cfg,
                           tab)
    assert (parts.log_weights == float("-inf")).all()
    assert (parts.lml == smc.BAD_LML).all()

    # Flaky-LML case: a lane fails until its redraw happens to clear the
    # condition; bounded retries must fix every lane for this seed.
    cfg2 = GPConfig(max_depth=2, noise=0.54321)
    tab2 = TM.prior_tables(cfg2, "cpu", F64)
    first_bad = []

    def flaky(nt, pz, nz, ts, xs, mask, config, tables):
        out = orig_lml(nt, pz, nz, ts, xs, mask, config, tables)
        bad = _bad_by_params(pz)
        first_bad.append(int(bad.sum()))
        return torch.where(bad, float("nan"), out)

    monkeypatch.setattr(TM, "lml", flaky)
    parts2 = smc.initialize(torch.Generator().manual_seed(2), 8, data, cfg2,
                            tab2, max_retries=8)
    assert first_bad[0] > 0   # the first batch had bad lanes to retry
    assert torch.isfinite(parts2.log_weights).all()
    assert torch.isfinite(parts2.lml).all()


def test_gpmodel_workflow_finite_with_bad_lanes(monkeypatch):
    """Port of tests/test_robustness.py:100: the pre-fit workflow (GPModel
    -> weights -> LML estimate -> predict -> add_data) stays finite when
    some prior lanes are numerically dead."""
    torch.set_num_threads(1)
    cfg = GPConfig(max_depth=2, noise=0.2468)
    orig_lml = TM.lml

    def half_dead(nt, pz, nz, ts, xs, mask, config, tables):
        out = orig_lml(nt, pz, nz, ts, xs, mask, config, tables)
        return torch.where(_bad_by_params(pz), float("nan"), out)

    monkeypatch.setattr(TM, "lml", half_dead)
    ts, xs, _ = _data(n=20)
    A.seed(11)
    m = A.GPModel(ts, xs, n_particles=8, config=cfg, device="cpu")
    # Retries should have cleared every lane here; even if not, weights
    # must be non-NaN and the estimates finite.
    w = m.particle_weights()
    assert not np.isnan(w).any()
    assert np.isfinite(m.log_marginal_likelihood_estimate())
    assert torch.isfinite(m.particles.lml).all()
    pred = A.predict(m, ts[:5], quantiles=[0.1, 0.9])
    assert np.isfinite(pred["y_mean"].to_numpy()).all()
    A.add_data(m, ts[-1:] + 0.05, xs[-1:])
    assert not torch.isnan(m.particles.log_weights).any()
    assert torch.isfinite(m.particles.lml).all()
