"""A run with its timed path broken underneath comes out not correct.

Each case drives the whole of a run on the CPU at a small size (the cell's
own loop, recorders and checks, with its own limits), skipping only the
look for a card, with one fault planted in the program: a step that
returns its state unchanged, half of the batch left out and the mean of
the rest put in its place, an answer altered where it is produced (a
likelihood, a log weight, kernel 5's parameter gradient). The exchange
between chips is not a fault these one-chip cells can have. A recorder
that finds nothing to read leaves its number without a reading, and
that is not correct either."""

import pytest
import torch

from benchmark import run
from benchmark.tests.small import small

FIT, STREAM = "config4.fit_p512_nopredict", "config5.stream_w512_nopredict"
# The cells with a forecast, which BENCHMARK.json leaves out while the
# program's forecast is at fault (PERF.md), run in a cell's place.
FORECASTS = {FIT: "fit_p512", STREAM: "stream_w512"}


def reweight_unchanged(mp):
    from autogp_tpu_torch.inference import smc
    mp.setattr(smc, "reweight", lambda particles, data, cfg, tables:
               particles)


def rejuvenation_unchanged(mp):
    from autogp_tpu_torch.inference import smc
    def rejuvenate(gen, particles, *a, **k):
        z = torch.zeros(particles.n_particles, dtype=torch.int64)
        return (particles, z, z, z,
                torch.ones((particles.n_particles, 4), dtype=torch.bool))
    mp.setattr(smc, "rejuvenate_structure", rejuvenate)


def half_of_the_likelihoods(mp):
    from autogp_tpu_torch.inference import smc
    lml_all = smc.lml_all

    def half(particles, data, cfg, tables):
        out = lml_all(particles, data, cfg, tables)
        h = out.shape[0] // 2
        return torch.cat([out[:h], out[:h].mean().expand(out.shape[0] - h)])
    mp.setattr(smc, "lml_all", half)


def half_of_the_forecast(mp):
    from autogp_tpu_torch import gp_math
    marginals = gp_math.posterior_marginals_from_factor

    def half(*a, **k):
        mu, sd = marginals(*a, **k)
        h = mu.shape[0] // 2
        rest = mu.shape[0] - h
        return (torch.cat([mu[:h], mu[:h].mean(0).expand(rest, -1)]),
                torch.cat([sd[:h], sd[:h].mean(0).expand(rest, -1)]))
    mp.setattr(gp_math, "posterior_marginals_from_factor", half)


def likelihood_altered(mp):
    """One particle's stored likelihood off by a tenth of itself where
    the rejuvenation hands it back."""
    from autogp_tpu_torch.inference import smc
    rejuvenate = smc.rejuvenate_structure

    def altered(*a, **k):
        particles, *rest = rejuvenate(*a, **k)
        lml = particles.lml.clone()
        lml[0] += 0.1 * lml[0].abs() + 5.0
        return (particles.replace(lml=lml), *rest)
    mp.setattr(smc, "rejuvenate_structure", altered)


def parameter_gradient_halved(mp):
    """Kernel 5's entry hands back half of the parameter gradient."""
    from autogp_tpu_torch.ops import cov_vjp
    bwd = cov_vjp.cov_tape_bwd

    def half(*a, **k):
        pbar, nbar = bwd(*a, **k)
        return 0.5 * pbar, nbar
    mp.setattr(cov_vjp, "cov_tape_bwd", half)


def parameter_gradient_zeroed(mp):
    from autogp_tpu_torch.ops import cov_vjp
    bwd = cov_vjp.cov_tape_bwd

    def zero(*a, **k):
        pbar, nbar = bwd(*a, **k)
        return torch.zeros_like(pbar), nbar
    mp.setattr(cov_vjp, "cov_tape_bwd", zero)


def weight_without_the_cached_likelihood(mp):
    """A reweight that adds the new likelihood to the log weight without
    taking the cached one off."""
    from autogp_tpu_torch.inference import smc
    reweight = smc.reweight

    def wrong(particles, *a, **k):
        out = reweight(particles, *a, **k)
        return out.replace(log_weights=out.log_weights + particles.lml)
    mp.setattr(smc, "reweight", wrong)


def forecast_altered(mp):
    from autogp_tpu_torch import api
    predict = api.predict

    def altered(model, *a, **k):
        df = predict(model, *a, **k)
        df.loc[0, "y_mean"] += 0.25 * (model.y.max() - model.y.min())
        return df
    mp.setattr(api, "predict", altered)


FAULTS = [(FIT, reweight_unchanged), (STREAM, reweight_unchanged),
          (STREAM, rejuvenation_unchanged), (FIT, rejuvenation_unchanged),
          (STREAM, half_of_the_likelihoods), (FIT, half_of_the_likelihoods),
          (STREAM, likelihood_altered), (FIT, likelihood_altered),
          (FIT, parameter_gradient_halved), (STREAM, parameter_gradient_halved),
          (FIT, parameter_gradient_zeroed), (STREAM, parameter_gradient_zeroed),
          (FIT, weight_without_the_cached_likelihood)]
# The stream cell does not compare its log weights (PERF.md): a reweight
# fault there is not one of its numbers' to catch.
# The number that each fault has to fail, beside any other.
MUST_FAIL = {parameter_gradient_halved: "grad_gap",
             parameter_gradient_zeroed: "grad_gap",
             weight_without_the_cached_likelihood: "weight_gap"}
FORECAST_FAULTS = [(STREAM, half_of_the_forecast), (FIT, forecast_altered)]


def drive(cell, traffic_file=None):
    return run.run_cell(cell, 2 ** 32 + 11, 0.0, False, torch.device("cpu"),
                        override=small(traffic_file=traffic_file))


@pytest.mark.parametrize("cell, fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    out, lines = drive(cell)
    assert out["correct"] is False
    assert any(not ok for *_, ok in lines)
    if fault in MUST_FAIL:
        assert any(n.startswith(MUST_FAIL[fault])
                   for n, *_, ok in lines if not ok)


@pytest.mark.parametrize("cell", [FIT, STREAM])
def test_a_number_without_a_reading_is_not_correct(monkeypatch, cell):
    from benchmark import recorders
    take = recorders.Keep.take

    def blind(self):
        kept = take(self)
        kept.pop("grad", None)
        kept.pop("rejuvenation", None)
        return kept
    monkeypatch.setattr(recorders.Keep, "take", blind)
    out, lines = drive(cell)
    assert out["correct"] is False
    assert {n for n, v, *_ in lines if v is None} == {"grad_gap_med",
                                                      "unmoved"}


@pytest.mark.parametrize("cell, fault", FORECAST_FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FORECAST_FAULTS])
def test_a_planted_forecast_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    out, lines = drive(cell, FORECASTS[cell])
    assert out["correct"] is False
    assert [n for n, *_, ok in lines if not ok] == ["forecast_gap"]


@pytest.mark.parametrize("cell", [FIT, STREAM])
@pytest.mark.parametrize("forecast", [False, True])
def test_the_sound_program_is_correct(cell, forecast):
    out, lines = drive(cell, FORECASTS[cell] if forecast else None)
    assert out["correct"] is True, lines
    assert ("forecast_gap" in [n for n, *_ in lines]) is forecast
