"""The port's spans and host-sync sites (autogp_tpu_torch/utils/trace.py)
on the CPU: nesting, units, self times, sync sites, the profiled stretch,
the cost when off, and a fit that gives the same bits with tracing on and
off."""

import timeit
import warnings

import numpy as np
import pytest
import torch

import autogp_tpu_torch as A
from autogp_tpu_torch.utils import trace


def _sync_warning():
    warnings.warn(trace.SYNC_WARNING + " (raised here for the test)")


def test_spans_nest_with_parents_and_unit_ids():
    with trace.recording() as rec:
        with trace.span("outside"):
            pass
        with trace.unit("api.a"):
            with trace.span("x"):
                with trace.span("y"):
                    pass
                with trace.unit("api.inner"):
                    pass
        with trace.unit("api.b"):
            with trace.span("x"):
                pass
    names = [s[0] for s in rec.spans]
    assert names == ["outside", "api.a", "x", "y", "api.inner", "api.b", "x"]
    parents = [s[3] for s in rec.spans]
    assert parents == [-1, -1, 1, 2, 2, -1, 5]
    units = [s[4] for s in rec.spans]
    assert units == [-1, 0, 0, 0, 0, 1, 1]
    assert rec.units == ["api.a", "api.b"]
    assert all(s[1] <= s[2] for s in rec.spans)
    # The innermost open span at each change point.
    assert [i for _, i in rec.points] == [0, -1, 1, 2, 3, 2, 4, 2, 1, -1,
                                          5, 6, 5, -1]


def test_self_times_add_up_to_the_parent():
    with trace.recording() as rec:
        with trace.unit("api.a"):
            for _ in range(3):
                with trace.span("x"):
                    with trace.span("y"):
                        sum(range(2000))
                    sum(range(1000))
    spans = rec.spans
    for i, (_, t0, t1, _, _) in enumerate(spans):
        kids = sum(s[2] - s[1] for s in spans if s[3] == i)
        assert kids <= t1 - t0
    table = rec.table()
    total = spans[0][2] - spans[0][1]
    assert sum(r["self_ms"] for n, r in table.items()) == pytest.approx(
        total * 1e-6, rel=1e-9)
    assert table["x"]["calls"] == 3 and table["y"]["calls"] == 3
    assert table["x"]["host_ms"] == pytest.approx(
        table["x"]["self_ms"] + table["y"]["host_ms"], rel=1e-9)


def test_tracing_off_records_nothing():
    assert trace.span("a") is trace.span("b") is trace.sync("c")
    before = trace.profiled()
    with trace.span("a"), trace.sync("c"), trace.unit("api.a"):
        pass
    assert trace.profiled() is before
    with trace.recording() as rec:
        pass
    assert rec.spans == [] and rec.syncs == [] and rec.unnamed == []
    assert trace.span("a") is trace.span("b")


def test_named_sync_sites_count_by_site():
    with trace.recording() as rec:
        with trace.unit("api.a"):
            with trace.span("x"):
                for _ in range(3):
                    with trace.sync("site.one"):
                        _sync_warning()
                        _sync_warning()
                with trace.sync("site.two"):
                    pass
                _sync_warning()
            with warnings.catch_warnings(record=True) as other:
                warnings.simplefilter("always")
                warnings.warn("another warning")
    assert rec.by_site() == {"site.one": 3, "site.two": 1, "unnamed": 1}
    assert [s[5] for s in rec.syncs] == [2, 2, 2, 0]
    assert all(rec.name_of(s[3]) == "x" and s[4] == 0 for s in rec.syncs)
    (_, span, unit, where), = rec.unnamed
    assert rec.name_of(span) == "x" and unit == 0
    assert where.startswith(__file__)
    assert len(other) == 1 and "another" in str(other[0].message)
    table = rec.table()
    assert table["x"]["syncs"] == 4 and table["x"]["unnamed"] == 1


def test_device_work_and_idle_time_go_to_the_innermost_span():
    rec = trace.Recording()
    rec.spans = [["a", 0, 100, -1, 0], ["b", 100, 200, -1, 0]]
    rec.points = [(0, 0), (100, -1), (100, 1), (200, -1)]
    rec.syncs = [["s", 40, 50, 0, 0, 1]]
    device = [(10, 30), (60, 90), (150, 160), (170, 250)]
    table = rec.table(device)
    assert table["a"]["device_ms"] == pytest.approx(50e-6)
    assert table["b"]["device_ms"] == pytest.approx(90e-6)
    # Idle 30-60 and 90-100 in a, 100-150 and 160-170 in b.
    assert table["a"]["idle_ms"] == pytest.approx(40e-6)
    assert table["b"]["idle_ms"] == pytest.approx(60e-6)
    # The gap 30-60 holds the sync's return (50); 90-150 and 160-170 not.
    assert rec.sync_idle_share(device) == pytest.approx(100 * 30 / 100)


def test_units_under_the_profiler_go_to_the_profiled_stretch():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.unit("api.a"):
            with trace.span("x"), trace.sync("s"):
                pass
        with trace.span("outside a unit"):
            pass
        with trace.unit("api.b"):
            pass
    first = trace.profiled()
    assert [s[0] for s in first.spans] == ["api.a", "x", "api.b"]
    assert first.units == ["api.a", "api.b"] and first.by_site() == {"s": 1}
    with trace.unit("api.c"):       # no profiler: ends the stretch
        pass
    assert trace.profiled() is first
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.unit("api.d"):
            pass
    assert trace.profiled() is not first
    assert trace.profiled().units == ["api.d"]


def test_a_span_off_costs_well_under_a_microsecond():
    def off():
        with trace.span("x"):
            pass
    n = 100_000
    best = min(timeit.repeat(off, number=n, repeat=5)) / n
    assert best < 1e-6


def _fit(record: bool):
    t = np.arange(48, dtype=np.float64)
    y = np.sin(2 * np.pi * t / 12.0) + 0.05 * t
    A.seed(7)
    m = A.GPModel(t, y, n_particles=4, device="cpu",
                  config=A.GPConfig(changepoints=True, max_depth=3,
                                    static_max_depth=3))
    if not record:
        A.fit_smc(m, A.Schedule.linear_schedule(48, 0.5), 2, 2)
        return m, None
    with trace.recording() as rec:
        A.fit_smc(m, A.Schedule.linear_schedule(48, 0.5), 2, 2)
    return m, rec


def test_a_fit_gives_the_same_bits_with_tracing_on_and_off():
    off, _ = _fit(False)
    on, rec = _fit(True)
    a, b = off.particles, on.particles
    assert torch.equal(a.node_type, b.node_type)
    for field in ("params", "lml", "log_weights", "noise_z"):
        x, y = getattr(a, field), getattr(b, field)
        assert torch.equal(x.view(torch.int64), y.view(torch.int64)), field
    assert rec.units == ["api.fit_smc"]
    table = rec.table()
    for name in ("api.fit_smc", "smc.round", "smc.reweight", "smc.resample",
                 "smc.rejuvenate", "moves.mh_step", "moves.propose_sr",
                 "moves.propose_da", "moves.score", "hmc.sweep",
                 "hmc.params_trajectory", "hmc.noise_trajectory",
                 "hmc.leapfrog", "model.lml", "model.lml_grad"):
        assert table[name]["calls"] > 0, name
    assert table["smc.round"]["calls"] == 2
    sites = rec.by_site()
    assert {"hmc.live", "smc.clock", "smc.dataset",
            "smc.round_stats"} <= set(sites)
    assert sites["smc.round_stats"] == 2 and "unnamed" not in sites
    # Every leapfrog of a parameter trajectory runs one forward and one
    # gradient.
    names = [s[0] for s in rec.spans]
    frogs = [i for i, s in enumerate(rec.spans) if s[0] == "hmc.leapfrog"
             and names[s[3]] == "hmc.params_trajectory"]
    assert frogs
    for i in frogs:
        kids = [s[0] for s in rec.spans if s[3] == i]
        assert kids == ["model.lml", "model.lml_grad"]


def _float32_model():
    """A float32 model on the CPU: 8 prior particles on 40 points."""
    t = np.arange(40, dtype=np.float64)
    y = np.sin(t / 5.0) + 0.01 * t
    A.seed(2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return A.GPModel(t, y, n_particles=8, device="cpu",
                         dtype=torch.float32)


def _kids(rec, i):
    return [s[0] for s in rec.spans if s[3] == i]


def test_a_recorded_predict_is_a_unit_with_its_spans():
    """predict runs as the api.predict unit: predict.factor (the float64
    factor; predict.factor_cached once it is cached), predict.marginals
    and predict.frame, every device read at a named site."""
    m = _float32_model()
    future = np.arange(40, 48, dtype=np.float64)
    with trace.recording() as rec:
        A.predict(m, future, quantiles=[0.1, 0.9])
        A.predict(m, future, quantiles=[0.1, 0.9])
    assert rec.units == ["api.predict", "api.predict"]
    tops = [i for i, s in enumerate(rec.spans) if s[3] < 0]
    assert [rec.spans[i][0] for i in tops] == ["api.predict"] * 2
    assert _kids(rec, tops[0]) == ["predict.factor", "predict.marginals",
                                   "predict.frame"]
    assert _kids(rec, tops[1]) == ["predict.factor_cached",
                                   "predict.marginals", "predict.frame"]
    factor = next(i for i, s in enumerate(rec.spans)
                  if s[0] == "predict.factor")
    assert "ops.chol" in _kids(rec, factor)
    sites = rec.by_site()
    assert {"api.query", "api.moments", "api.weights",
            "smc.dataset"} <= set(sites)
    assert sites["api.moments"] == 2 and sites["api.weights"] == 2
    assert not rec.unnamed


@pytest.mark.parametrize("call, unit", [
    (lambda m, ds: A.predict_mvn(m, ds), "api.predict_mvn"),
    (lambda m, ds: A.predict_quantile(m, ds, 0.5), "api.predict_quantile"),
    (lambda m, ds: A.predict_proba(m, ds, np.zeros(len(ds))),
     "api.predict_proba")])
def test_the_other_predict_entries_are_units(call, unit):
    m = _float32_model()
    with trace.recording() as rec:
        call(m, np.arange(40, 44, dtype=np.float64))
    assert rec.units == [unit]
    top = next(i for i, s in enumerate(rec.spans) if s[3] < 0)
    kids = _kids(rec, top)
    assert "predict.marginals" in kids and kids[-1] == "predict.frame"
    assert rec.by_site()["api.moments"] == 1
    assert not rec.unnamed
