"""The `forecast_ms.update` and `forecast_frame_ms.update` readers on
synthetic recordings: the api.predict units' host time and their
predict.frame spans per profiled update; None on a fit's trace, without a
recording, and where no api.predict unit was recorded (a program whose
predict is no unit, or a cell that forecasts nothing)."""

import pytest

from benchmark import run, spans

MS = 1_000_000


def _recording(updates, forecast=True):
    """`updates` updates, each an api.mcmc_structure unit of 100 ms and,
    with `forecast`, an api.predict unit of 30 ms holding predict.factor
    (10 ms), predict.marginals (5 ms) and predict.frame (12 ms); and one
    predict.frame span in an api.predict_mvn unit, which no reader
    counts."""
    from autogp_tpu_torch.utils import trace
    rec = trace.Recording()
    t = 0
    for _ in range(updates):
        u = len(rec.units)
        rec.units.append("api.mcmc_structure")
        rec.spans.append(["api.mcmc_structure", t, t + 100 * MS, -1, u])
        t += 100 * MS
        if forecast:
            u = len(rec.units)
            rec.units.append("api.predict")
            top = len(rec.spans)
            rec.spans.append(["api.predict", t, t + 30 * MS, -1, u])
            rec.spans.append(["predict.factor", t, t + 10 * MS, top, u])
            rec.spans.append(["predict.marginals", t + 10 * MS, t + 15 * MS,
                              top, u])
            rec.spans.append(["predict.frame", t + 18 * MS, t + 30 * MS,
                              top, u])
            t += 30 * MS
    u = len(rec.units)
    rec.units.append("api.predict_mvn")
    rec.spans.append(["api.predict_mvn", t, t + 50 * MS, -1, u])
    rec.spans.append(["predict.frame", t, t + 40 * MS, len(rec.spans) - 1,
                      u])
    return rec


@pytest.mark.parametrize("name, want", [("forecast_ms.update", 30.0),
                                        ("forecast_frame_ms.update", 12.0)])
@pytest.mark.parametrize("updates", [1, 4])
def test_forecast_readers(monkeypatch, name, want, updates):
    rec = _recording(updates)
    monkeypatch.setattr(spans, "recorded", lambda: rec)
    got = run.read_metric(name, {"kind": "stream", "units": updates})
    assert got == pytest.approx(want)
    assert run.read_metric(name, {"kind": "fit", "units": updates}) is None


@pytest.mark.parametrize("name", ["forecast_ms.update",
                                  "forecast_frame_ms.update"])
def test_forecast_readers_without_a_forecast(monkeypatch, name):
    rec = _recording(3, forecast=False)
    monkeypatch.setattr(spans, "recorded", lambda: rec)
    assert run.read_metric(name, {"kind": "stream", "units": 3}) is None
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert run.read_metric(name, {"kind": "stream", "units": 3}) is None
