"""BENCHMARK.json, the configuration and traffic files, and the readers
parse and hold together; the result line has the keys it must carry."""

import io
import json
import re
from contextlib import redirect_stdout

import pytest

from benchmark import run, workload as W

BENCH = W.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    cells = len(BENCH["workloads"])
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells <= 24


def test_names_and_units():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[key]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_loads_and_reports_enough(cell):
    bench, entry, config, traffic = run.load_cell(cell)
    assert entry["chips"] == 1
    assert traffic["kind"] in W.kinds()
    e2e = [m["name"] for m in run.cell_metrics(bench, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = run.cell_metrics(bench, cell, "per_layer")
    assert per
    for m in per:
        assert m["moves"] in e2e
        assert (W.ROOT / "metrics" / f"{m['name']}.py").exists()
    limits = set(traffic["limits"])
    assert limits >= {"lml_gap", "dead_share", "unmoved", "grad_gap_med"}
    if traffic["kind"] == "fit":
        assert "weight_gap_max" in limits


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configuration_files(entry):
    path = run.ROOT / entry["file"]
    assert path.is_relative_to(run.ROOT / "benchmark")
    config = W.load_json(path)
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    for key in ("gp_config", "n_mcmc", "n_hmc", "hmc", "prior",
                "model_jitter", "changepoint_scale"):
        assert key in config


@pytest.mark.parametrize("name", sorted(p.stem for p in (
    W.ROOT / "workloads").glob("*.json")))
def test_traffic_files(name):
    traffic = W.load_json(W.ROOT / "workloads" / f"{name}.json")
    t, y = W.series(traffic["series"], 2 ** 31 + 7)
    assert t.shape == y.shape == (traffic["series"]["n"],)
    t2, y2 = W.series(traffic["series"], 2 ** 31 + 7)
    assert (y == y2).all()
    # One seeding scheme: the traffic pins its data and its fits or
    # posteriors.
    pinned = {"fit": ("fit_seeds",), "stream": ("posteriors",)}
    for key in pinned[traffic["kind"]]:
        assert traffic[key] and all(isinstance(s, int) for s in traffic[key])
    if traffic["kind"] == "fit":
        assert isinstance(traffic["series"]["seed"], int)


@pytest.mark.parametrize("kind", W.kinds())
def test_each_kind_file_gives_a_unit_and_its_metrics(kind):
    mod = W.load_module("kinds", kind)
    assert issubclass(mod.Unit, W.Unit) and 0 <= mod.TRACE_SHARE < 1
    e2e = mod.end_to_end(10.0, [2.0, 3.0, 5.0])
    assert e2e and all(v > 0 for v in e2e.values())
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert set(e2e) <= names


def test_a_kind_or_source_is_found_by_its_file_name():
    assert {"fit", "stream"} <= set(W.kinds())
    with pytest.raises(ValueError):
        W.load_module("kinds", "no_such_kind")
    t, _ = W.series({"source": "synthetic", "n": 5, "trend": 0.0,
                     "periods": [], "amplitudes": [], "noise": 1.0}, 3)
    assert t.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]


@pytest.mark.parametrize("seconds, cycle, units", [(0.0, 1, 1), (0.0, 3, 3),
                                                   (0.0, 4, 4)])
def test_a_window_ends_with_a_whole_cycle(seconds, cycle, units):
    class Count:
        def run(self, index):
            return index
    seen = []
    _, durations = W.window(Count(), seconds, lambda i, r, s: seen.append(r),
                            cycle)
    assert len(durations) == units and seen == list(range(units))


def test_the_earlier_data_of_a_shuffled_fit_is_its_prefix():
    from benchmark import check
    import numpy as np
    t = np.arange(8.0)
    record = {"t_fit": t, "y_fit": 10 * t}
    kept = {"anneal": (np.array([3, 1, 7, 0, 2, 6, 5, 4]), [2, 4, 8])}
    tp, yp = check.previous_data(record, kept)
    assert tp.tolist() == [3.0, 1.0, 7.0, 0.0]
    assert yp.tolist() == [30.0, 10.0, 70.0, 0.0]
    record["t_prev"], record["y_prev"] = t[:2], t[:2]
    assert check.previous_data(record, kept)[0].tolist() == [0.0, 1.0]


def test_a_seed_above_32_bits_gives_the_same_sizes():
    from benchmark import control
    traffic = W.load_json(W.ROOT / "workloads" / "stream_w512.json")
    out = control.drawn(traffic, 2 ** 33 + 5)
    assert out["posteriors"] == [2 ** 33 + 5]
    assert out["series"]["n"] == traffic["series"]["n"]
    a = W.derive_seed(2 ** 33 + 5, 1, 0)
    assert 0 <= a < 2 ** 63 and a == W.derive_seed(2 ** 33 + 5, 1, 0)


def test_result_line_shape():
    out = {"correct": True, "attempted": 3, "failed": 0,
           "metrics": {"fit_s": {"value": 15.25, "unit": "s"}},
           "breakdown": {"device_ops": [["k", 1.5]], "idle_gaps": []}}
    lines = [("lml_gap", 1e-6, 1e-4, True),
             ("forecast_gap", float("inf"), 1e-2, False)]
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1, "memory_peak_bytes": 123}
    res = run.result_line(out, lines, device)
    text = json.dumps(res, allow_nan=False)
    assert list(json.loads(text)) == ["correct", "attempted", "failed",
                                      "metrics", "device", "breakdown",
                                      "checks"]
    assert res["checks"]["forecast_gap"] == {"value": None, "limit": 1e-2}


def test_no_card_no_result(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", CELLS[0], "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0 and buf.getvalue() == ""
