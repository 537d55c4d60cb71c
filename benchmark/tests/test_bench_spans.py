"""The six readers of the program's spans and sync sites on a synthetic
recording, and what they give where the program records nothing."""

import pytest

from benchmark import run, spans

MS = 1_000_000


def _recording():
    """One unit: an MH step (propose_sr 4 ms, propose_da 2 ms), a
    parameter trajectory of two leapfrogs (3 ms, 5 ms), a noise trajectory
    of one leapfrog (7 ms, not a parameter leapfrog); two named syncs and
    one unnamed."""
    from autogp_tpu_torch.utils import trace
    rec = trace.Recording()
    rec.units = ["api.fit_smc"]
    rec.spans = [
        ["api.fit_smc", 0, 100 * MS, -1, 0],
        ["moves.mh_step", 0, 10 * MS, 0, 0],
        ["moves.propose_sr", 1 * MS, 5 * MS, 1, 0],
        ["moves.propose_da", 5 * MS, 7 * MS, 1, 0],
        ["hmc.params_trajectory", 20 * MS, 30 * MS, 0, 0],
        ["hmc.leapfrog", 20 * MS, 23 * MS, 4, 0],
        ["hmc.leapfrog", 23 * MS, 28 * MS, 4, 0],
        ["hmc.noise_trajectory", 30 * MS, 40 * MS, 0, 0],
        ["hmc.leapfrog", 30 * MS, 37 * MS, 7, 0],
    ]
    rec.points = []
    for i, (_, t0, t1, parent, _) in enumerate(rec.spans):
        rec.points += [(t0, i), (t1, parent)]
    rec.points.sort(key=lambda p: p[0])
    rec.syncs = [["hmc.live", 18 * MS, 19 * MS, 0, 0, 1],
                 ["smc.clock", 50 * MS, 60 * MS, 0, 0, 0]]
    rec.unnamed = [(45 * MS, 0, 0, "x.py:1")]
    return rec


@pytest.fixture
def recorded(monkeypatch):
    rec = _recording()
    monkeypatch.setattr(spans, "recorded", lambda: rec)
    return rec


def _trace(kind, units=1, device=None):
    out = {"kind": kind, "units": units}
    if device is not None:
        out["device"] = device
    return out


@pytest.mark.parametrize("name, kind, units, want", [
    ("host_syncs.fit", "fit", 1, 3.0),
    ("host_syncs.update", "stream", 2, 1.5),
    ("leapfrog_host_ms.fit", "fit", 1, 4.0),
    ("mh_propose_host_ms.update", "stream", 3, 6.0),
])
def test_host_readers(recorded, name, kind, units, want):
    assert run.read_metric(name, _trace(kind, units)) == pytest.approx(want)
    other = "stream" if kind == "fit" else "fit"
    assert run.read_metric(name, _trace(other, units)) is None


@pytest.mark.parametrize("name, kind", [("sync_idle_share.fit", "fit"),
                                        ("sync_idle_share.update",
                                         "stream")])
def test_sync_idle_share_readers(recorded, name, kind):
    # Idle 10-20 ms (holds hmc.live's return at 19), 30-40 ms (no return)
    # and 61-71 ms (after smc.clock's return at 60: not inside).
    device = [(0, 10 * MS), (20 * MS, 30 * MS), (40 * MS, 61 * MS),
              (71 * MS, 80 * MS)]
    got = run.read_metric(name, _trace(kind, 1, device))
    assert got == pytest.approx(100 * 10 / 30)
    # Without the device events in the trace there is nothing to read.
    assert run.read_metric(name, _trace(kind)) is None


@pytest.mark.parametrize("name", spans.READERS)
def test_readers_find_nothing_without_a_recording(monkeypatch, name):
    monkeypatch.setattr(spans, "recorded", lambda: None)
    kind = "fit" if name.endswith(".fit") else "stream"
    assert run.read_metric(name, _trace(kind, 1, [(0, 1)])) is None


def test_a_tree_without_the_trace_module_records_nothing(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_trace(name, *a, **k):
        if name == "autogp_tpu_torch.utils" and "trace" in (a[2] or ()):
            raise ImportError("no trace module")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert spans.recorded() is None
    assert spans.off_ns_per_span() is None


def test_device_events_go_onto_the_host_clock():
    events = [(1000, 5, "marker"), (1100, 20, "k1"), (1200, 30, "k2")]
    assert spans.on_host(events, 400) == [(500, 520), (600, 630)]
    assert spans.on_host([], 0) == []


def test_the_span_table_formats_every_row(recorded):
    lines = spans.format_table(recorded.table())
    assert lines[0].split()[:3] == ["span", "calls", "host_ms"]
    assert {ln.split()[0] for ln in lines[1:]} == {
        "api.fit_smc", "moves.mh_step", "moves.propose_sr",
        "moves.propose_da", "hmc.params_trajectory", "hmc.leapfrog",
        "hmc.noise_trajectory"}


def test_kernels_go_to_the_span_open_when_they_start(recorded):
    # The marker at host 0; kernels at 2, 21 and 45 ms (host clock).
    events = [(5000, 1, "marker"),
              (5000 + 2 * MS, MS, "void at::native::elementwise_kernel<1>"),
              (5000 + 21 * MS, 2 * MS, "sm90_xmma_gemm_f64f64"),
              (5000 + 45 * MS, 3 * MS, "vectorized_elementwise_kernel<4>")]
    got = spans.by_span(recorded, events, 0, ("elementwise_kernel",))
    assert got == {"moves.propose_sr": pytest.approx(1.0),
                   "api.fit_smc": pytest.approx(3.0)}
    assert spans.by_span(recorded, events, 0, ("gemm",)) == {
        "hmc.leapfrog": pytest.approx(2.0)}
