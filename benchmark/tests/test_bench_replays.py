"""The `frog_replay_share.*` readers on synthetic recordings: a program
whose leapfrogs all run eagerly (0), one that replays a CUDA graph in ten
of each trajectory's eleven leapfrogs (90.9), and one with no leapfrog
(None)."""

import pytest

from benchmark import run, spans

MS = 1_000_000


def _recording(frogs, replayed):
    """One unit: a parameter and a noise trajectory of `frogs` leapfrogs
    each (1 ms apiece), the last `replayed` of each holding an hmc.replay
    span, the first of those an hmc.capture too; and one leapfrog outside
    any trajectory, which no reader counts."""
    from autogp_tpu_torch.utils import trace
    rec = trace.Recording()
    rec.units = ["api.fit_smc"]
    rec.spans = [["api.fit_smc", 0, 1000 * MS, -1, 0],
                 ["hmc.leapfrog", 1 * MS, 2 * MS, 0, 0]]
    t = 10 * MS
    for traj in ("hmc.params_trajectory", "hmc.noise_trajectory"):
        top = len(rec.spans)
        rec.spans.append([traj, t, t + (frogs + 1) * MS, 0, 0])
        for k in range(frogs):
            i = len(rec.spans)
            t0 = t + k * MS
            rec.spans.append(["hmc.leapfrog", t0, t0 + MS, top, 0])
            if k >= frogs - replayed:
                if k == frogs - replayed:
                    rec.spans.append(["hmc.capture", t0, t0 + MS // 2, i, 0])
                rec.spans.append(["hmc.replay", t0 + MS // 2, t0 + MS, i, 0])
        t += (frogs + 2) * MS
    rec.points = []
    return rec


@pytest.mark.parametrize("frogs, replayed, want", [
    (11, 0, 0.0), (11, 10, 100 * 10 / 11), (11, 11, 100.0), (0, 0, None)])
@pytest.mark.parametrize("name, kind", [("frog_replay_share.fit", "fit"),
                                        ("frog_replay_share.update",
                                         "stream")])
def test_replay_share(monkeypatch, frogs, replayed, want, name, kind):
    rec = _recording(frogs, replayed)
    monkeypatch.setattr(spans, "recorded", lambda: rec)
    got = run.read_metric(name, {"kind": kind, "units": 1})
    assert got == (None if want is None else pytest.approx(want))
    other = "stream" if kind == "fit" else "fit"
    assert run.read_metric(name, {"kind": other, "units": 1}) is None


@pytest.mark.parametrize("name", ["frog_replay_share.fit",
                                  "frog_replay_share.update"])
def test_replay_share_without_a_recording(monkeypatch, name):
    monkeypatch.setattr(spans, "recorded", lambda: None)
    kind = "fit" if name.endswith("fit") else "stream"
    assert run.read_metric(name, {"kind": kind, "units": 1}) is None
