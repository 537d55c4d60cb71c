"""The recorders under CUDA graphs, on the CPU: a fake torch.cuda.CUDAGraph
(capture_begin, capture_end, replay) stands in for torch's, and objects
that read as float32 CUDA tensors of a shape stand in for the kernels'
inputs, so that each wrapper counts as it does on the card.

A launch counts once for each time the device would run it: the host's
tallies made inside a capture wait for the graph's replays, k replays
add them k times, and a replay of a graph whose capture no recorder saw
leaves every family unread. What the device sums inside a capture, and
whether torch.profiler sees a replay's kernels, only the card shows
(`test_bench_card.py`)."""

import math

import pytest
import torch

from benchmark import cost, recorders as R, run


class FakeGraph:
    """torch.cuda.CUDAGraph's three calls; `replay` runs `body`, where a
    test writes what the device would."""

    def __init__(self, body=None):
        self.body = body

    def capture_begin(self, *a, **k):
        pass

    def capture_end(self):
        pass

    def replay(self):
        if self.body is not None:
            self.body()


class OnCard:
    """What a wrapper reads of a float32 CUDA tensor: its shape."""
    is_cuda = True
    dtype = torch.float32

    def __init__(self, *shape):
        self.shape = shape


@pytest.fixture
def fake(monkeypatch):
    """The fake graph class in torch's place, and stubs of the kernels'
    entries that the recorders wrap (each returns None)."""
    from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    for mod, attr in ((chol, "panel_factor"), (chol, "chol_solve_strips"),
                      (kinv, "kinv_beta_strips"), (cov, "cov_tape"),
                      (cov_vjp, "cov_tape_bwd")):
        monkeypatch.setattr(mod, attr, lambda *a, **k: None)
    return FakeGraph


P, N, B = 8, 256, 128


def one_gradient_evaluation():
    """The host side of one LML gradient on the fused route: a covariance
    launch, a factorization with its two panels, K^-1 and the tape
    backward."""
    from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv
    nt = torch.tensor([[3, 0, 0]] * P)
    m = torch.ones(N)
    cov.cov_tape(nt, OnCard(P, 3, 3), None, None, None, m, m, 2, True,
                 True)
    chol.chol_solve_strips(OnCard(P, N, N), None)
    for _ in range(N // B):
        chol.panel_factor(OnCard(P, B, B))
    kinv.kinv_beta_strips(None, None, OnCard(P, N, N))
    cov_vjp.cov_tape_bwd(nt, OnCard(P, 3, 3), None, m)


# Launches of one gradient evaluation.
ONE = {"cov_tape": 1, "factor": 1, "chol_panel": N // B, "kinv": 1,
       "cov_tape_bwd": 1}


def per_launch():
    """{family: least seconds of one launch} of the families whose least
    seconds the host adds up from shapes."""
    tc, nbytes = cost.factor_launch(P, N)
    factor = cost.least_seconds(nbytes=nbytes, tc=tc)
    tc, sfu, nbytes = cost.panel_launch(P, B)
    panel = cost.least_seconds(sfu=sfu, nbytes=nbytes, tc=tc)
    tc, nbytes = cost.kinv_launch(P, N, B, True)
    return {"factor": factor, "chol_panel": panel,
            "kinv": cost.least_seconds(nbytes=nbytes, tc=tc)}


def captured(graph):
    graph.capture_begin()
    one_gradient_evaluation()
    graph.capture_end()


def test_eager_calls_count_as_before(fake):
    costs = R.Costs("cpu")
    for _ in range(3):
        one_gradient_evaluation()
    costs.close()
    assert dict(costs.launches) == {f: 3 * n for f, n in ONE.items()}
    least = costs.least_seconds()
    for f, v in per_launch().items():
        total = 0.0                          # one addition a launch
        for _ in range(3 * ONE[f]):
            total += v
        assert least[f] == total
    assert costs.unseen == []


def test_tallies_made_in_a_capture_wait_for_a_replay(fake):
    costs = R.Costs("cpu")
    captured(fake())
    least = costs.least_seconds()
    costs.close()
    assert sum(costs.launches.values()) == 0
    assert least["chol_panel"] == least["kinv"] == least["factor"] == 0.0


@pytest.mark.parametrize("k", [1, 2, 11])
def test_k_replays_add_k_times_the_capture(fake, k):
    costs = R.Costs("cpu")
    g = fake()
    captured(g)
    one_gradient_evaluation()              # an eager call beside it
    for _ in range(k):
        g.replay()
    costs.close()
    assert dict(costs.launches) == {f: (k + 1) * n for f, n in ONE.items()}
    least = costs.least_seconds()
    for f, v in per_launch().items():
        assert math.isclose(least[f], (k + 1) * ONE[f] * v, rel_tol=1e-12)


def test_a_graph_discarded_without_replay_adds_nothing(fake):
    costs = R.Costs("cpu")
    g = fake()
    captured(g)
    del g
    other = fake()
    captured(other)
    other.replay()
    costs.close()
    assert dict(costs.launches) == ONE
    assert costs.unseen == []


def _trace(costs, profiled):
    """The trace that `run.traced` hands the readers, with every family's
    device time at 1 ms."""
    fam_ok = run.families_ok(costs.launches, costs.unseen, profiled)
    return {"kind": "fit", "units": 1, "wall_s": 1.0, "busy_s": 0.5,
            "launches": sum(profiled.values()),
            "family_s": {f: 1e-3 for f in run.FAMILY_KERNELS},
            "family_ok": fam_ok, "least_s": costs.least_seconds(),
            "factor_ok": costs.launches["factor"] > 0 and not costs.unseen,
            "timers": {}}


READERS = ("cov_tape_roofline.fit", "chol_panel_roofline.fit",
           "kinv_roofline.fit", "cov_tape_bwd_roofline.fit", "mfu.fit")


@pytest.mark.parametrize("unseen", [False, True])
def test_a_replay_whose_capture_no_recorder_saw_is_never_read(fake,
                                                              unseen):
    """The planted fault: a graph captured before the recorders opened
    replays inside the recorded pass. It holds one factorization entry
    alone, whose work no profiled count checks, so every count the gate
    compares agrees, and only the unseen replay keeps the whole-step
    share from reading short."""
    from autogp_tpu_torch.ops import chol
    g = fake()

    def capture():
        g.capture_begin()
        chol.chol_solve_strips(OnCard(P, N, N), None)
        g.capture_end()
    if unseen:
        capture()                           # before the recorders open
    costs = R.Costs("cpu")
    if not unseen:
        capture()
    one_gradient_evaluation()
    for _ in range(3):
        g.replay()
    costs.close()
    profiled = {run.FAMILY_KERNELS[f][1]: ONE[f] for f in run.FAMILY_KERNELS}
    trace = _trace(costs, profiled)
    assert set(trace["family_ok"].values()) == {not unseen}
    assert costs.launches["factor"] == (1 if unseen else 4)
    assert costs.unseen == (["FakeGraph at " + hex(id(g))] * 3 if unseen
                            else [])
    for name in READERS:
        got = run.read_metric(name, trace)
        assert (got is None) is unseen, name


def test_a_count_the_profiler_does_not_match_is_not_read(fake):
    costs = R.Costs("cpu")
    one_gradient_evaluation()
    costs.close()
    profiled = {run.FAMILY_KERNELS[f][1]: ONE[f] for f in run.FAMILY_KERNELS}
    profiled["linv_kernel"] = 0               # the profiler missed it
    ok = run.families_ok(costs.launches, costs.unseen, profiled)
    assert ok == {"cov_tape": True, "chol_panel": True, "kinv": False,
                  "cov_tape_bwd": True}


def test_close_restores_the_class(fake):
    before = dict(vars(fake))
    recs = [R.Timers(lambda: None), R.Costs("cpu"), R.Keep()]
    assert all(vars(fake)[m] is not before[m]
               for m in ("capture_begin", "capture_end", "replay"))
    for r in reversed(recs):
        r.close()
    assert dict(vars(fake)) == before


def test_timers_drop_a_call_made_inside_a_capture(fake, monkeypatch):
    from autogp_tpu_torch.inference import hmc
    monkeypatch.setattr(hmc, "params_trajectory", lambda *a, **k: 7)
    syncs = []
    timers = R.Timers(lambda: syncs.append(1))
    assert hmc.params_trajectory() == 7
    g = fake()
    g.capture_begin()
    assert hmc.params_trajectory() == 7
    g.capture_end()
    timers.close()
    assert timers.calls["hmc.params_trajectory"] == 1
    assert timers.dropped["hmc.params_trajectory"] == 1
    assert len(syncs) == 2                  # the eager call's two only


def _lml(node_type, params_z, noise_z, ts, xs, mask, *a, **k):
    return (params_z ** 2).sum((1, 2)) + noise_z


def _gradient_call(q, nz, mask):
    """One leapfrog's gradient call through the wrapped model.lml."""
    from autogp_tpu_torch import model
    with torch.enable_grad():
        lml = model.lml(torch.zeros(2, 3, dtype=torch.int64), q, nz, None,
                        None, mask, None, None)
        (g,) = torch.autograd.grad(lml.sum(), q)
    return lml, g


def test_keep_holds_the_last_replay_of_a_captured_gradient(fake,
                                                            monkeypatch):
    from autogp_tpu_torch import model
    monkeypatch.setattr(model, "lml", _lml)
    keep = R.Keep()
    mask = torch.ones(4)
    nz = torch.zeros(2)
    q = torch.zeros(2, 3, 3, requires_grad=True)   # the graph's input
    g = fake()
    g.capture_begin()
    _gradient_call(q, nz, mask)
    g.capture_end()
    call = keep.kept["grad"]

    def device_writes():
        # What a replay computes: the LML and the gradient at q.
        call["lml"].copy_(_lml(None, q.detach(), nz, None, None, None))
        call["grad"].copy_(2 * q.detach())
    g.body = device_writes
    for i in range(3):
        with torch.no_grad():
            q.fill_(float(i + 1))
        g.replay()
    with torch.no_grad():
        q.fill_(-5.0)                       # a copy after the last replay
    kept = keep.take()["grad"]
    keep.close()
    assert (kept["params"] == 3.0).all()
    assert (kept["grad"] == 6.0).all()
    assert (kept["lml"] == 81.0).all()
    assert kept["mask"] is not mask and (kept["mask"] == mask).all()


def test_keep_drops_a_captured_gradient_never_replayed(fake, monkeypatch):
    from autogp_tpu_torch import model
    monkeypatch.setattr(model, "lml", _lml)
    keep = R.Keep()
    q = torch.zeros(2, 3, 3, requires_grad=True)
    g = fake()
    g.capture_begin()
    _gradient_call(q, torch.zeros(2), torch.ones(4))
    g.capture_end()
    assert "grad" not in keep.take()
    keep.close()


def test_keep_holds_an_eager_gradient_as_before(fake, monkeypatch):
    from autogp_tpu_torch import model
    monkeypatch.setattr(model, "lml", _lml)
    keep = R.Keep()
    mask = torch.ones(4)
    q = torch.full((2, 3, 3), 2.0, requires_grad=True)
    lml, grad = _gradient_call(q, torch.zeros(2), mask)
    kept = keep.take()["grad"]
    keep.close()
    # The tensors the leapfrog used, not copies; the gradient as handed
    # back.
    assert kept["mask"] is mask
    assert kept["params"].data_ptr() == q.data_ptr()
    assert torch.equal(kept["grad"], grad) and torch.equal(kept["lml"], lml)
