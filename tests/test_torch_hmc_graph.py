"""HMC's graphed trajectories, on the CPU: which trajectories replay a CUDA
graph, and the bookkeeping around the capture and the replays, with
stand-ins for torch.cuda's streams and graphs. That a replay gives the
eager leapfrog's bits only the card shows (tests/test_torch_cuda.py)."""

import types
import warnings

import pytest
import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import model as TM
from autogp_tpu_torch import tree as TT
from autogp_tpu_torch.inference import hmc, smc
from autogp_tpu_torch.ops import chol, cov
from autogp_tpu_torch.utils import trace

F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(P=4, N=16, seed=3):
    """Depth-3 prior trees on N points (3/4 active), their LMLs and one
    trajectory's draws, float64 on the CPU."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = C.GPConfig(max_depth=3)
    tab = TM.prior_tables(cfg, "cpu", F64)
    gen = torch.Generator().manual_seed(seed)
    nt, pz = TM.sample_tree(gen, P, tab, F64, "cpu")
    nz = torch.randn(P, generator=gen, dtype=F64) - 1.0
    n = 3 * N // 4
    ts = torch.linspace(0, 1, n, dtype=F64)
    xs = torch.sin(4 * torch.pi * ts) + 0.1 * torch.randn(n, generator=gen,
                                                        dtype=F64)
    data = smc.make_dataset(ts.numpy(), xs.numpy(), n=n, pad_to=N, dtype=F64,
                            device="cpu")
    d = (data.ts, data.xs, data.mask)
    lml = TM.lml(nt, pz, nz, *d, cfg, tab)
    draws = (torch.randn(pz.shape, generator=gen, dtype=F64)
             * TT.param_mask(nt), torch.randn(P, generator=gen, dtype=F64),
             torch.rand(P, generator=gen, dtype=F64))
    return nt, pz, nz, lml, d, cfg, tab, draws


def _trajectory(kind, inputs, eps=0.05, L=10):
    nt, pz, nz, lml, d, cfg, tab, (mom_p, mom_n, u) = inputs
    if kind == "params":
        return hmc.params_trajectory(nt, pz, nz, lml, d, cfg, tab, eps, L,
                                     mom_p, u)
    return hmc.noise_trajectory(nt, pz, nz, lml, d, cfg, tab, eps, L, mom_n,
                                u)


@pytest.mark.parametrize("slots, n, on_card, want", [
    (31, 256, False, False), (31, 256, True, True), (15, 64, True, True),
    (31, 1024, True, True), (63, 256, True, False),
    (1023, 256, True, False), (31, 32, True, False),
    (31, 200, True, False), (1023, 32, False, False)])
def test_a_trajectory_is_graphed_on_the_card_on_small_heaps_and_buckets(
        slots, n, on_card, want):
    """The rule: a CUDA time grid, heaps of at most cov.SMALL_HEAP slots,
    whose tapes need no read-back, and a bucket of the closed-form
    gradient (a power of two >= 64); anything else runs eagerly."""
    nt = torch.zeros((2, slots), dtype=torch.int64)
    ts = (types.SimpleNamespace(is_cuda=True, shape=(n,)) if on_card
          else torch.zeros(n))
    assert hmc._use_graph(nt, ts) is want


@pytest.mark.parametrize("kind", ["params", "noise"])
def test_a_trajectory_on_the_cpu_runs_every_leapfrog_eagerly(kind):
    inputs = _inputs()
    with trace.recording() as rec:
        _trajectory(kind, inputs)
    names = [s[0] for s in rec.spans]
    assert names.count("hmc.leapfrog") == 11
    assert "hmc.capture" not in names and "hmc.replay" not in names


class _Replays:
    """A graph of `fn` that runs it at each replay, as the device would."""

    def __init__(self, fn):
        self.fn = fn
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.fn()


@pytest.mark.parametrize("kind", ["params", "noise"])
def test_replays_run_the_leapfrogs_the_eager_loop_runs(kind, monkeypatch):
    """With the capture standing in (each replay runs the captured
    leapfrog), a graphed trajectory is the eager one bit for bit: one
    capture in the second leapfrog, ten replays, and every replay adds
    the capture's launch counts to the ops' counters."""
    inputs = _inputs(seed=7)
    eager = _trajectory(kind, inputs)
    graphs = []
    counts = [0] * len(hmc._COUNTERS)
    counts[hmc._COUNTERS.index((cov, "launches"))] = 1
    counts[hmc._COUNTERS.index((chol, "launches"))] = 3

    def capture(fn, device):
        graphs.append(_Replays(fn))
        return graphs[-1], counts
    monkeypatch.setattr(hmc, "_use_graph", lambda *a: True)
    monkeypatch.setattr(hmc, "_capture", capture)
    for mod, name in ((cov, "launches"), (chol, "launches")):
        monkeypatch.setattr(mod, name, 0)
    with trace.recording() as rec:
        graphed = _trajectory(kind, inputs)
    for a, b in zip(eager, graphed):
        assert torch.equal(a, b)
    assert len(graphs) == 1 and graphs[0].replays == 10
    assert (cov.launches, chol.launches) == (10, 30)
    spans = rec.spans
    inside = [[spans[j][0] for j in range(len(spans)) if spans[j][3] == i]
              for i, s in enumerate(spans) if s[0] == "hmc.leapfrog"]
    assert [x for x in inside if "hmc.replay" in x] == (
        [["hmc.capture", "hmc.replay"]] + [["hmc.replay"]] * 9)
    assert "hmc.capture" not in inside[0] and "hmc.replay" not in inside[0]


class _FakeCuda:
    """torch.cuda's streams, graphs and pool handles as `_capture` uses
    them, logging each call."""

    def __init__(self, monkeypatch):
        self.log = []
        log = self.log
        fake = self

        class Stream:
            def __init__(self, device):
                self.device = device
                log.append(("stream", device))

            def wait_stream(self, other):
                log.append(("wait", self, other))

        class Graph:
            def capture_begin(self, pool=None):
                log.append(("begin", pool))

            def capture_end(self):
                log.append(("end",))
                if fake.end_fails:
                    raise RuntimeError("capture invalidated")

        class Context:
            def __init__(self, s):
                self.s = s

            def __enter__(self):
                log.append(("enter", self.s))

            def __exit__(self, *exc):
                log.append(("exit", self.s))

        class Caller:
            def wait_stream(self, other):
                log.append(("wait", self, other))

        self.end_fails = False
        self.caller = Caller()
        handles = iter(range(100))
        for name, value in (
                ("Stream", Stream), ("CUDAGraph", Graph), ("stream", Context),
                ("current_stream", lambda device=None: self.caller),
                ("graph_pool_handle", lambda: ("pool", next(handles)))):
            monkeypatch.setattr(torch.cuda, name, value)
        monkeypatch.setattr(hmc, "_side_streams", {})
        monkeypatch.setattr(hmc, "_pools", {})
        monkeypatch.setattr(hmc, "_last_graphs", {})


def test_a_capture_counts_its_launches_and_leaves_the_counters(monkeypatch):
    """What a capture's Python calls count is one replay's launches, not
    launches made: the counters come back to where they were. The side
    stream and the pool are made once for the device, the side stream
    waits for the caller before the capture and the caller for it
    after. The last graph is kept, to hold the pool, until the next
    capture has taken it."""
    fake = _FakeCuda(monkeypatch)
    monkeypatch.setattr(cov, "launches", 5)
    monkeypatch.setattr(chol, "launches", 7)

    def leapfrog():
        cov.launches += 1
        chol.launches += 4
    dev = torch.device("cuda", 0)
    first, counts = hmc._capture(leapfrog, dev)
    assert hmc._last_graphs[0] is first
    second, again = hmc._capture(leapfrog, dev)
    assert hmc._last_graphs[0] is second
    assert (cov.launches, chol.launches) == (5, 7)
    assert counts == again
    by = dict(zip(hmc._COUNTERS, counts))
    assert by.pop((cov, "launches")) == 1 and by.pop((chol, "launches")) == 4
    assert set(by.values()) == {0}
    kinds = [e[0] for e in fake.log]
    assert kinds.count("stream") == 1
    side = hmc._side_streams[0]
    assert fake.log[1:7] == [("wait", side, fake.caller), ("enter", side),
                             ("begin", ("pool", 0)), ("end",),
                             ("exit", side), ("wait", fake.caller, side)]
    assert [e for e in fake.log if e[0] == "begin"] == [("begin",
                                                         ("pool", 0))] * 2


@pytest.mark.parametrize("end_fails", [False, True])
def test_a_leapfrog_that_fails_in_its_capture_ends_it_and_raises(
        monkeypatch, end_fails):
    fake = _FakeCuda(monkeypatch)
    fake.end_fails = end_fails

    def leapfrog():
        raise ValueError("a tape longer than the kernel stages")
    with pytest.raises(ValueError, match="tape"):
        hmc._capture(leapfrog, torch.device("cuda", 0))
    kinds = [e[0] for e in fake.log]
    assert kinds[kinds.index("begin") + 1] == "end" and kinds[-1] == "exit"
