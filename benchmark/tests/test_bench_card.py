"""On the card: a cell cut small runs end to end, traced and not, and
comes out correct; the recorders count a CUDA graph's replays and work
inside its capture. Skips without a card."""

import collections

import pytest
import torch

from benchmark import run
from benchmark.tests.small import small


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["config4.fit_p512_nopredict",
                                  "config5.stream_w512_nopredict"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_cell_runs_on_the_card(cuda_device, cell, trace):
    out, lines = run.run_cell(cell, 2 ** 31 + 5, 1.0, trace, cuda_device,
                              override=small(n_particles=64, n_points=256,
                                             window=256))
    assert out["correct"] is True, lines
    if trace:
        assert out["busy_s"] > 0 and out["metrics"]


def _gradient(M, batch, q):
    """One LML gradient call as a parameter leapfrog makes it."""
    nt, nz, ts, xs, mask, cfg, tables = batch
    with torch.enable_grad():
        lml = M.lml(nt, q, nz, ts, xs, mask, cfg, tables)
        (g,) = torch.autograd.grad(lml.sum(), q)
    return lml, g


def _batch(device, P=8, N=256):
    """A config-4 batch of P trees from the prior on N points: the fused
    gradient route (kernels 1, 2, kinv, 5)."""
    import autogp_tpu_torch as A
    from autogp_tpu_torch import model as M
    from benchmark import check, workload as W
    config = W.load_json(W.ROOT / "configs" / "config4.json")
    g = config["gp_config"]
    cfg = A.GPConfig(changepoints=g["changepoints"], max_depth=g["max_depth"],
                     static_max_depth=g["static_max_depth"],
                     prior=config["prior"])
    tables = M.prior_tables(cfg, device, torch.float32)
    gen = torch.Generator(device=device).manual_seed(2 ** 31 + 11)
    nt, pz = M.sample_tree(gen, P, tables, torch.float32, device)
    nz = torch.randn(P, generator=gen, device=device)
    t, y = W.series({"n": N, "trend": 0.02, "periods": [52, 13],
                     "amplitudes": [3.0, 1.5], "noise": 0.5}, 5)
    (ts_, ti), (ys, yi) = check.transforms(t, y)
    ts = torch.as_tensor(ts_ * t + ti, dtype=torch.float32, device=device)
    xs = torch.as_tensor(ys * y + yi, dtype=torch.float32, device=device)
    qs = [pz + 0.05 * k * torch.randn(pz.shape, generator=gen, device=device)
          for k in range(11)]
    return M, (nt, nz, ts, xs, torch.ones_like(ts), cfg, tables), pz, qs


def _capture(body):
    """A CUDA graph of `body()`, captured on a side stream."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(s):
        graph.capture_begin()
        body()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(s)
    return graph


def _graphed(M, batch, static_q, qs, inside=lambda: None):
    """A graphed trajectory: capture one gradient call (`inside()` runs
    within the capture), then replay it once for each q of `qs`, copied
    into the graph's input first. Returns the graph."""
    def body():
        _gradient(M, batch, static_q)
        inside()
    graph = _capture(body)
    for q in qs:
        with torch.no_grad():
            static_q.copy_(q)
        graph.replay()
    return graph


def _kernel_counts(fn, device):
    from benchmark import trace as T
    _, events, host_ns, _ = T.profile(fn, device)
    return T.reduce(events, host_ns, [])["kernel_launches"]


@pytest.mark.gpu
def test_a_captured_gradient_counts_once_a_replay(cuda_device, monkeypatch):
    """A parameter leapfrog's gradient, captured in a CUDA graph inside a
    timed trajectory and replayed 11 times, with every recorder open:
    nothing breaks the capture; the recorder counts the launches and least
    seconds of 11 eager calls on the same inputs; torch.profiler sees each
    replayed kernel 11 times; Keep holds the last replay's gradient."""
    from autogp_tpu_torch.inference import hmc
    from benchmark import recorders as R
    dev = cuda_device
    M, batch, pz, qs = _batch(dev)
    static_q = pz.clone().requires_grad_(True)
    s = torch.cuda.Stream()                    # warm-up, off the record
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        _gradient(M, batch, static_q)
    torch.cuda.current_stream().wait_stream(s)

    # The profiler: one eager call, then a capture and 11 replays, each
    # with the copy of its q into the graph's input.
    q0 = pz.clone().requires_grad_(True)

    def eager_call():
        with torch.no_grad():
            q0.copy_(qs[0])
        _gradient(M, batch, q0)
    one = _kernel_counts(eager_call, dev)
    graphed = _kernel_counts(lambda: _graphed(M, batch, static_q, qs), dev)
    # Beside the replays, what torch itself runs as a capture begins (its
    # generators' state fills, outside the graph), read from a capture of
    # one kernel that is never replayed.
    x = torch.zeros(4, device=dev)
    begin = _kernel_counts(lambda: _capture(lambda: x.add_(1.0)), dev)
    want = collections.Counter({k: 11 * n for k, n in one.items()})
    want.update(begin)
    assert graphed == dict(want), (one, begin, graphed)
    for main in ("cov_tape_kernel", "chol_panel_kernel", "linv_kernel",
                 "cov_tape_bwd_kernel"):
        assert one.get(main, 0) > 0, (main, one)

    # The recorders, with the capture inside a timed trajectory and a
    # timed call inside the capture.
    monkeypatch.setattr(hmc, "noise_trajectory", lambda: None)
    monkeypatch.setattr(hmc, "params_trajectory", lambda: _graphed(
        M, batch, static_q, qs, inside=lambda: hmc.noise_trajectory()))
    timers = R.Timers(lambda: torch.cuda.synchronize(dev))
    costs = R.Costs(dev)
    keep = R.Keep()
    graph = hmc.params_trajectory()
    torch.cuda.synchronize(dev)
    kept = keep.take().get("grad")
    graph_launches, graph_least = dict(costs.launches), costs.least_seconds()
    for r in (keep, costs, timers):
        r.close()
    del graph
    assert costs.unseen == []
    assert timers.calls["hmc.params_trajectory"] == 1
    assert timers.dropped == {"hmc.noise_trajectory": 1}

    costs = R.Costs(dev)
    eager = [_gradient(M, batch, q.clone().requires_grad_(True)) for q in qs]
    torch.cuda.synchronize(dev)
    costs.close()
    assert graph_launches == dict(costs.launches)
    assert set(graph_launches) >= {"cov_tape", "chol_panel", "kinv",
                                   "cov_tape_bwd", "factor"}
    for fam, least in costs.least_seconds().items():
        assert least > 0, fam
        assert abs(graph_least[fam] - least) <= 1e-12 * least, fam

    lml, grad = eager[-1]
    assert kept is not None
    assert torch.equal(kept["params"], qs[-1])
    torch.testing.assert_close(kept["lml"], lml.detach(), rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(kept["grad"], grad, rtol=0, atol=0,
                               equal_nan=True)
