"""Where the time of a fit goes, on one NVIDIA GPU, by the port's spans.

    python3 -m autogp_tpu_torch.utils.profile_fit [config4|online32|config3]

`config4` (the default) is the fit of chip_smoke.py's end-to-end phase (64
particles, a synthetic N = 1024 series, linear_schedule(1024, .25),
n_mcmc=10, n_hmc=10). `online32` is the start of its online phase: 128
particles, the per-point schedule 1, 2, ..., 8 on the first 8 points of
that phase's series (every round in the 32-point bucket, where the
gradient takes the dense route), n_mcmc=5, n_hmc=5, n_exit=1, depth cap 5,
without the logging callback. `config3` is its greedy phase:
fit_greedy(max_depth=3) on the 144-point airline series, one particle,
GPConfig(changepoints=False, max_depth=3). After a warm-up fit the fit
runs twice inside `utils/trace.py`'s recording, as one span "fit" that
ends when the device is done:

1. recorded alone: each span's calls, host and self milliseconds, the
   host-sync sites by count, and the line of each synchronizing operation
   that no site names;
2. recorded under torch.profiler (CUDA activity), the device's kernels
   shifted onto the spans' clock by a marker kernel launched right after a
   `trace.clock()` stamp: each span's device milliseconds and the device's
   idle milliseconds while it was the innermost open span, the share of
   idle time in gaps during which a named site returned, the busy and idle
   shares and device time by kernel. The profiler slows the host, so that
   idle share is an upper bound for the unprofiled fit.

Prints both span tables and a JSON object as its last line. It needs a
card; it fails on a machine without one.
"""

from __future__ import annotations

import collections
import json
import sys
import warnings

import numpy as np
import torch

from autogp_tpu_torch.utils import trace


def _series(n: int, skip: int):
    """chip_smoke.py's synthetic series: the same numpy draws, after the
    `skip` draws the script makes before them."""
    rng = np.random.default_rng(0)
    rng.standard_normal(skip)
    t = np.arange(n, dtype=np.float64)
    y = (0.02 * t + 3.0 * np.sin(2 * np.pi * t / 52.0)
         + 1.5 * np.sin(2 * np.pi * t / 13.0)
         + 0.5 * rng.standard_normal(n))
    return t, y


def _workload(A, name: str):
    """(t, y, GPModel keywords, fit_smc keywords) of a named fit."""
    if name == "config4":
        t, y = _series(1024, skip=1024)
        return t, y, {"n_particles": 64}, {
            "schedule": A.Schedule.linear_schedule(1024, 0.25),
            "n_mcmc": 10, "n_hmc": 10}
    if name == "online32":
        t, y = _series(544, skip=0)
        return t[:8], y[:8], {
            "n_particles": 128, "config": A.GPConfig(max_depth=5)}, {
            "schedule": list(range(1, 9)), "n_mcmc": 5, "n_hmc": 5,
            "shuffle": False, "hmc_config": {"n_exit": 1}}
    if name == "config3":
        rng = np.random.default_rng(0)
        t = np.arange(144, dtype=float)
        y = (1.0 + 0.02 * t) * (10.0 + 3.0 * np.sin(2 * np.pi * t / 12.0)) \
            + 0.5 * rng.standard_normal(144)
        return t, y, {"n_particles": 1, "config": A.GPConfig(
            changepoints=False, max_depth=3)}, {"max_depth": 3}
    raise SystemExit(f"unknown workload {name!r}: config4, online32 or "
                     f"config3")


def _fit(A, work, seed, **override):
    t, y, model_kw, fit_kw = work
    A.seed(seed)
    m = A.GPModel(t, y, **model_kw)
    with trace.span("fit"):
        if "max_depth" in fit_kw:
            A.fit_greedy(m, **fit_kw)
        else:
            A.fit_smc(m, **{**fit_kw, **override})
        with trace.sync("fit.end"):
            torch.cuda.synchronize()
    return m


def _print_table(title, rows):
    print(f"[{title}] {'span':28s} {'calls':>8s} {'host_ms':>11s} "
          f"{'self_ms':>11s} {'device_ms':>11s} {'idle_ms':>11s} "
          f"{'syncs':>6s} {'unnamed':>7s}", flush=True)
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["self_ms"]):
        print(f"[{title}] {name:28s} {r['calls']:8d} {r['host_ms']:11.3f} "
              f"{r['self_ms']:11.3f} {r['device_ms']:11.3f} "
              f"{r['idle_ms']:11.3f} {r['syncs']:6d} {r['unnamed']:7d}",
              flush=True)


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        sys.exit(1)
    import autogp_tpu_torch as A
    from torch.profiler import ProfilerActivity, profile

    name = sys.argv[1] if len(sys.argv) > 1 else "config4"
    work = _workload(A, name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _fit(A, work, seed=0, n_mcmc=1, n_hmc=1)      # warm-up
    out = {"workload": name, "device": torch.cuda.get_device_name(0)}

    # 1. recorded alone
    with trace.recording() as rec:
        m = _fit(A, work, seed=1)
    rows = rec.table()
    out["fit_ms"] = rows["fit"]["host_ms"]
    out["round_stats"] = m.round_stats
    out["spans"] = rows
    out["sites"] = rec.by_site()
    out["unnamed_at"] = dict(collections.Counter(u[3] for u in rec.unnamed))
    print(f"[fit] {out['fit_ms']:.1f} ms recorded; sites {out['sites']}; "
          f"unnamed at {out['unnamed_at']}", flush=True)
    _print_table("spans", rows)

    # 2. recorded under torch.profiler
    marker = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with trace.recording() as rec:
            torch.cuda.synchronize()
            host_ns = trace.clock()
            marker.add_(1.0)
            _fit(A, work, seed=1)
    events = sorted((e.start_ns(), e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type().name == "CUDA")
    offset = events[0][0] - host_ns
    device = [(s - offset, s - offset + d) for s, d, _ in events[1:]]
    rows = rec.table(device)
    wall = rows["fit"]["host_ms"]
    busy = sum(d for _, d, _ in events[1:]) * 1e-6
    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    for _, d, k in events[1:]:
        by_kernel[k][0] += d * 1e-6
        by_kernel[k][1] += 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    out["profiled_fit_ms"] = wall
    out["device_busy_ms"] = busy
    out["idle_share"] = 1.0 - busy / wall
    out["sync_idle_share"] = rec.sync_idle_share(device)
    out["kernel_launches"] = len(events) - 1
    out["device_top"] = [[k[:90], ms, n] for k, (ms, n) in top]
    out["profiled_spans"] = rows
    print(f"[profile] fit {wall:.1f} ms (profiled), device busy "
          f"{busy:.1f} ms, idle share {out['idle_share']:.4f}, idle in "
          f"gaps with a named sync's return {out['sync_idle_share']:.2f}%, "
          f"{out['kernel_launches']} device kernels", flush=True)
    _print_table("profiled", rows)
    for k, ms, n in out["device_top"]:
        print(f"  device {ms:10.3f} ms {n:7d} x {k}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
