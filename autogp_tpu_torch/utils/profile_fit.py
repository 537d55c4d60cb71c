"""Where the time of the config-4 fit goes, on one NVIDIA GPU.

    python3 -m autogp_tpu_torch.utils.profile_fit

Runs the fit of chip_smoke.py's end-to-end phase (64 particles, a
synthetic N = 1024 series, linear_schedule(1024, .25), n_mcmc=10,
n_hmc=10) three times after a warm-up fit:

1. plain, timed with CUDA events;
2. with host timers (each followed by a synchronize) around the MH step,
   the parameter-HMC trajectory and the noise-HMC trajectory, which gives
   the fit's split between structure moves and HMC and the trajectories'
   count and mean time;
3. under torch.profiler (CPU and CUDA activities): device busy time (the
   sum of kernel times) and idle share over the profiled fit, device time
   by kernel, and host time by op. The profiler slows the host, so that
   idle share is an upper bound for the unprofiled fit; the busy time over
   the plain fit's wall time gives the lower one.

Prints one line per measurement and a JSON object as its last line. It
needs a card; it fails on a machine without one.
"""

from __future__ import annotations

import collections
import json
import sys
import time
import warnings

import numpy as np
import torch


def _series(n: int):
    """chip_smoke.py's synthetic series (the same numpy draws)."""
    rng = np.random.default_rng(0)
    rng.standard_normal(n)          # chip_smoke.py's phase-4 draw
    t = np.arange(n, dtype=np.float64)
    y = (0.02 * t + 3.0 * np.sin(2 * np.pi * t / 52.0)
         + 1.5 * np.sin(2 * np.pi * t / 13.0)
         + 0.5 * rng.standard_normal(n))
    return t, y


def _fit(A, t, y, seed):
    A.seed(seed)
    m = A.GPModel(t, y, n_particles=64)
    A.fit_smc(m, schedule=A.Schedule.linear_schedule(len(t), 0.25),
              n_mcmc=10, n_hmc=10)
    torch.cuda.synchronize()
    return m


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        sys.exit(1)
    warnings.simplefilter("ignore")
    import autogp_tpu_torch as A
    from autogp_tpu_torch.inference import hmc, smc
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t, y = _series(1024)
    A.seed(0)
    warm = A.GPModel(t, y, n_particles=64)
    A.fit_smc(warm, schedule=A.Schedule.linear_schedule(1024, .25),
              n_mcmc=1, n_hmc=1)
    torch.cuda.synchronize()
    out = {"device": torch.cuda.get_device_name(0)}

    # 1. plain
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    m = _fit(A, t, y, seed=1)
    ev[1].record()
    ev[1].synchronize()
    out["fit_ms"] = ev[0].elapsed_time(ev[1])
    out["round_stats"] = m.round_stats
    print(f"[fit] {out['fit_ms']:.1f} ms; per round {m.round_stats}",
          flush=True)

    # 2. host timers around the three pieces of a rejuvenation step
    spent = collections.defaultdict(float)
    calls = collections.Counter()

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            calls[name] += 1
            return r
        return wrapper
    saved = (smc.moves.tree_rejuvenation_step, hmc.params_trajectory,
             hmc.noise_trajectory)
    smc.moves.tree_rejuvenation_step = timed("mh_step", saved[0])
    hmc.params_trajectory = timed("param_trajectory", saved[1])
    hmc.noise_trajectory = timed("noise_trajectory", saved[2])
    t0 = time.perf_counter()
    _fit(A, t, y, seed=1)
    total = time.perf_counter() - t0
    smc.moves.tree_rejuvenation_step, hmc.params_trajectory, \
        hmc.noise_trajectory = saved
    out["timed_fit_s"] = total
    out["split_s"] = dict(spent)
    out["calls"] = dict(calls)
    print(f"[split] fit {total:.3f} s with synchronizing timers: " + ", ".join(
        f"{k} {v:.3f} s in {calls[k]} calls ({v / calls[k] * 1e3:.2f} ms "
        f"each)" for k, v in spent.items())
        + f", rest {total - sum(spent.values()):.3f} s", flush=True)

    # 3. torch.profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _fit(A, t, y, seed=1)
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    # Kernel rows only: an op row's device time repeats its kernels'.
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in avg if e.device_type == DeviceType.CUDA),
                 key=lambda r: -r[1])
    busy = sum(r[1] for r in dev)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in avg), key=lambda r: -r[1])
    out["profiled_wall_ms"] = wall * 1e3
    out["device_busy_ms"] = busy
    out["idle_share"] = 1.0 - busy / (wall * 1e3)
    out["idle_share_vs_plain_fit"] = 1.0 - busy / out["fit_ms"]
    out["device_top"] = [list(r) for r in dev[:12]]
    out["host_top"] = [list(r) for r in host[:12]]
    out["kernel_launches"] = sum(r[2] for r in dev)
    print(f"[profile] wall {wall * 1e3:.1f} ms (profiled), device busy "
          f"{busy:.1f} ms, idle share {out['idle_share']:.4f} (against the "
          f"plain fit's wall {out['idle_share_vs_plain_fit']:.4f}), "
          f"{out['kernel_launches']} device kernels", flush=True)
    for k, ms, n in dev[:12]:
        print(f"  device {ms:10.3f} ms {n:7d} x {k[:90]}", flush=True)
    for k, ms, n in host[:12]:
        print(f"  host   {ms:10.3f} ms {n:7d} x {k[:90]}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
