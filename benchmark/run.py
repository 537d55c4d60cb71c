"""Benchmark of autogp_tpu_torch (the PyTorch + CUDA port) on one card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

run from the root of a checkout. The cell is an entry of BENCHMARK.json:
its configuration file and its traffic file (`workloads/<traffic>.json`)
say what runs. Set-up (import, the kernel library, the data, the warm-up)
is timed as `setup_s`; then units of work run back to back for
`--seconds` (`workload.window`), and the window's end-to-end metrics are
taken on the host clock. `--trace 1` instead runs the cell's unit twice
from the same seed and state: once under torch.profiler (device time by
kernel, launches, busy and idle time) and once with the benchmark's
recorders (synchronising layer timers, the kernels' operation and byte
counts, each launch counted every time the device runs it, CUDA graph
replays included); the per-layer readers in `metrics/` turn both into
the cell's per-layer metrics. A kernel family's roofline is read only
where the recorded launches of pass B are the profiled launches of pass
A (`families_ok`).

Every run then checks what its timed path produced against the plain
reference (`check.py`), prints each number compared beside its limit as
the last lines of standard error, and prints one JSON object as the last
line of standard output. Without a card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded once the window has
closed, it prints no result and exits with a non-zero code.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One process with few threads: the program's host work is serial Python,
# and idle pools of spinning threads on a shared host only add noise.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import workload as W  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "autogp_tpu")

# Kernel families: (the device kernels by name, the one counted once per
# entry launch).
FAMILY_KERNELS = {
    "cov_tape": (("cov_tape_kernel",), "cov_tape_kernel"),
    "chol_panel": (("chol_panel_kernel",), "chol_panel_kernel"),
    "kinv": (("linv_kernel", "kinv_lower_kernel", "fro_sum_kernel"),
             "linv_kernel"),
    "cov_tape_bwd": (("cov_tape_bwd_kernel", "reduce_tiles_kernel"),
                     "cov_tape_bwd_kernel"),
}


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (autogp_tpu_torch is not autogp_tpu)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def load_cell(name: str, root: Path = ROOT):
    """(BENCHMARK.json, the cell's entry, its configuration, its traffic)."""
    bench = W.load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: one of {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = W.load_json(root / configs[cell["config"]]["file"])
    traffic = W.load_json(BENCH_DIR / "workloads" / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: str, key: str) -> list:
    """The metric entries of `key` ("end_to_end" or "per_layer") that the
    cell reports."""
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, trace: dict):
    """The per-layer reader `metrics/<name>.py` applied to `trace`: a
    number, or None where it finds nothing to read."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        log(f"[trace] no reader {path.name}: {name} left out")
        return None
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


class Picker:
    """Which units the check judges: `check.units` drawn from the seed
    among the first `check.among`, and the slowest of the window; where
    none of those made a parameter-gradient call, also the last unit
    that made one."""

    def __init__(self, traffic: dict, seed: int):
        chk = traffic["check"]
        rng = W.seed_rng(seed, 2)
        k = min(chk["units"], chk["among"])
        self.drawn = set(rng.choice(chk["among"], size=k,
                                    replace=False).tolist())
        self.kept = {}
        self.slowest = (-1.0, None)
        self.last_grad = None
        self.failed = 0

    def see(self, index, record, seconds, kept):
        if not forecast_finite(record):
            self.failed += 1
        if kept.get("grad") is not None:
            self.last_grad = (index, (record, kept))
        if index in self.drawn:
            self.kept[index] = (record, kept)
        if seconds > self.slowest[0]:
            self.slowest = (seconds, index)
            if index not in self.drawn:
                self.kept = {i: v for i, v in self.kept.items()
                             if i in self.drawn}
                self.kept[index] = (record, kept)

    def units(self):
        out = dict(self.kept)
        if self.last_grad is not None and not any(
                kept.get("grad") is not None for _, kept in out.values()):
            out.setdefault(*self.last_grad)
        return [out[i] for i in sorted(out)]


def forecast_finite(record) -> bool:
    """Every forecast number of the particles with weight is finite (or
    the unit forecasts nothing)."""
    df = record["df"]
    if df is None:
        return True
    live = df["weight"].to_numpy() > 0
    cols = [c for c in df.columns if c.startswith("y_")]
    return bool(np.isfinite(df.loc[live, cols].to_numpy()).all())


def judge_units(units, config, traffic, device):
    """The worst reading of each number over the judged units, and the
    control's where the traffic asks for it."""
    from benchmark import check
    from benchmark.reference import gp as ref
    model = ref.Model(config)
    worst, worst_c = {}, {}
    for record, kept in units:
        got, ctl = check.readings(model, record, kept, traffic, device)
        for src, dst in ((got, worst), (ctl, worst_c)):
            for k, v in src.items():
                dst[k] = max(dst.get(k, -math.inf), v)
    return worst, worst_c


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             override=None, t_start=None):
    """Run one cell; returns (result dict, [(name, value, limit, ok)]).
    `override(config, traffic)` -> (config, traffic) resizes a cell for
    the tests on the CPU."""
    import torch
    t_start = T_START if t_start is None else t_start
    bench, cell, config, traffic = load_cell(name)
    if override is not None:
        config, traffic = override(config, traffic)
    split = {"python_torch_s": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.zeros(1, device=device)
    split["cuda_init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    import autogp_tpu_torch as A
    from autogp_tpu_torch.ops import _build
    split["import_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if device.type == "cuda":
        _build.library()
    split["library_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    unit = W.make_unit(A, config, traffic, seed, device)
    split["data_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    unit.setup()
    split["warmup_s"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    log("[setup] " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; setup_s {setup_s:.3f}")

    from benchmark import recorders as R
    picker = Picker(traffic, seed)
    out = {"metrics": {}}
    if not trace:
        keep = R.Keep()
        window_s, durations = W.window(
            unit, seconds, lambda i, rec, s: picker.see(i, rec, s,
                                                        keep.take()),
            unit.cycle)
        keep.close()
        n = len(durations)
        log(f"[window] {n} units in {window_s:.3f} s; unit seconds "
            + " ".join(f"{d:.3f}" for d in durations))
        e2e = W.end_to_end(traffic, window_s, durations)
        e2e["setup_s"] = setup_s
        for m in cell_metrics(bench, name, "end_to_end"):
            if m["name"] in e2e:
                out["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                             "unit": m["unit"]}
        attempted = n
    else:
        trace_out, attempted = traced(unit, traffic, seconds, device, picker)
        for m in cell_metrics(bench, name, "per_layer"):
            v = read_metric(m["name"], trace_out)
            if v is None:
                log(f"[trace] {m['name']}: nothing to read, left out")
                continue
            out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        out["busy_s"] = trace_out["busy_s"]
        out["window_s"] = trace_out["wall_s"]
        out["breakdown"] = trace_out["breakdown"]
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    log(f"[memory] peak allocated {out['memory_peak_bytes']} bytes")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found}")
    units = picker.units()
    del unit
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    from benchmark import check
    worst, _ = judge_units(units, config, traffic, device)
    worst["failed_share"] = picker.failed / max(attempted, 1)
    ok, lines = check.judge(worst, {**traffic["limits"],
                                    "failed_share": 0.0})
    for n, v, lim, fine in lines:
        if v is None:
            log(f"[check] {n}: no reading (its recorder found nothing to "
                f"read): not correct")
    log(f"[check] {len(units)} units judged in "
        f"{time.perf_counter() - t0:.3f} s")
    out.update(correct=ok, attempted=attempted, failed=picker.failed)
    return out, lines


def traced(unit, traffic, seconds, device, picker):
    """Passes A (profiled) and B (recorded) over the same unit(s)."""
    import torch
    from benchmark import recorders as R
    from benchmark import trace as T
    state = unit.snapshot()
    # The traced units: one, or as many as fill the kind's share of
    # --seconds.
    budget = seconds * W.load_module("kinds", traffic["kind"]).TRACE_SHARE

    labels = R.Labels()
    count0 = R.read_counters()
    (_, durations), events, host_ns, wall = T.profile(
        lambda: W.window(unit, budget), device)
    count1 = R.read_counters()
    labels.close()
    k = len(durations)
    t0 = time.perf_counter()
    red = T.reduce(events, host_ns, labels.points)
    log(f"[trace] pass A: {k} units, {len(events)} device events, wall "
        f"{wall:.3f} s; reduced in {time.perf_counter() - t0:.3f} s")
    del events

    unit.restore(state)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    timers = R.Timers(sync)
    costs = R.Costs(device)
    keep = R.Keep()
    for index in range(k):
        t0 = time.perf_counter()
        record = unit.run(index)
        sync()
        picker.see(index, record, time.perf_counter() - t0, keep.take())
    count2 = R.read_counters()
    for w in (keep, costs, timers):
        w.close()
    missing = sorted(set(timers.missing + costs.missing + keep.missing
                         + labels.missing))
    if missing:
        log(f"[trace] not found, their metrics left out: {missing}")
    if timers.dropped:
        log(f"[trace] calls inside a CUDA graph capture, left out of their "
            f"timers: {dict(timers.dropped)}")
    if costs.unseen:
        log(f"[trace] CUDA graphs replayed whose capture no recorder saw, "
            f"so no family's launches can be counted: "
            f"{sorted(set(costs.unseen))}")
    least = costs.least_seconds()
    profiled = (red or {}).get("kernel_launches", {})
    fam_ok = families_ok(costs.launches, costs.unseen, profiled)
    for fam, (_, main) in FAMILY_KERNELS.items():
        # The program's own counters count its Python calls, not what a
        # graph replays: logged beside the gate, not part of it.
        a = None if count0[fam] is None else count1[fam] - count0[fam]
        b = None if count1[fam] is None else count2[fam] - count1[fam]
        seen = profiled.get(main, 0)
        agree = fam_ok[fam] and a == b == costs.launches[fam]
        if not agree and (a or seen or costs.launches[fam]):
            log(f"[trace] {fam}: program counters pass A {a}, pass B {b}; "
                f"recorded {costs.launches[fam]}, profiled {seen}"
                + ("" if fam_ok[fam] else ": no roofline"))
    kernel_s = (red or {}).get("kernel_s", {})
    out = {
        "kind": traffic["kind"], "units": k, "wall_s": wall,
        "busy_s": (red or {}).get("busy_s", 0.0),
        "launches": (red or {}).get("launches", 0),
        "breakdown": (red or {}).get("breakdown",
                                     {"device_ops": [], "idle_gaps": []}),
        "family_s": {f: sum(kernel_s.get(n, 0.0) for n in ks)
                     for f, (ks, _) in FAMILY_KERNELS.items()},
        "family_ok": fam_ok, "least_s": least,
        "factor_ok": costs.launches["factor"] > 0 and not costs.unseen,
        "timers": {lab: {"seconds": timers.seconds[lab],
                         "calls": timers.calls[lab]}
                   for lab in timers.calls},
        "missing": missing,
    }
    log("[trace] " + json.dumps({k2: v for k2, v in out.items()
                                 if k2 != "breakdown"}))
    return out, k


def families_ok(launches, unseen, profiled) -> dict:
    """{family: whether its launches can be read}: the recorder's launches
    of pass B, replays included, equal the launches of the family's main
    kernel that torch.profiler counted in pass A, and both are above 0,
    with no graph replayed whose capture the recorder did not see."""
    return {fam: not unseen and launches[fam] == profiled.get(main, 0) > 0
            for fam, (_, main) in FAMILY_KERNELS.items()}


def device_info(device, out) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": out.pop("memory_peak_bytes")}
    for key in ("busy_s", "window_s"):
        if key in out:
            info[key] = out.pop(key)
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    _, cell, _, _ = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"the cell asks for {cell['chips']} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    device = torch.device("cuda", 0)
    out, lines = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), device)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    print(json.dumps(result_line(out, lines, device_info(device, out))),
          flush=True)
    for n, v, lim, fine in lines:
        log(f"check {n} {v!r} limit {lim!r} {'ok' if fine else 'FAIL'}")
    return 0


def result_line(out: dict, lines: list, device: dict) -> dict:
    """The result's JSON object: the keys every result carries, then the
    numbers compared, each with its limit, under a key of its own that
    comes last."""
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    # JSON has no infinity: a number that is not finite is given as null.
    result["checks"] = {n: {"value": (v if v is not None and math.isfinite(v)
                                      else None),
                            "limit": lim} for n, v, lim, _ in lines}
    return result


if __name__ == "__main__":
    sys.exit(main())
