"""The program's spans and host-sync sites beside the profiled pass's
device events.

The program (`autogp_tpu_torch/utils/trace.py`) records the units it runs
while torch.profiler records, with their spans and named sync sites, into
`trace.profiled()`; in a `--trace 1` run that is pass A, and pass B, run
without the profiler, ends the stretch. A tree without that module records
nothing, and every reading here is then None.

- `recorded()`: that recording, or None.
- `on_host(events, host_ns)`: `trace.profile`'s device events as
  [(start_ns, end_ns)] on the host clock, the first event (the marker,
  launched right after the host stamp `host_ns`) setting the offset.
- `by_span(rec, events, host_ns, parts)`: the device time of the
  kernels whose names hold one of `parts`, by the span that launched them
  (`rec.table(on_host(...))` gives each span's calls, host and self ms,
  device and idle ms, named and unnamed syncs).
- The per-unit readings of `metrics/host_syncs.*`,
  `metrics/leapfrog_host_ms.fit`, `metrics/mh_propose_host_ms.update`
  and `metrics/sync_idle_share.*`; the last needs the device events in
  the trace (`trace["device"]`), which only this module's command puts
  there.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>
                               [--out chiprun_out/spans.json]

runs the cell as `python3 -m benchmark.run --trace 1` does, keeps pass A's
device events, and prints the span table, the sync sites, where each
unnamed sync was raised, the six readings, the device time of the
elementwise and GEMM kernels by the span that launched them, and the cost
of a span when tracing is off; `--out` also writes them as one JSON
object.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import statistics
import sys
import timeit

PARAMS_FROG = ("hmc.leapfrog", "hmc.params_trajectory")
PROPOSALS = ("moves.propose_sr", "moves.propose_da")


def recorded():
    """The program's recording of its last profiled units, or None."""
    try:
        from autogp_tpu_torch.utils import trace
    except ImportError:
        return None
    rec = getattr(trace, "profiled", lambda: None)()
    return rec if rec is not None and rec.units else None


def on_host(events, host_ns):
    """[(start_ns, end_ns)] of the device events after the marker, on the
    host clock."""
    if not events:
        return []
    offset = events[0][0] - host_ns
    return [(s - offset, s - offset + d) for s, d, _ in events[1:]]


# Kernel classes whose device time `by_span` splits by span.
KERNEL_CLASSES = {"elementwise": ("elementwise_kernel",),
                  "gemm": ("gemm",)}


def by_span(rec, events, host_ns, parts) -> dict:
    """{span name: device ms} of the kernels whose name holds one of
    `parts`, each by the innermost span open when it started."""
    offset = events[0][0] - host_ns
    times = [t for t, _ in rec.points]
    out = collections.defaultdict(float)
    for start, dur, name in events[1:]:
        if any(p in name for p in parts):
            k = bisect.bisect_right(times, start - offset) - 1
            out[rec.name_of(rec.points[k][1] if k >= 0 else -1)] += \
                dur * 1e-6
    return dict(out)


def _ready(trace, kind):
    if trace.get("kind") != kind or not trace.get("units"):
        return None
    return recorded()


def syncs_per_unit(trace, kind):
    """Named and unnamed host syncs of the profiled pass per unit."""
    rec = _ready(trace, kind)
    if rec is None:
        return None
    return (len(rec.syncs) + len(rec.unnamed)) / trace["units"]


def leapfrog_ms(trace, kind):
    """Mean host ms of a parameter trajectory's leapfrog (one gradient
    evaluation issued, nothing synchronised)."""
    rec = _ready(trace, kind)
    if rec is None:
        return None
    frog, parent = PARAMS_FROG
    spans = rec.spans
    ms = [(s[2] - s[1]) * 1e-6 for s in spans
          if s[0] == frog and s[3] >= 0 and spans[s[3]][0] == parent]
    return statistics.fmean(ms) if ms else None


def propose_ms(trace, kind):
    """Host ms per MH step spent building the two proposals."""
    rec = _ready(trace, kind)
    if rec is None:
        return None
    steps = sum(1 for s in rec.spans if s[0] == "moves.mh_step")
    ms = sum(s[2] - s[1] for s in rec.spans if s[0] in PROPOSALS) * 1e-6
    return ms / steps if steps else None


def sync_idle_share(trace, kind):
    """Percent of the profiled pass's device idle time in gaps during which
    a named sync site returned."""
    rec = _ready(trace, kind)
    if rec is None or not trace.get("device"):
        return None
    return rec.sync_idle_share(trace["device"])


READERS = ("host_syncs.fit", "host_syncs.update", "leapfrog_host_ms.fit",
           "mh_propose_host_ms.update", "sync_idle_share.fit",
           "sync_idle_share.update")


def off_ns_per_span(n: int = 200_000) -> float | None:
    """Nanoseconds of one `with trace.span(...)` while tracing is off."""
    try:
        from autogp_tpu_torch.utils import trace
    except ImportError:
        return None

    def off():
        with trace.span("x"):
            pass
    return min(timeit.repeat(off, number=n, repeat=5)) / n * 1e9


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def format_table(rows: dict) -> list:
    """Lines of the span table, by host self time."""
    head = (f"{'span':28s} {'calls':>8s} {'host_ms':>11s} {'self_ms':>11s} "
            f"{'device_ms':>11s} {'idle_ms':>11s} {'syncs':>7s} "
            f"{'unnamed':>7s}")
    out = [head]
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["self_ms"]):
        out.append(f"{name:28s} {r['calls']:8d} {r['host_ms']:11.3f} "
                   f"{r['self_ms']:11.3f} {r['device_ms']:11.3f} "
                   f"{r['idle_ms']:11.3f} {r['syncs']:7d} "
                   f"{r['unnamed']:7d}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from benchmark import run
    from benchmark import trace as T
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    device = torch.device("cuda", 0)
    kept = {}
    profile, traced = T.profile, run.traced

    def keep_events(unit, dev):
        result, events, host_ns, wall = profile(unit, dev)
        kept.update(events=events, host_ns=host_ns,
                    device=on_host(events, host_ns))
        return result, events, host_ns, wall

    def keep_trace(*a, **k):
        trace_out, n = traced(*a, **k)
        kept["trace"] = trace_out
        return trace_out, n

    T.profile, run.traced = keep_events, keep_trace
    try:
        out, lines = run.run_cell(args.workload, args.seed, args.seconds,
                                  True, device)
    finally:
        T.profile, run.traced = profile, traced
    trace_out = dict(kept["trace"], device=kept["device"])
    rec = recorded()
    result = {"workload": args.workload, "seed": args.seed,
              "correct": out["correct"], "units": trace_out["units"],
              "window_s": out.get("window_s"), "busy_s": out.get("busy_s"),
              "metrics": {k: v["value"] for k, v in out["metrics"].items()},
              "readings": {name: run.read_metric(name, trace_out)
                           for name in READERS},
              "off_ns_per_span": off_ns_per_span(),
              "card": torch.cuda.get_device_name(device)}
    if rec is not None:
        rows = rec.table(trace_out["device"])
        result.update(
            spans=rows, sites=rec.by_site(),
            unnamed_at=dict(collections.Counter(u[3] for u in rec.unnamed)),
            spans_per_unit=len(rec.spans) / trace_out["units"],
            kernels_by_span={c: by_span(rec, kept["events"], kept["host_ns"],
                                        parts)
                             for c, parts in KERNEL_CLASSES.items()})
        for line in format_table(rows):
            log("[spans] " + line)
    log("[spans] " + json.dumps({k: v for k, v in result.items()
                                 if k != "spans"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
