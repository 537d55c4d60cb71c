"""The profiled pass: device time by kernel, launches, busy time and the
idle gaps, read from torch.profiler's CUDA activity in memory (no trace
file is written).

Only CUDA activity is recorded (a fit launches about half a million
kernels; recording every host op as well would slow the host far more).
What the host was doing in a gap comes from `recorders.Labels`: host-clock
change points of the layers' calls, aligned to the device clock by a
marker kernel launched right after a host timestamp.
"""

from __future__ import annotations

import bisect
import collections
import time


def kernel_name(name: str) -> str:
    """A kernel's function name without its namespace, template
    arguments, parameters or return type ("Memcpy ..." and "Memset ..."
    rows keep their kind)."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split("(")[0].strip()
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    base = base.split("(")[0].split("<")[0].strip()
    return base.split(" ")[-1].split("::")[-1]


def profile(unit, device):
    """Run `unit()` under torch.profiler (CUDA activity). Returns (the
    unit's result, the device events [(start_ns, duration_ns, name)]
    sorted by start, the host time of the marker, the wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    # On the CPU (the tests) the host's ops stand in for the device's.
    on_card = device.type == "cuda"
    activity = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
    marker = torch.zeros(1, device=device)
    with torch_profile(activities=[activity]) as prof:
        if on_card:
            torch.cuda.synchronize(device)
        host_ns = time.time_ns()
        marker.add_(1.0)
        t0 = time.perf_counter()
        result = unit()
        if on_card:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == activity.name:
            events.append((e.start_ns(), e.duration_ns(), e.name()))
    events.sort()
    return result, events, host_ns, wall


def reduce(events, host_ns, label_points, top=10):
    """Per-kernel device seconds and launches, busy seconds, and the
    breakdown: the `top` kernels by device time and the idle gaps summed
    by the host's innermost layer call at the end of each gap. The first
    event is the marker: it sets the host-to-device clock offset and is
    left out."""
    if not events:
        return None
    offset = events[0][0] - host_ns
    events = events[1:]
    seconds = collections.defaultdict(float)
    counts = collections.Counter()
    busy_ns = 0
    for start, dur, name in events:
        k = kernel_name(name)
        seconds[k] += dur * 1e-9
        if not (k.startswith("Memcpy") or k.startswith("Memset")):
            counts[k] += 1
        busy_ns += dur
    times = [t + offset for t, _ in label_points]
    labels = [lab for _, lab in label_points]
    gaps = collections.defaultdict(float)
    end = None
    for start, dur, _ in events:
        if end is not None and start > end:
            i = bisect.bisect_right(times, start) - 1
            gaps[labels[i] if i >= 0 else "host"] += (start - end) * 1e-9
        end = start + dur if end is None else max(end, start + dur)
    return {
        "kernel_s": dict(seconds), "kernel_launches": dict(counts),
        "launches": sum(counts.values()), "busy_s": busy_ns * 1e-9,
        "breakdown": {
            "device_ops": [[k, v] for k, v in sorted(
                seconds.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:top]]},
    }
