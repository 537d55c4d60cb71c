"""Wall-clock accumulation helpers (reference: src/TimeIt.jl).

The Julia `@timeit counter expr` macro becomes a context manager that adds
elapsed seconds to a named counter, plus an optional torch.profiler trace
wrapper for GPU timelines.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

_counters = defaultdict(float)


@contextlib.contextmanager
def timeit(counter: str):
    """with timeit("smc_step"): ...  — accumulates into a global counter."""
    t0 = time.time()
    try:
        yield
    finally:
        _counters[counter] += time.time() - t0


def elapsed(counter: str) -> float:
    return _counters[counter]


def reset(counter: str = None):
    if counter is None:
        _counters.clear()
    else:
        _counters.pop(counter, None)


@contextlib.contextmanager
def profile(log_dir: str):
    """Capture a torch.profiler trace of the host and the card into
    `log_dir` (a Chrome trace; view it in Perfetto or chrome://tracing)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile as _profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with _profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
