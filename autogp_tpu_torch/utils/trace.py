"""Spans and host-sync sites of the port, kept in memory while recording.

Off by default. Inside `recording()`:

- `span(name)` records its name, its start and end on the host clock
  (`clock`, time.time_ns), its parent span and its unit;
- `unit(name)` is the span of a top-level `api` call: it starts a new
  unit id, which every span inside it carries (a unit inside a unit is a
  plain span of the outer one);
- `sync(site)`, around a deliberate device-to-host read, records its entry
  and return and is counted by site.

On a CUDA device a recording also turns on
`torch.cuda.set_sync_debug_mode("warn")`: the warning of a synchronizing
operation inside an open `sync` belongs to that site, any other is an
unnamed sync of the innermost open span, kept with the line that raised
it. The mode and the warning filters are restored when the recording
ends. Nothing is written during a run; `Recording.table()` sums the spans
afterwards, beside the device's work when it is given on the same clock
(`torch.profiler`'s events, shifted by a marker kernel launched right
after a `clock()` stamp).

A unit entered outside any recording while torch.profiler records is
recorded too, with its spans and syncs, into `profiled()`: a profile of
the program carries its spans, as torch's own `record_function` ranges
do. `profiled()` holds the units of the last stretch of profiled units;
the first unit entered without the profiler ends the stretch, and the
next profiled unit starts another.

Off, `span` and `sync` return one shared no-op context (a test of one
module global), and `unit` also asks torch whether its profiler records.
The port's host work is serial (autograd's device thread runs a backward
while the caller waits for it), so one stack of open spans serves a
recording.

    with trace.recording() as rec:
        A.fit_smc(model, schedule, n_mcmc, n_hmc)
    rec.table()    # {span name: calls, host and self ms, syncs, ...}
"""

from __future__ import annotations

import bisect
import collections
import time
import warnings

import torch

# The clock of every span and sync stamp.
clock = time.time_ns

# The warning of torch.cuda.set_sync_debug_mode("warn"), its start.
SYNC_WARNING = "called a synchronizing CUDA operation"

# The name of the time outside every span.
HOST = "host"


class _Off:
    """The shared no-op context of `span`, `sync` and `unit` when off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_rec = None          # the Recording that spans go to, or None
_profiled = None     # the Recording of the last stretch of profiled units
_stretch = False     # a stretch of profiled units is open


class Recording:
    """What one recording kept, as plain lists:

    - `spans`: [name, start_ns, end_ns, parent span index or -1, unit id
      or -1], in the order entered;
    - `points`: (ns, index of the innermost open span or -1) at every
      entry and exit;
    - `syncs`: [site, entry_ns, return_ns, span index, unit id, warnings
      raised inside];
    - `unnamed`: (ns, span index, unit id, "file:line") of each
      synchronizing operation outside every `sync`;
    - `units`: the unit names by id."""

    def __init__(self):
        self.spans = []
        self.points = []
        self.syncs = []
        self.unnamed = []
        self.units = []
        self._stack = []
        self._sync = None

    def _enter(self, name, is_unit):
        t = clock()
        stack = self._stack
        parent = stack[-1] if stack else -1
        u = self.spans[parent][4] if parent >= 0 else -1
        if is_unit and u < 0:
            u = len(self.units)
            self.units.append(name)
        i = len(self.spans)
        self.spans.append([name, t, t, parent, u])
        stack.append(i)
        self.points.append((t, i))

    def _exit(self):
        t = clock()
        stack = self._stack
        self.spans[stack.pop()][2] = t
        self.points.append((t, stack[-1] if stack else -1))

    def _here(self):
        span = self._stack[-1] if self._stack else -1
        return span, (self.spans[span][4] if span >= 0 else -1)

    def _on_sync_warning(self, filename, lineno):
        if self._sync is not None:
            self._sync[5] += 1
        else:
            self.unnamed.append((clock(), *self._here(),
                                 f"{filename}:{lineno}"))

    def name_of(self, span: int) -> str:
        return self.spans[span][0] if span >= 0 else HOST

    def by_site(self) -> dict:
        """{site: calls}, and the unnamed syncs under "unnamed"."""
        out = collections.Counter(s[0] for s in self.syncs)
        if self.unnamed:
            out["unnamed"] = len(self.unnamed)
        return dict(out)

    def table(self, device=()) -> dict:
        """{span name: {"calls", "host_ms" (start to end), "self_ms" (less
        the spans directly inside), "device_ms" (of the device work that
        started while it was the innermost open span), "idle_ms" (of the
        device's idle time while it was), "syncs" (named sites entered
        directly inside), "unnamed"}}, with HOST for the time outside every
        span. `device`: [(start_ns, end_ns)] of the device's work on this
        clock, sorted by start."""
        out = {}

        def row(span):
            name = self.name_of(span)
            r = out.get(name)
            if r is None:
                r = out[name] = {"calls": 0, "host_ms": 0.0, "self_ms": 0.0,
                                 "device_ms": 0.0, "idle_ms": 0.0,
                                 "syncs": 0, "unnamed": 0}
            return r

        inner = [0] * len(self.spans)
        for _, t0, t1, parent, _ in self.spans:
            if parent >= 0:
                inner[parent] += t1 - t0
        for i, (_, t0, t1, _, _) in enumerate(self.spans):
            r = row(i)
            r["calls"] += 1
            r["host_ms"] += (t1 - t0) * 1e-6
            r["self_ms"] += (t1 - t0 - inner[i]) * 1e-6
        for s in self.syncs:
            row(s[3])["syncs"] += 1
        for u in self.unnamed:
            row(u[1])["unnamed"] += 1
        times = [t for t, _ in self.points]
        spans = [i for _, i in self.points]

        def at(k):
            return spans[k] if k >= 0 else -1

        end = None
        for start, stop in device:
            k = bisect.bisect_right(times, start) - 1
            row(at(k))["device_ms"] += (stop - start) * 1e-6
            if end is not None and start > end:
                # The gap, cut where the innermost open span changes.
                k = bisect.bisect_right(times, end) - 1
                t = end
                while k + 1 < len(times) and times[k + 1] < start:
                    row(at(k))["idle_ms"] += (times[k + 1] - t) * 1e-6
                    t = times[k + 1]
                    k += 1
                row(at(k))["idle_ms"] += (start - t) * 1e-6
            end = stop if end is None else max(end, stop)
        return out

    def sync_idle_share(self, device):
        """Percent of the device's idle time, the gaps between its work
        ([(start_ns, end_ns)] sorted by start, on this clock), spent in
        gaps during which a named `sync` returned; None without a gap."""
        returns = sorted(s[2] for s in self.syncs)
        idle = waited = 0
        end = None
        for start, stop in device:
            if end is not None and start > end:
                idle += start - end
                k = bisect.bisect_left(returns, end)
                if k < len(returns) and returns[k] <= start:
                    waited += start - end
            end = stop if end is None else max(end, stop)
        return 100.0 * waited / idle if idle else None


class _Span:
    __slots__ = ("rec", "name", "is_unit")

    def __init__(self, rec, name, is_unit=False):
        self.rec, self.name, self.is_unit = rec, name, is_unit

    def __enter__(self):
        self.rec._enter(self.name, self.is_unit)

    def __exit__(self, *exc):
        self.rec._exit()
        return False


class _Sync:
    __slots__ = ("rec", "site", "entry", "outer")

    def __init__(self, rec, site):
        self.rec, self.site = rec, site

    def __enter__(self):
        rec = self.rec
        self.entry = [self.site, clock(), 0, *rec._here(), 0]
        self.outer, rec._sync = rec._sync, self.entry

    def __exit__(self, *exc):
        self.entry[2] = clock()
        self.rec._sync = self.outer
        self.rec.syncs.append(self.entry)
        return False


class _Capture:
    """Sends spans to `rec` and counts its synchronizing operations, then
    restores what it changed."""

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        global _rec
        self.outer, _rec = _rec, self.rec
        self.warnings = warnings.catch_warnings()
        self.warnings.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        show = warnings.showwarning
        rec = self.rec

        def hook(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                rec._on_sync_warning(filename, lineno)
            else:
                show(message, category, filename, lineno, file, line)
        warnings.showwarning = hook
        self.mode = None
        if torch.cuda.is_available():
            self.mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return rec

    def __exit__(self, *exc):
        global _rec
        try:
            if self.mode is not None:
                torch.cuda.set_sync_debug_mode(self.mode)
        finally:
            self.warnings.__exit__(*exc)
            _rec = self.outer
        return False


class _ProfiledUnit:
    """A unit entered while torch.profiler records, outside any recording:
    recorded into `profiled()`."""
    __slots__ = ("name", "capture", "span")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _profiled, _stretch
        if not _stretch or _profiled is None:
            _profiled, _stretch = Recording(), True
        self.capture = _Capture(_profiled)
        self.capture.__enter__()
        self.span = _Span(_profiled, self.name, True)
        self.span.__enter__()

    def __exit__(self, *exc):
        try:
            self.span.__exit__(*exc)
        finally:
            self.capture.__exit__(*exc)
        return False


def recording() -> _Capture:
    """A context that records every unit, span and sync inside it; it
    gives the Recording."""
    return _Capture(Recording())


def span(name: str):
    """A context: one span of `name` while recording, else nothing."""
    rec = _rec
    if rec is None:
        return _OFF
    return _Span(rec, name)


def sync(site: str):
    """A context around a deliberate device-to-host read at `site`."""
    rec = _rec
    if rec is None:
        return _OFF
    return _Sync(rec, site)


def unit(name: str):
    """A context: the span of a top-level `api` call, which starts a
    unit; outside any recording, recorded into `profiled()` while
    torch.profiler records."""
    global _stretch
    rec = _rec
    if rec is not None:
        return _Span(rec, name, True)
    if not torch._C._autograd._profiler_enabled():
        _stretch = False
        return _OFF
    return _ProfiledUnit(name)


def profiled():
    """The Recording of the last stretch of units run under
    torch.profiler, or None."""
    return _profiled
