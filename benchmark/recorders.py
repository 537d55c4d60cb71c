"""Wrappers that the benchmark puts around the program's functions.

Each wrapper replaces a module attribute by name and puts it back on
`close()`; wrappers of one attribute are closed in the reverse order of
their making. One that finds no such attribute (a later change renamed
or removed it) wraps nothing and says so in `missing`: the per-layer
metrics that need it are left out of the result, and a correctness
number that needs it has no reading, which fails the check.

- `Keep` (every run): holds what the correctness check judges beside the
  particles: the last rejuvenation and reweight, the shuffle, one
  parameter-gradient call with the gradient the leapfrog took.
- `Labels` (the profiled pass): host-clock intervals of the layers' calls,
  to name what the host was doing in the device's idle gaps.
- `Timers` (the recorded pass): synchronising host timers around the
  layers' calls.
- `Costs` (the recorded pass): the operations, special-function calls and
  bytes of each kernel launch (`cost.py`), summed on the device.

Work is counted once for each time the device runs it, whether a Python
call launched it or a CUDA graph replayed it. `Timers`, `Costs` and `Keep`
follow torch.cuda.CUDAGraph's `capture_begin`, `capture_end` and `replay`
while they are open (`Wrapping.watch_graphs`), and no recorder copies from
the host, reads back or synchronises inside a capture.
"""

from __future__ import annotations

import collections
import importlib
import inspect
import time
import weakref

from benchmark import cost

PKG = "autogp_tpu_torch"


def module(name: str):
    return importlib.import_module(f"{PKG}.{name}")


class Wrapping:
    """A set of attribute wrappers, undone by `close`."""

    def __init__(self):
        self._saved = []
        self.missing = []
        self.captures = []

    def wrap(self, mod_name: str, attr: str, make) -> bool:
        try:
            mod = module(mod_name)
        except ImportError:
            mod = None
        fn = getattr(mod, attr, None) if mod is not None else None
        if fn is None:
            self.missing.append(f"{PKG}.{mod_name}.{attr}")
            return False
        self._replace(mod, attr, fn, make)
        return True

    def _replace(self, owner, attr: str, fn, make):
        setattr(owner, attr, make(fn))
        self._saved.append((owner, attr, fn))

    def close(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []

    def watch_graphs(self):
        """Follow torch.cuda.CUDAGraph while open: `captures` holds the
        graphs whose capture this recorder saw begin and not yet end
        (innermost last); `capture_ended(graph, ok)` runs as each of those
        ends, `replayed(graph)` after each replay of any graph."""
        import torch
        cls = torch.cuda.CUDAGraph

        def begin(fn):
            def capture_begin(graph, *a, **k):
                out = fn(graph, *a, **k)
                self.captures.append(graph)
                self.capture_began(graph)
                return out
            return capture_begin

        def end(fn):
            def capture_end(graph, *a, **k):
                ok = False
                try:
                    out = fn(graph, *a, **k)
                    ok = True
                    return out
                finally:
                    if any(g is graph for g in self.captures):
                        self.captures = [g for g in self.captures
                                         if g is not graph]
                        self.capture_ended(graph, ok)
            return capture_end

        def replay(fn):
            def replay(graph, *a, **k):
                out = fn(graph, *a, **k)
                self.replayed(graph)
                return out
            return replay

        for attr, make in (("capture_begin", begin), ("capture_end", end),
                           ("replay", replay)):
            self._replace(cls, attr, getattr(cls, attr), make)

    def capture_began(self, graph):
        pass

    def capture_ended(self, graph, ok: bool):
        pass

    def replayed(self, graph):
        pass


class Keep(Wrapping):
    """What the correctness check judges beside the particles, kept per
    unit (`take`): the last rejuvenation's particles before and after
    ("rejuvenation"), the last reweight's ("reweight"), the shuffle and
    schedule of the last data-annealed run ("anneal"), and one
    parameter-gradient call of parameter HMC ("grad"): the batch, its
    whitened parameters and noise, its data mask, the LMLs and the
    gradient dU/dz that the leapfrog took, caught by a hook on the
    parameters as the program's own backward hands it back. Of the calls
    on the last data that any likelihood saw (its mask), the one with the
    most particles is kept; nothing is synchronised.

    A gradient call made inside a CUDA graph's capture computes nothing
    until the graph replays, and each replay overwrites its tensors. Such
    a call is kept as a copy of all of them taken right after each replay
    of its graph, so that they come from one leapfrog, the last replay;
    one whose graph never replayed is not kept."""

    def __init__(self):
        super().__init__()
        self.kept = {}
        self._mask = None
        self._graph = None      # the kept call's graph, if it was captured
        self._replay = None     # that call's tensors after its last replay

        def rejuvenate(fn):
            def wrapper(gen, particles, *a, **k):
                out = fn(gen, particles, *a, **k)
                self.kept["rejuvenation"] = (particles, out[0])
                return out
            return wrapper

        def reweight(fn):
            def wrapper(particles, *a, **k):
                out = fn(particles, *a, **k)
                self.kept["reweight"] = (particles, out)
                return out
            return wrapper

        def anneal(fn):
            sig = inspect.signature(fn)

            def wrapper(*a, **k):
                args = sig.bind(*a, **k).arguments
                self.kept["anneal"] = (args.get("permutation"),
                                       list(args["schedule"]))
                return fn(*a, **k)
            return wrapper

        def lml(fn):
            def wrapper(node_type, params_z, noise_z, ts, xs, mask, *a, **k):
                out = fn(node_type, params_z, noise_z, ts, xs, mask, *a, **k)
                if mask is not self._mask:    # new data: start again
                    self._mask = mask
                    self.kept.pop("grad", None)
                    self._graph = self._replay = None
                if params_z.requires_grad and out.requires_grad:
                    self._see_gradient_call(node_type, params_z, noise_z,
                                            mask, out)
                return out
            return wrapper

        self.wrap("inference.smc", "rejuvenate_structure", rejuvenate)
        self.wrap("inference.smc", "reweight", reweight)
        self.wrap("inference.smc", "run_smc_anneal_data", anneal)
        self.wrap("model", "lml", lml)
        self.watch_graphs()

    def _see_gradient_call(self, node_type, params_z, noise_z, mask, out):
        best = self.kept.get("grad")
        if best is not None and best["node_type"].shape[0] >= \
                node_type.shape[0]:
            return
        call = {"node_type": node_type, "params": params_z.detach(),
                "noise_z": noise_z.detach().clone(), "mask": mask,
                "lml": out.detach(), "grad": None}

        def hook(g):
            call["grad"] = g.detach().clone()
        params_z.register_hook(hook)
        self.kept["grad"] = call
        self._graph = self.captures[-1] if self.captures else None
        self._replay = None

    def replayed(self, graph):
        # (Inside another capture a copy would only be captured.)
        if graph is self._graph and self._graph is not None \
                and not self.captures:
            self._replay = {k: v.clone() if hasattr(v, "clone") else v
                            for k, v in self.kept["grad"].items()}

    def take(self) -> dict:
        """What was kept since the last take."""
        out, self.kept, self._mask = self.kept, {}, None
        if self._graph is not None:
            if self._replay is None:
                out.pop("grad", None)
            else:
                out["grad"] = self._replay
        self._graph = self._replay = None
        return out


# The layers' calls: (module, attribute, label).
LAYER_CALLS = (
    ("api", "predict", "api.predict"),
    ("api", "fit_smc", "api.fit_smc"),
    ("api", "add_data", "api.add_data"),
    ("api", "remove_data", "api.remove_data"),
    ("api", "maybe_resample", "api.maybe_resample"),
    ("api", "mcmc_structure", "api.mcmc_structure"),
    ("inference.smc", "reweight", "smc.reweight"),
    ("inference.smc", "initialize", "smc.initialize"),
    ("inference.moves", "tree_rejuvenation_step", "moves.mh_step"),
    ("inference.hmc", "params_trajectory", "hmc.params_trajectory"),
    ("inference.hmc", "noise_trajectory", "hmc.noise_trajectory"),
)


class Labels(Wrapping):
    """Host-clock (time.time_ns) change points of the innermost layer
    call: [(ns, label)], "host" outside every call."""

    def __init__(self):
        super().__init__()
        self.points = []
        stack = ["host"]

        def make(label):
            def outer(fn):
                def wrapper(*a, **k):
                    stack.append(label)
                    self.points.append((time.time_ns(), label))
                    try:
                        return fn(*a, **k)
                    finally:
                        stack.pop()
                        self.points.append((time.time_ns(), stack[-1]))
                return wrapper
            return outer

        for mod, attr, label in LAYER_CALLS:
            self.wrap(mod, attr, make(label))


class Timers(Wrapping):
    """Synchronising host timers: total seconds and calls per label. A
    call that starts or ends inside a CUDA graph's capture, where a sync
    would break the capture, is not synchronised and not timed: it is
    left out of its label's reading and counted in `dropped`."""

    def __init__(self, sync):
        super().__init__()
        self.seconds = collections.defaultdict(float)
        self.calls = collections.Counter()
        self.dropped = collections.Counter()

        def make(label):
            def outer(fn):
                def wrapper(*a, **k):
                    if self.capturing():
                        self.dropped[label] += 1
                        return fn(*a, **k)
                    sync()
                    t0 = time.perf_counter()
                    try:
                        return fn(*a, **k)
                    finally:
                        if self.capturing():
                            self.dropped[label] += 1
                        else:
                            sync()
                            self.seconds[label] += time.perf_counter() - t0
                            self.calls[label] += 1
                return wrapper
            return outer

        for mod, attr, label in LAYER_CALLS:
            self.wrap(mod, attr, make(label))
        self.watch_graphs()

    def capturing(self) -> bool:
        """Whether a CUDA graph capture is under way: one this recorder saw
        begin, or one on the current stream."""
        if self.captures:
            return True
        import torch
        return (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())


class Costs(Wrapping):
    """Least seconds of each kernel family's launches on the chip, summed
    on the device (no host sync per launch), and the launches seen.

    A launch is counted each time the device runs it. The sums on the
    device made inside a CUDA graph's capture are captured with the
    program's kernels, and replay with them. The host's tallies (launches,
    the least seconds that shapes alone give) made inside a capture belong
    to that graph and are added once for each of its replays. A replay of
    a graph whose capture this recorder did not see cannot be counted: it
    is named in `unseen`, and no family's count can then be read."""

    FAMILIES = ("cov_tape", "chol_panel", "kinv", "cov_tape_bwd", "factor")

    def __init__(self, device):
        import torch
        super().__init__()
        self.launches = collections.Counter()
        self._sum = {f: torch.zeros((), dtype=torch.float64, device=device)
                     for f in self.FAMILIES}
        self._host = collections.defaultdict(float)
        # [(graph, launches, host)] of the captures under way; a graph's
        # tallies once its capture has ended; the graphs replayed unseen.
        self._open = []
        self._graphs = weakref.WeakKeyDictionary()
        self.unseen = []
        dt = torch.float64
        fwd = cost.tape_table(cost.FWD_COST, device, dt)
        bwd = cost.tape_table(cost.BWD_COST, device, dt)
        rates = torch.tensor([cost.PEAK_F32, cost.PEAK_SFU, cost.PEAK_BYTES],
                             dtype=dt, device=device)

        def on_device(family, flops, sfu, nbytes):
            # A byte count from shapes alone is a host number: a fill,
            # which a capture takes, puts it on the device (a copy would
            # break the capture).
            if not isinstance(nbytes, torch.Tensor):
                nbytes = torch.full((), nbytes, dtype=dt, device=device)
            t = torch.stack([flops.to(dt), sfu.to(dt),
                             nbytes.to(dt)]) / rates
            self._sum[family] += t.max()

        def count(family, least=None):
            launches, host = self._sink()
            if least is not None:
                host[family] += least
            launches[family] += 1

        def f32_cuda(t):
            return t.is_cuda and t.dtype == torch.float32

        def cov_tape(fn):
            def wrapper(node_type, params_t, noise, t_row, t_col, m_row,
                        m_col, depth_cap, gram, lower_only=False, **k):
                out = fn(node_type, params_t, noise, t_row, t_col, m_row,
                         m_col, depth_cap, gram, lower_only, **k)
                if f32_cuda(params_t):
                    on_device("cov_tape", *cost.cov_launch(
                        node_type, m_row, m_col, gram, lower_only, fwd))
                    count("cov_tape")
                return out
            return wrapper

        def panel(fn):
            def wrapper(A):
                out = fn(A)
                if f32_cuda(A):
                    tc, sfu, nbytes = cost.panel_launch(A.shape[0],
                                                        A.shape[1])
                    count("chol_panel", cost.least_seconds(
                        sfu=sfu, nbytes=nbytes, tc=tc))
                return out
            return wrapper

        def factor(fn):
            def wrapper(K, x):
                out = fn(K, x)
                if f32_cuda(K):
                    tc, nbytes = cost.factor_launch(K.shape[0], K.shape[1])
                    count("factor", cost.least_seconds(nbytes=nbytes,
                                                       tc=tc))
                return out
            return wrapper

        def kinv_entry(with_kinv, l_arg):
            def outer(fn):
                def wrapper(*a, **k):
                    out = fn(*a, **k)
                    L = a[l_arg]
                    if f32_cuda(L):
                        P, N = L.shape[0], L.shape[1]
                        tc, nbytes = cost.kinv_launch(P, N, min(N, 128),
                                                      with_kinv)
                        count("kinv", cost.least_seconds(nbytes=nbytes,
                                                         tc=tc))
                    return out
                return wrapper
            return outer

        def bwd_entry(fn):
            def wrapper(node_type, params_t, ts, mask, *a, **k):
                out = fn(node_type, params_t, ts, mask, *a, **k)
                if f32_cuda(params_t):
                    on_device("cov_tape_bwd", *cost.bwd_launch(
                        node_type, mask, fwd, bwd))
                    count("cov_tape_bwd")
                return out
            return wrapper

        self.wrap("ops.cov", "cov_tape", cov_tape)
        self.wrap("ops.chol", "panel_factor", panel)
        for attr in ("chol_solve_diag", "chol_solve", "chol_solve_strips"):
            self.wrap("ops.chol", attr, factor)
        self.wrap("ops.kinv", "kinv_beta_strips", kinv_entry(True, 2))
        self.wrap("ops.kinv", "linv_stats_wd", kinv_entry(False, 0))
        self.wrap("ops.kinv", "kinv_beta", kinv_entry(True, 0))
        self.wrap("ops.kinv", "linv_stats", kinv_entry(False, 0))
        self.wrap("ops.kinv", "linv_beta", kinv_entry(False, 0))
        self.wrap("ops.cov_vjp", "cov_tape_bwd", bwd_entry)
        self.wrap("ops.cov_vjp", "cov_tape_bwd_linv", bwd_entry)
        self.watch_graphs()

    def _sink(self):
        """(launches, host least seconds) that what is seen now adds to:
        the innermost capture's under way, or the totals."""
        if self._open:
            return self._open[-1][1:]
        return self.launches, self._host

    def capture_began(self, graph):
        self._open.append((graph, collections.Counter(),
                           collections.defaultdict(float)))

    def capture_ended(self, graph, ok):
        i = next(i for i, (g, _, _) in enumerate(self._open) if g is graph)
        _, launches, host = self._open.pop(i)
        if ok:
            self._graphs[graph] = (launches, host)

    def replayed(self, graph):
        tally = self._graphs.get(graph)
        if tally is None:
            self.unseen.append(f"{type(graph).__name__} at {id(graph):#x}")
            return
        launches, host = self._sink()
        launches.update(tally[0])
        for family, least in tally[1].items():
            host[family] += least

    def least_seconds(self) -> dict:
        """{family: least seconds of its launches}."""
        out = {f: float(v) for f, v in self._sum.items()}
        for f, v in self._host.items():
            out[f] += v
        return out


# The program's own launch counters by kernel family: (module, counter).
COUNTERS = {
    "cov_tape": (("ops.cov", "launches"),),
    "chol_panel": (("ops.chol", "launches"),),
    "kinv": (("ops.kinv", "strips_launches"), ("ops.kinv", "stats_launches"),
             ("ops.kinv", "linv_beta_launches"),
             ("ops.kinv", "kinv_beta_launches"),
             ("ops.kinv", "linv_stats_launches")),
    "cov_tape_bwd": (("ops.cov_vjp", "launches"),
                     ("ops.cov_vjp", "linv_launches")),
}


def read_counters() -> dict:
    """{family: the program's launch count so far}, None for a family
    whose counter is gone."""
    out = {}
    for family, names in COUNTERS.items():
        total = 0
        for mod, attr in names:
            v = getattr(module(mod), attr, None)
            if v is None:
                total = None
                break
            total += v
        out[family] = total
    return out
