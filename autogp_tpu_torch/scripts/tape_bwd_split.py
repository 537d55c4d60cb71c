"""Where kernel 5's time goes (the tape backward, csrc/cov_tape_bwd.cu), and
kernels 1 and 5 alone at the fit's shapes, for one source tree or two.

Run on a machine with a card, from the repository root:

    python3 -m autogp_tpu_torch.scripts.tape_bwd_split [CSRC ...] [--split]

Each CSRC is a directory holding cov_tape.cu, cov_tape_bwd.cu and
cov_formulas.cuh (default: the package's csrc/). An older revision is
unpacked with `git archive REV autogp_tpu_torch/csrc | tar -x -C DIR`.

Without --split it builds each tree's cov_tape.cu and cov_tape_bwd.cu as
they are and prints, for each tree in turns (A B B A with two trees),
the time of kernel 1 (gram, lower_only) at [64, N, N] with 3/4 of the
points active for N = 256, 512, 1024, and of kernel 5's fused entry at
N = 256, 512, 1024 with 256, 512, 768 and 1024 points active (the buckets
and active counts of the config-4 fit), of its in-tape entry (5c) at
N = 1024 with 768 active, and of its unfused entry (5b) at N = 32 and 1024
on a random cotangent, with nvcc's -Xptxas -v lines for both kernels
(registers, spills, shared memory). With two trees it also says whether
their kernel 1 and kernel 5 outputs are bitwise equal, and each tree's 5c
bitwise its kernel 5.

--split builds copies of each tree's cov_tape_bwd.cu with clock64()
stamps (one set per block, read by thread (0, 0)) and prints, at
[64, 1024, 1024] with 768 points active, the mean cycles per block of:
staging the tape and parameters and zeroing the accumulators; forming
the cotangent; the forward sweep; the reverse sweep; the gradient-term
reductions (the reverse sweep's cycles less those of a copy whose
reduction is a plain add); waiting at the last barrier; writing the
partials. Active tiles and all-masked tiles are averaged apart, and the
share of all-masked lower tiles is printed. The stamp anchors of both
layouts are known: the per-element warp reduction of the earlier design
(get it with `git archive c5bd0cc autogp_tpu_torch/csrc`) and the
per-thread accumulators that replaced it.

The inputs are `chip_smoke.py`'s: 64 prior trees (ChangePoints on) from
its seed, K^-1 and beta from the kinv kernel on the factor of their grams
(and for 5c, L^-1 and beta from the same factor).
Every build is a copy in a temporary directory; nothing in the package
changes. Times are CUDA events, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from autogp_tpu_torch.ops import _build

P, N_MAIN, N_ACT = 64, 1024, 768
FIT_SHAPES = [(256, 256), (512, 512), (1024, 256), (1024, 512), (1024, 768),
              (1024, 1024)]
TILE = 32

_STAMP_HEAD = r"""
__device__ long long* g_stamps;
extern "C" int autogp_set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}
#define STAMP_BEGIN() long long _t = clock64(); long long _c[8] = {0, 0, 0, \
  0, 0, 0, 0, 0}
#define STAMP(k) do { const long long _n = clock64(); _c[k] += _n - _t; \
  _t = _n; } while (0)
#define STAMP_END() do { if (threadIdx.x == 0 && threadIdx.y == 0) { \
  long long* _o = g_stamps + 8 * ((long long)blockIdx.y * gridDim.x \
                                  + blockIdx.x); \
  for (int _k = 0; _k < 7; ++_k) _o[_k] = _c[_k]; \
  _o[7] = gridDim.x; } } while (0)
"""

PHASES = ["staging", "cotangent", "forward", "reverse", "barrier",
          "partials"]

# (anchor, text put before it, text put after it), per layout; each anchor
# must occur once in the kernel's source.
LAYOUTS = {
    "per-element warp reduction": {
        "detect": "const WarpAcc acc{wacc + warp * n_acc, lane};",
        "anchors": [
            ("extern __shared__ double smem_d[];", "", "\n  STAMP_BEGIN();"),
            ("  for (int rr = ty; rr < kTile; rr += blockDim.y) {",
             "  STAMP(0);\n", ""),
            ("    if (diag_tile) acc(n_acc - 1, (i_raw == j_raw) ? kb : 0.0);",
             "", "\n    STAMP(1);"),
            ("    // Reverse sweep: adjoints, and the gradient terms.",
             "    STAMP(2);\n", ""),
            ("  }\n  __syncthreads();\n\n  // Warps in order",
             "    STAMP(3);\n", ""),
            ("  // Warps in order into this tile's partial.", "  STAMP(4);\n",
             ""),
            ("    out[k] = s;\n  }\n", "", "  STAMP(5);\n  STAMP_END();\n"),
        ],
        "plain_acc": ("    const double s = warp_sum(term);\n"
                      "    if (lane == 0) row[idx] += s;",
                      "    if (lane == 0) row[idx] += term;"),
    },
    "per-thread accumulators": {
        "detect": "// split: staged",
        "anchors": [
            ("double smem_d[];", "", "\n  STAMP_BEGIN();"),
            ("// split: staged", "STAMP(0); ", ""),
            ("// split: cotangent", "STAMP(1); ", ""),
            ("// split: forward", "STAMP(2); ", ""),
            ("// split: reverse", "STAMP(3); ", ""),
            ("// split: barrier", "STAMP(4); ", ""),
            ("// split: partials", "STAMP(5); STAMP_END(); ", ""),
        ],
        "plain_acc": ("a[idx * T + tid] += term;",
                      "a[idx * T + tid] = term;"),
    },
}


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"anchor not found once in the source: {old!r}")
    return src.replace(old, new)


def layout_of(src: str) -> str:
    for name, lay in LAYOUTS.items():
        if lay["detect"] in src:
            return name
    raise ValueError("cov_tape_bwd.cu has no known stamp layout")


def stamped(src: str, header: str, plain_acc: bool):
    """(kernel source, cov_formulas.cuh) with the stamps, and with the
    gradient-term reduction made a plain add when `plain_acc`."""
    lay = LAYOUTS[layout_of(src)]
    src = _replace(src, '#include "cov_formulas.cuh"\n',
                   '#include "cov_formulas.cuh"\n' + _STAMP_HEAD)
    for anchor, before, after in lay["anchors"]:
        src = _replace(src, anchor, before + anchor + after)
    if plain_acc:
        old, new = lay["plain_acc"]
        if old in src:
            src = _replace(src, old, new)
        else:
            header = _replace(header, old, new)
    return src, header


def headers_of(d: Path) -> dict:
    """The headers (*.cuh) of a source tree: file name -> text."""
    return {h.name: h.read_text() for h in sorted(d.glob("*.cuh"))}


def build(units: dict, tmp: Path) -> dict:
    """units: name -> (source text, headers {file name: text}, file name).
    One nvcc per unit, side by side; name -> (loaded library, ptxas
    lines)."""
    cmds, out = [], {}
    for i, (name, (text, headers, fname)) in enumerate(units.items()):
        d = tmp / f"u{i}"
        d.mkdir()
        for hname, htext in headers.items():
            (d / hname).write_text(htext)
        (d / fname).write_text(text)
        so = d / "lib.so"
        log = d / "ptxas.txt"
        cmds.append(["bash", "-c", " ".join(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-I", str(d),
             "-o", str(so), str(d / fname), ">", str(log), "2>&1"])])
        out[name] = (so, log)
    try:
        _build._run_all(cmds)
    except RuntimeError:
        for so, log in out.values():
            if log.exists():
                print(log.read_text())
        raise
    res = {}
    for name, (so, log) in out.items():
        lib = ctypes.CDLL(str(so))
        res[name] = (lib, ptxas_lines(log.read_text()))
    return res


def ptxas_lines(log: str) -> list:
    """`Compiling entry` / `Used N registers` lines of the kernels, each
    entry's name demangled far enough to read."""
    lines, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            continue
        if name and ("registers" in ln or "spill" in ln or "stack" in ln):
            lines.append(f"{name}: {ln.split('ptxas info    :')[-1].strip()}")
    return lines


def cuda_ms(fn, reps) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


class Inputs:
    """chip_smoke.py's prior trees and, per (N, active), the grid, the
    tapes, K^-1 and beta."""

    def __init__(self, dev):
        import warnings

        from autogp_tpu_torch import config as C
        from autogp_tpu_torch import model as M
        warnings.simplefilter("ignore")
        self.dev = dev
        cfg = C.GPConfig()
        tab = M.prior_tables(cfg, dev, torch.float32)
        gen = torch.Generator(device=dev)
        gen.manual_seed(20261016)
        self.D = cfg.depth_cap
        self.nt, pz = M.sample_tree(gen, P, tab, torch.float32, dev)
        noise_z = torch.randn(P, generator=gen, device=dev)
        self.pt = M.transform_params(self.nt, pz, tab)
        self.noise = M.transform_noise(noise_z, cfg)
        self.xs = torch.as_tensor(np.random.default_rng(0).standard_normal(
            N_MAIN), dtype=torch.float32, device=dev)
        from autogp_tpu_torch.ops import cov
        self.tape = cov.build_tape(self.nt, self.D)
        self.cache = {}

    def grid(self, N, n_act):
        ts = torch.zeros(N, device=self.dev)
        ts[:n_act] = torch.linspace(0, 1, n_act, device=self.dev)
        mask = torch.zeros(N, device=self.dev)
        mask[:n_act] = 1.0
        return ts, mask

    def bwd(self, N, n_act):
        """(ts, mask, K^-1 lower-only, beta, g) at this shape."""
        if (N, n_act) not in self.cache:
            from autogp_tpu_torch.ops import chol, cov, kinv
            ts, mask = self.grid(N, n_act)
            K = cov.cov_tape(self.nt, self.pt, self.noise, ts, ts, mask, mask,
                             self.D, True, True)
            xs = self.xs[:N] * mask
            _, a, wd, L = chol.chol_solve_strips(K, xs.expand(P, N))
            Ki, beta, _ = kinv.kinv_beta_strips(a, wd, L)
            g = torch.ones(P, device=self.dev)
            self.cache[(N, n_act)] = (ts, mask, Ki, beta, g)
            self.cache[("linv", N, n_act)] = kinv.linv_beta(L, a, wd)[:2]
        return self.cache[(N, n_act)]

    def linv(self, N, n_act):
        """(V = L^-1, beta) of the factor `bwd` used at this shape."""
        self.bwd(N, n_act)
        return self.cache[("linv", N, n_act)]


def bwd_call(lib, inp, N, n_act, linv=False):
    """Kernel 5 (or, with `linv`, its in-tape entry 5c) on `inp`'s
    inputs at this shape."""
    name = "autogp_cov_tape_bwd_linv" if linv else "autogp_cov_tape_bwd"
    fn = getattr(lib, name)
    fn.argtypes = _build.SIGNATURES[name]
    fn.restype = ctypes.c_int
    ts, mask, Ki, beta, g = inp.bwd(N, n_act)
    if linv:
        Ki, beta = inp.linv(N, n_act)
    M = inp.nt.shape[1]
    nt = N // TILE
    n_acc = 3 * M + 1
    partial = torch.empty((P, nt * (nt + 1) // 2, n_acc),
                          dtype=torch.float64, device=inp.dev)
    out = torch.empty((P, n_acc), dtype=torch.float32, device=inp.dev)
    tslot, ttype, tlpos, trpos, tlen = inp.tape
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(tslot.data_ptr(), ttype.data_ptr(), tlpos.data_ptr(),
                 trpos.data_ptr(), tlen.data_ptr(), inp.pt.data_ptr(),
                 ts.data_ptr(), mask.data_ptr(), Ki.data_ptr(),
                 beta.data_ptr(), g.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), P, M, N, stream)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return out
    return run


def unfused_call(lib, inp, N):
    """Kernel 5b on a fixed random cotangent, N / 32 * 3 // 4 rows of tiles
    active (the online run's 32-point bucket and the chip_smoke shape)."""
    fn = lib.autogp_cov_tape_bwd_unfused
    fn.argtypes = _build.SIGNATURES["autogp_cov_tape_bwd_unfused"]
    fn.restype = ctypes.c_int
    ts, mask = inp.grid(N, N * 3 // 4)
    gen = torch.Generator(device=inp.dev).manual_seed(N)
    kbar = torch.randn(P, N, N, generator=gen, device=inp.dev)
    M = inp.nt.shape[1]
    nt = -(-N // TILE)
    n_acc = 3 * M + 1
    partial = torch.empty((P, nt * nt, n_acc), dtype=torch.float64,
                          device=inp.dev)
    out = torch.empty((P, n_acc), dtype=torch.float32, device=inp.dev)
    tslot, ttype, tlpos, trpos, tlen = inp.tape
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(tslot.data_ptr(), ttype.data_ptr(), tlpos.data_ptr(),
                 trpos.data_ptr(), tlen.data_ptr(), inp.pt.data_ptr(),
                 ts.data_ptr(), mask.data_ptr(), kbar.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), P, M, N, 1, stream)
        if err:
            raise RuntimeError(f"cov_tape_bwd_unfused: CUDA error {err}")
        return out
    return run


def cov_call(lib, inp, N):
    fn = lib.autogp_cov_tape
    fn.argtypes = _build.SIGNATURES["autogp_cov_tape"]
    fn.restype = ctypes.c_int
    ts, mask = inp.grid(N, N * 3 // 4)
    M = inp.nt.shape[1]
    out = torch.empty((P, N, N), dtype=torch.float32, device=inp.dev)
    tslot, ttype, _, _, tlen = inp.tape
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(tslot.data_ptr(), ttype.data_ptr(), tlen.data_ptr(),
                 inp.pt.data_ptr(), inp.noise.data_ptr(), ts.data_ptr(),
                 ts.data_ptr(), mask.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), P, M, N, N, 1, 1, stream)
        if err:
            raise RuntimeError(f"cov_tape: CUDA error {err} at launch")
        return out
    return run


def times(trees: dict, inp: Inputs, tmp: Path):
    units = {}
    for name, d in trees.items():
        for f in ("cov_tape.cu", "cov_tape_bwd.cu"):
            units[(name, f)] = ((d / f).read_text(), headers_of(d), f)
    libs = build(units, tmp)
    for (name, f), (_, lines) in libs.items():
        for ln in lines:
            print(f"ptxas [{name}] {ln}")
    names = list(trees)
    order = names + names[::-1] if len(names) > 1 else names * 2
    res = {n: {} for n in names}
    for n in order:
        cov_lib = libs[(n, "cov_tape.cu")][0]
        bwd_lib = libs[(n, "cov_tape_bwd.cu")][0]
        for N in (256, 512, 1024):
            res[n].setdefault(("kernel 1", N, N * 3 // 4), []).append(
                cuda_ms(cov_call(cov_lib, inp, N), 20))
        for N, a in FIT_SHAPES:
            res[n].setdefault(("kernel 5", N, a), []).append(
                cuda_ms(bwd_call(bwd_lib, inp, N, a), 5))
        res[n].setdefault(("kernel 5c", N_MAIN, N_ACT), []).append(
            cuda_ms(bwd_call(bwd_lib, inp, N_MAIN, N_ACT, linv=True), 5))
        for N in (32, 1024):
            res[n].setdefault(("kernel 5b", N, N * 3 // 4), []).append(
                cuda_ms(unfused_call(bwd_lib, inp, N), 20 if N == 32 else 5))
    # Outputs of the two trees on the same inputs (kernel 1 bitwise).
    if len(names) > 1:
        a, b = names[0], names[1]
        k1 = [cov_call(libs[(n, "cov_tape.cu")][0], inp, N_MAIN)().clone()
              for n in (a, b)]
        k5 = [bwd_call(libs[(n, "cov_tape_bwd.cu")][0], inp, N_MAIN,
                       N_ACT)().clone() for n in (a, b)]
        k5c = [bwd_call(libs[(n, "cov_tape_bwd.cu")][0], inp, N_MAIN,
                        N_ACT, linv=True)().clone() for n in (a, b)]
        rel = ((k5[0].double() - k5[1].double()).abs().amax(1)
               / k5[1].double().abs().amax(1))
        fin = torch.isfinite(rel)
        print(f"kernel 1 at [64, 1024, 1024]: {a} bitwise {b}: "
              f"{torch.equal(k1[0], k1[1])}; kernel 5 at [64, 1024, 1024] "
              f"({N_ACT} active), {a} vs {b}: max per-particle rel "
              f"{float(rel[fin].max()):.3e} on {int(fin.sum())} finite, "
              f"bitwise: {torch.equal(k5[0], k5[1])}; 5c bitwise kernel 5: "
              f"{a} {torch.equal(k5c[0], k5[0])}, "
              f"{b} {torch.equal(k5c[1], k5[1])}")
    for n in names:
        for key, v in res[n].items():
            print(f"[{n}] {key[0]} ms at [64, {key[1]}, {key[1]}] with "
                  f"{key[2]} active: {', '.join(f'{x:.4f}' for x in v)} "
                  f"(mean {sum(v) / len(v):.4f})")


def split(trees: dict, inp: Inputs, tmp: Path):
    units, layouts = {}, {}
    for name, d in trees.items():
        src = (d / "cov_tape_bwd.cu").read_text()
        header = (d / "cov_formulas.cuh").read_text()
        layouts[name] = layout_of(src)
        print(f"[{name}] stamp layout: {layouts[name]}")
        for plain in (False, True):
            s, h = stamped(src, header, plain)
            units[(name, plain)] = (s, {**headers_of(d),
                                        "cov_formulas.cuh": h},
                                    "cov_tape_bwd.cu")
    libs = build(units, tmp)
    ts, mask, _, _, _ = inp.bwd(N_MAIN, N_ACT)
    nt = N_MAIN // TILE
    n_lower = nt * (nt + 1) // 2
    lin_ti = [ti for ti in range(nt) for _ in range(ti + 1)]
    lin_tj = [tj for ti in range(nt) for tj in range(ti + 1)]
    m = mask.view(nt, TILE).amax(1).cpu()
    masked = torch.tensor([not (m[i] > 0 and m[j] > 0)
                           for i, j in zip(lin_ti, lin_tj)])
    print(f"all-masked lower tiles at [64, 1024, 1024] with {N_ACT} active: "
          f"{int(masked.sum())} of {n_lower} "
          f"({100 * float(masked.float().mean()):.1f}%)")
    stamps = torch.zeros(P * n_lower * 8, dtype=torch.int64, device=inp.dev)
    for name in trees:
        rows = {}
        for plain in (False, True):
            lib = libs[(name, plain)][0]
            lib.autogp_set_stamps.argtypes = [ctypes.c_void_p]
            if lib.autogp_set_stamps(ctypes.c_void_p(stamps.data_ptr())):
                raise RuntimeError("cudaMemcpyToSymbol failed")
            run = bwd_call(lib, inp, N_MAIN, N_ACT)
            ms = cuda_ms(run, 5)
            stamps.zero_()
            run()
            torch.cuda.synchronize()
            nb = int(stamps[7])           # blocks per particle (gridDim.x)
            st = stamps[:P * nb * 8].view(P, nb, 8)[..., :6].double().cpu()
            rows[plain] = (ms, st, nb)
        ms, st, nb = rows[False]
        ms_p, st_p, _ = rows[True]
        n_act_tiles = int((~masked).sum())
        if layouts[name].startswith("per-element"):
            groups = {"active tiles": ~masked, "all-masked tiles": masked}
            tiles = 1.0
        else:
            per = -(-n_act_tiles // nb)
            busy = torch.arange(nb) * per < n_act_tiles
            groups = {"busy blocks": busy}
            tiles = n_act_tiles / int(busy.sum())
        print(f"[{name}] stamped kernel {ms:.4f} ms, with the reduction a "
              f"plain add {ms_p:.4f} ms; {nb} blocks per particle, "
              f"{tiles:.2f} active tiles per busy block")
        for gname, sel in groups.items():
            mean = st[:, sel].mean((0, 1))
            mean_p = st_p[:, sel].mean((0, 1))
            parts = {ph: float(mean[k]) for k, ph in enumerate(PHASES)}
            parts["reductions"] = float(mean[3] - mean_p[3])
            parts["reverse"] = float(mean_p[3])
            total = float(mean.sum())
            block = st[:, sel].sum(2)
            print(f"[{name}] {gname}: mean cycles per block (thread 0): "
                  + ", ".join(f"{k} {v:.0f} ({100 * v / total:.1f}%)"
                              for k, v in parts.items())
                  + f"; total {total:.0f} (max {float(block.max()):.0f}, "
                  f"{total / tiles:.0f} per tile)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csrc", nargs="*", default=[str(_build.CSRC_DIR)])
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tape_bwd_split needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    trees = {}
    for i, d in enumerate(args.csrc):
        trees[f"{chr(65 + i)}:{d}"] = Path(d)
    inp = Inputs(torch.device("cuda"))
    with tempfile.TemporaryDirectory() as tmp:
        if args.split:
            split(trees, inp, Path(tmp))
        else:
            times(trees, inp, Path(tmp))
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
