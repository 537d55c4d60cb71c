"""Kernels 6 and 7 (the per-slot assembly and its backward, csrc/cov_slot.cu
and csrc/cov_slot_bwd.cu) alone, for one source tree or several, in turns.

Run on a machine with a card, from the repository root:

    python3 -m autogp_tpu_torch.scripts.slot_ab [CSRC ...]

Each CSRC is a directory of the kernels' CUDA sources and headers
(default: the package's csrc/). An older revision is unpacked with
`git archive REV autogp_tpu_torch/csrc | tar -x -C DIR`. Each tree is built
whole by ops/_build.py's compile step (one nvcc per source, side by side,
then one library in the package's git-ignored build directory), since a
kernel may call another source's entry; nvcc's -Xptxas -v lines of the
per-slot kernels are printed.

Then, at [64, N, N] for N = 32, 256 and 1024 with 3/4 of the points
active (the online run's dense-route bucket and the config-4 fit's
widths), on chip_smoke.py's 64 prior trees and a fixed random
non-symmetric cotangent, it times each tree's four entries in turns (A B B
A with two trees): kernel 6 (`autogp_cov_slot`, masked) and beside it
kernel 1's full gram (`autogp_cov_tape`, gram, not lower_only) on the same
inputs, kernel 7 (`autogp_cov_slot_bwd`) and beside it 5b
(`autogp_cov_tape_bwd_unfused`) on the same cotangent. Each time is the
whole entry (CUDA events) and its kernels alone (torch.profiler: the
device time of every kernel the entry launched). It checks, per tree,
kernel 6 bitwise its kernel 1 and kernel 7 bitwise its 5b (the contract
of the per-slot kernels redesigned on the tape bodies; an older tree may
say False), and across two trees whether kernel 6's grams are bitwise
equal and how far their kernel 7 gradients are apart. It prints the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from autogp_tpu_torch.ops import _build
from autogp_tpu_torch.scripts.tape_bwd_split import (P, TILE, Inputs,
                                                     cuda_ms, ptxas_lines)

SHAPES = ((32, 200), (256, 50), (1024, 10))   # (N, timed calls)
OWN = ("cov_slot", "heap_tape")               # ptxas lines printed


def takes_tapes(d: Path) -> bool:
    """Whether the tree's kernel 7 entry takes the tape scratch (the
    design that compacts the heap into 5b's tapes on the card)."""
    return "heap_tape_kernel" in (d / "cov_slot_bwd.cu").read_text()


def build_tree(d: Path, i: int):
    """(library of every source of the tree `d`, nvcc's output), built as
    ops/_build.py builds the package, into its build directory."""
    so = _build.BUILD_DIR / f"slot_ab_{i}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = _build._compile(sorted(d.glob("*.cu")), so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build.SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    if not takes_tapes(d):
        # node_type, order, params, ts, mask, kbar, partial, out, P, M, N,
        # masked, stream
        lib.autogp_cov_slot_bwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return lib, log


def device_ms(fn, reps) -> float:
    """Device ms per call of all the kernels fn launches (torch.profiler),
    or nan when the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    return float("nan")


class Case:
    """The inputs and buffers of the four entries at [P, N, N]."""

    def __init__(self, inp: Inputs, N: int):
        from autogp_tpu_torch.ops import cov
        dev = inp.dev
        self.inp, self.N = inp, N
        self.ts, self.mask = inp.grid(N, N * 3 // 4)
        gen = torch.Generator(device=dev).manual_seed(N)
        self.kbar = torch.randn(P, N, N, generator=gen, device=dev)
        self.nt32, self.order = cov.slot_inputs(inp.nt, inp.D)
        self.M = inp.nt.shape[1]
        nt = -(-N // TILE)
        # Room for either design's partials: at most one row per tile.
        self.partial = torch.empty((P, nt * nt, 3 * self.M + 1),
                                   dtype=torch.float64, device=dev)
        self.tapes = torch.empty(4 * P * self.M + P, dtype=torch.int32,
                                 device=dev)

    def runs(self, lib, tapes: bool):
        """name -> a call of that entry of `lib`, returning its output."""
        inp, N, M = self.inp, self.N, self.M
        dev = inp.dev
        stream = torch.cuda.current_stream().cuda_stream
        gram = torch.empty((P, N, N), device=dev)
        grads = torch.empty((P, 3 * M + 1), device=dev)
        tslot, ttype, tlpos, trpos, tlen = inp.tape
        ts, mask = self.ts.data_ptr(), self.mask.data_ptr()

        def check(name, err):
            if err:
                raise RuntimeError(f"{name}: CUDA error {err} at launch")

        def k6():
            check("cov_slot", lib.autogp_cov_slot(
                self.nt32.data_ptr(), self.order.data_ptr(),
                inp.pt.data_ptr(), inp.noise.data_ptr(), ts, mask,
                gram.data_ptr(), P, M, N, 1, stream))
            return gram

        def k1():
            check("cov_tape", lib.autogp_cov_tape(
                tslot.data_ptr(), ttype.data_ptr(), tlen.data_ptr(),
                inp.pt.data_ptr(), inp.noise.data_ptr(), ts, ts, mask, mask,
                gram.data_ptr(), P, M, N, N, 1, 0, stream))
            return gram

        def k7():
            head = [self.nt32.data_ptr(), self.order.data_ptr(),
                    inp.pt.data_ptr(), ts, mask, self.kbar.data_ptr()]
            scratch = [self.tapes.data_ptr()] if tapes else []
            check("cov_slot_bwd", lib.autogp_cov_slot_bwd(
                *head, *scratch, self.partial.data_ptr(), grads.data_ptr(),
                P, M, N, 1, stream))
            return grads

        def k5b():
            check("cov_tape_bwd_unfused", lib.autogp_cov_tape_bwd_unfused(
                tslot.data_ptr(), ttype.data_ptr(), tlpos.data_ptr(),
                trpos.data_ptr(), tlen.data_ptr(), inp.pt.data_ptr(), ts,
                mask, self.kbar.data_ptr(), self.partial.data_ptr(),
                grads.data_ptr(), P, M, N, 1, stream))
            return grads

        return {"kernel 6": k6, "kernel 1 (full gram)": k1,
                "kernel 7": k7, "kernel 5b": k5b}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csrc", nargs="*", default=[str(_build.CSRC_DIR)])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("slot_ab needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    trees = {f"{chr(65 + i)}:{d}": Path(d) for i, d in enumerate(args.csrc)}
    names = list(trees)
    order = names + names[::-1] if len(names) > 1 else names * 2
    inp = Inputs(torch.device("cuda"))
    libs = {}
    for i, (n, d) in enumerate(trees.items()):
        lib, log = build_tree(d, i)
        libs[n] = (lib, takes_tapes(d))
        for ln in ptxas_lines(log):
            if any(k in ln.split(":", 1)[0] for k in OWN):
                print(f"ptxas [{n}] {ln}")
    for N, reps in SHAPES:
        case = Case(inp, N)
        res = {n: {} for n in names}
        for n in order:
            for key, fn in case.runs(*libs[n]).items():
                res[n].setdefault(key, []).append(
                    (cuda_ms(fn, reps), device_ms(fn, max(3, reps // 4))))
        outs = {}
        for n in names:
            run = case.runs(*libs[n])
            outs[n] = {k: f().clone() for k, f in run.items()}
            o = outs[n]
            print(f"[{n}] N={N}: kernel 6 bitwise kernel 1's gram: "
                  f"{torch.equal(o['kernel 6'], o['kernel 1 (full gram)'])}"
                  f"; kernel 7 bitwise 5b: "
                  f"{torch.equal(o['kernel 7'], o['kernel 5b'])}")
            for key, v in res[n].items():
                whole = ", ".join(f"{a:.4f}" for a, _ in v)
                alone = ", ".join(f"{b:.4f}" for _, b in v)
                print(f"[{n}] {key} ms at [64, {N}, {N}] with "
                      f"{N * 3 // 4} active: entry {whole} (mean "
                      f"{sum(a for a, _ in v) / len(v):.4f}); kernels "
                      f"alone {alone} (mean "
                      f"{sum(b for _, b in v) / len(v):.4f})")
        if len(names) > 1:
            a, b = (outs[n] for n in names[:2])
            g = a["kernel 7"].double(), b["kernel 7"].double()
            rel = ((g[0] - g[1]).abs().amax(1)
                   / g[1].abs().amax(1).clamp_min(1e-300))
            fin = torch.isfinite(rel)
            print(f"N={N}: kernel 6 {names[0]} bitwise {names[1]}: "
                  f"{torch.equal(a['kernel 6'], b['kernel 6'])}; kernel "
                  f"7 {names[0]} vs {names[1]}: max per-particle rel "
                  f"{float(rel[fin].max()):.3e} on {int(fin.sum())} "
                  f"finite")
        del case, outs


if __name__ == "__main__":
    main()
