"""Where kernel 2's time goes: per-phase clocks and the factor/inverse split
of a panel-kernel source (csrc/chol_panel.cu or an older revision of it).

Run on a machine with a card, from the repository root:

    python3 -m autogp_tpu_torch.scripts.panel_split [SOURCE] [--split]

Without --split it builds a copy of SOURCE (default: the package's
csrc/chol_panel.cu) with a clock64() stamp after every block barrier of
chol_panel_kernel and prints, for block 0 at [64, 128, 128], the cycles
between consecutive barriers (load, then each phase, then the end).

--split takes a source with the column-recurrence layout that kernel 2 had
before its blocked recurrence (get it with `git show
3905dde:autogp_tpu_torch/csrc/chol_panel.cu`): it builds the source as it
is, with the inverse cut out, and with both the factor and the inverse cut
out, and prints their times, so factor = (factor only) - (load/store only)
and inverse = (all) - (factor only).

Every build is a copy in a temporary directory; nothing in the package
changes. Times are CUDA events over 200 launches, in two turns (forward,
then reversed), beside torch.linalg.cholesky_ex on the same input, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from autogp_tpu_torch.ops import _build

P, B, REPS = 64, 128, 200
_ENTRY = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
          ctypes.c_void_p]


def _replace(src: str, old: str, new: str, count: int = 1) -> str:
    if old not in src:
        raise ValueError(f"marker not found in the source: {old!r}")
    return src.replace(old, new, count)


def stamped(src: str) -> str:
    """The source with a clock64() stamp into ts[] after every barrier of
    chol_panel_kernel (block 0, thread 0) and ts as a last argument."""
    src = _replace(src, "float* __restrict__ Wout, int B) {",
                   "float* __restrict__ Wout, int B, long long* ts) {\n"
                   "  int nts = 0;\n#define STAMP() do { if (blockIdx.x == 0 "
                   "&& threadIdx.x == 0) ts[nts] = clock64(); ++nts; } "
                   "while (0)\n  STAMP();")
    head, body = src.split("chol_panel_kernel(const float* __restrict__ A",
                           1)
    kernel, rest = body.split("}  // namespace", 1)
    kernel = kernel.replace("__syncthreads();", "__syncthreads(); STAMP();")
    end = kernel.rindex("}\n")
    kernel = kernel[:end] + "  __syncthreads(); STAMP();\n" + kernel[end:]
    rest = _replace(rest, "(float*)L, (float*)W, B);",
                    "(float*)L, (float*)W, B, (long long*)ts);")
    rest = _replace(rest, "int P, int B, void* stream) {",
                    "int P, int B, void* stream, void* ts) {")
    return (head + "chol_panel_kernel(const float* __restrict__ A" + kernel
            + "}  // namespace" + rest)


def split_variants(src: str) -> dict:
    """The column-recurrence source as it is, without its inverse, and
    without factor and inverse (load and store only)."""
    fac = "  // Right-looking column recurrence.\n"
    inv = "  // W = L^-1 by rows:"
    out = "  float* Lp = Lout"
    factor_only = _replace(_replace(src, inv, "#if 0\n" + inv), out,
                           "#endif\n" + out)
    io_only = _replace(_replace(src, fac, "#if 0\n" + fac), out,
                       "#endif\n" + out)
    return {"all": src, "factor only": factor_only, "load/store only": io_only}


def build(sources: dict, tmp: Path) -> dict:
    """One nvcc per source, side by side: name -> the loaded entry point."""
    cmds, libs = [], {}
    for i, (name, text) in enumerate(sources.items()):
        cu = tmp / f"v{i}.cu"
        cu.write_text(text)
        libs[name] = tmp / f"v{i}.so"
        cmds.append([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                     "-Xcompiler", "-fPIC", "-shared", "-I",
                     str(_build.CSRC_DIR), "-o", str(libs[name]), str(cu)])
    _build._run_all(cmds)
    return {name: ctypes.CDLL(str(so)).autogp_chol_panel
            for name, so in libs.items()}


def cuda_ms(fn, reps=REPS) -> float:
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", nargs="?",
                    default=str(_build.CSRC_DIR / "chol_panel.cu"))
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("panel_split needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    src = Path(args.source).read_text()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn(P, B, B, generator=gen, device=dev, dtype=torch.float64)
    A = torch.tril(X @ X.mT / B + torch.eye(B, device=dev,
                                            dtype=torch.float64)).float()
    L, W = torch.empty_like(A), torch.empty_like(A)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        if args.split:
            fns = build(split_variants(src), Path(tmp))
            for fn in fns.values():
                fn.argtypes, fn.restype = _ENTRY, ctypes.c_int
            times = {name: [] for name in fns}
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    times[name].append(cuda_ms(lambda: fns[name](
                        A.data_ptr(), A.stride(0), A.stride(1), L.data_ptr(),
                        W.data_ptr(), P, B, stream)))
            lib = [cuda_ms(lambda: torch.linalg.cholesky_ex(A))
                   for _ in range(2)]
            mean = {k: sum(v) / len(v) for k, v in times.items()}
            print(f"ms per [{P},{B},{B}] panel, two turns: {times}; "
                  f"cholesky_ex {lib}")
            print(f"split: load/store {mean['load/store only']:.4f} ms, "
                  f"factor {mean['factor only'] - mean['load/store only']:.4f}"
                  f" ms, inverse {mean['all'] - mean['factor only']:.4f} ms,"
                  f" total {mean['all']:.4f} ms")
        else:
            fn = build({"stamped": stamped(src)}, Path(tmp))["stamped"]
            fn.argtypes, fn.restype = _ENTRY + [ctypes.c_void_p], ctypes.c_int
            ts = torch.zeros(1024, dtype=torch.int64, device=dev)
            ms = cuda_ms(lambda: fn(A.data_ptr(), A.stride(0), A.stride(1),
                                    L.data_ptr(), W.data_ptr(), P, B, stream,
                                    ts.data_ptr()))
            t = [x for x in ts.tolist() if x]
            cycles = [b - a for a, b in zip(t, t[1:])]
            print(f"stamped kernel {ms:.4f} ms per [{P},{B},{B}] panel; "
                  f"block 0 cycles between barriers (load, phases..., "
                  f"end): {cycles}; total {t[-1] - t[0]}")


if __name__ == "__main__":
    main()
