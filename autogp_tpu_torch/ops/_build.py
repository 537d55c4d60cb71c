"""Build and load the hand-written CUDA kernels (autogp_tpu_torch/csrc).

Every `csrc/*.cu` file is compiled by an `nvcc` of its own, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ctypes. The build happens at first use, never at
import, into `autogp_tpu_torch/_build/` (ignored by git), and the file name
carries a hash of the sources, the headers (`csrc/*.cuh`) and the flags, so
an edited kernel is rebuilt and an unchanged one is reused.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises if that is not 0 (a refused launch
never runs, and a later synchronize would not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# C signatures: every pointer and the stream as c_void_p.
SIGNATURES = {
    # tape slot, tape type, tape length, params, noise, t_row, t_col,
    # mask_row, mask_col, out, P, M, N1, N2, gram, lower_only, max_len,
    # max_height, stream
    "autogp_cov_tape": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # the same in float64 (cov_tape_f64.cu), without max_height
    "autogp_cov_tape_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _P],
    # A, batch stride, row stride, L out, Linv out, P, B, stream
    "autogp_chol_panel": [_P, _LL, _LL, _P, _P, _I, _I, _P],
    # L, wd, alpha, X scratch, beta, fro_part scratch, fro, kinv (or
    # NULL), P, N, stream
    "autogp_kinv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # L, wd, alpha, V out, beta, fro_part scratch, fro, P, N, stream
    "autogp_linv_beta": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # tape slot, type, lpos, rpos, length, params, ts, mask, kinv, beta,
    # g, partial scratch, out, P, M, N, max_len, part_batch, stream
    "autogp_cov_tape_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P, _I, _I, _I, _I, _I, _P],
    # the same, with V = L^-1 in place of K^-1
    "autogp_cov_tape_bwd_linv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # tape slot, type, lpos, rpos, length, params, ts, mask, kbar, partial
    # scratch, out, P, M, N, masked, max_len, part_batch, stream
    "autogp_cov_tape_bwd_unfused": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _I, _I, _I, _I, _I, _I, _P],
    # node_type, post-order, params, noise, ts, mask, out, P, M, N, masked,
    # max_len, max_height, stream
    "autogp_cov_slot": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P],
    # node_type, post-order, params, ts, mask, kbar, tapes scratch, partial
    # scratch, out, P, M, N, masked, max_len, part_batch, stream
    "autogp_cov_slot_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _I, _P],
}

# The batch's tape maxima each entry takes (max_len, and max_height where
# the stack is picked by it), just before part_batch where there is one,
# else just before the stream. Older trees, which the A/B scripts may
# build, size every kernel by the heap and take none.
MAXIMA_ARGS = {"autogp_cov_tape": 2, "autogp_cov_tape_f64": 1,
               "autogp_cov_slot": 2, "autogp_cov_tape_bwd": 1,
               "autogp_cov_tape_bwd_linv": 1,
               "autogp_cov_tape_bwd_unfused": 1, "autogp_cov_slot_bwd": 1}

# The entries of kernels 5 and 7 that take the partition's batch
# (`part_batch`) just before the stream.
PART_BATCH_ENTRIES = ("autogp_cov_tape_bwd", "autogp_cov_tape_bwd_linv",
                      "autogp_cov_tape_bwd_unfused", "autogp_cov_slot_bwd")


def takes_part_batch(src: str) -> bool:
    """Whether the kernel-5 or kernel-7 source text `src` has entries that
    take `part_batch` (older trees, which the A/B scripts may build, do
    not)."""
    return "int part_batch" in src


def takes_tape_maxima(src: str) -> bool:
    """Whether a kernel source text `src` has entries that take the
    batch's tape maxima (MAXIMA_ARGS)."""
    return "int max_len" in src


def entry_argtypes(name: str, part_batch: bool = True,
                   maxima: bool = True) -> list:
    """SIGNATURES[name], without the part_batch argument or the tape
    maxima for a source whose entries do not take them."""
    sig = list(SIGNATURES[name])
    end = len(sig) - 1                       # the stream
    if name in PART_BATCH_ENTRIES:
        end -= 1
        if not part_batch:
            del sig[end]
    if not maxima:
        del sig[end - MAXIMA_ARGS.get(name, 0):end]
    return sig

_lib = None
build_log = ""   # nvcc's output (-Xptxas -v: registers, spills)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands side by side; their output, or RuntimeError with
    the output of those that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{o}"
              for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def _compile(srcs, so: Path) -> str:
    """One nvcc per source, all at once, then the link; nvcc's output."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s.stem + ".o") for s in srcs]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)]
                        for s, o in zip(srcs, objs)])
        lib = os.path.join(tmp, so.name)
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, so)   # atomic: a concurrent loader sees all or none
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    srcs = _sources()
    so = BUILD_DIR / f"libautogp_kernels_{_digest(srcs)}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        build_log = _compile(srcs, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.autogp_error_string.argtypes = [_I]
    lib.autogp_error_string.restype = ctypes.c_char_p
    _lib = lib
    return _lib


def check(name: str, err: int):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = library().autogp_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
