"""kinv_lower_kernel (K^-1 = X^T X from X = L^-1, csrc/kinv.cu) alone at the
fit's shapes, for one source tree or several.

Run on a machine with a card, from the repository root:

    python3 -m autogp_tpu_torch.scripts.kinv_ab [CSRC ...]

Each CSRC is a directory holding kinv.cu and the headers it includes
(default: the package's csrc/). An older revision is unpacked with
`git archive REV autogp_tpu_torch/csrc | tar -x -C DIR`; tuning variants
are copies with a constant changed.

It builds each tree's kinv.cu as it is (one nvcc per tree, side by side)
and prints nvcc's -Xptxas -v lines for its kernels (registers, spills).
Then, for N = 256, 512, 1024 at P = 64 (the config-4 fit's buckets), on
the factor of well-conditioned SPD grams (chip_smoke.py phase 5's form),
it times each tree's `autogp_kinv` with the K^-1 output in turns (A B B A
with two trees): kinv_lower_kernel alone (torch.profiler device time per
launch) and the whole entry (CUDA events), beside the product's bound
(N^3 / 3 flops per particle in 3xTF32 on the tensor cores; the lower X
read once and K^-1 written once), the plain version's K^-1 half
(`gp_math.kinv_from_linv`, FP32, TF32 off) and one FP32 `torch.bmm(X^T,
X)` with TF32 off (the full square: twice the lower blocks' work) as a
yardstick.
It checks each tree's lower K^-1 against the float64 plain version on the
same factor (normwise), its strictly-upper blocks against 0, and two runs
of it bitwise, and prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from autogp_tpu_torch import gp_math
from autogp_tpu_torch.ops import _build
from autogp_tpu_torch.scripts.tape_bwd_split import (build, cuda_ms,
                                                     headers_of)

P = 64
SHAPES = (256, 512, 1024)
PEAK_TF32, PEAK_BYTES = 495e12, 3.35e12   # H100 SXM data sheet


def kernel_ms(fn, name, reps=5):
    """Device ms per call spent in kernels whose name holds `name`
    (torch.profiler), or nan when the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if name in e.key]
        if evs:
            return sum(e.self_device_time_total for e in evs) / reps / 1e3
    return float("nan")


class Case:
    """A factor at [P, N, N] in the strips form, and the buffers of one
    autogp_kinv call with the K^-1 output."""

    def __init__(self, N, dev):
        from autogp_tpu_torch.ops import chol
        gen = torch.Generator(device=dev).manual_seed(N)
        A = torch.randn(P, N, N, generator=gen, device=dev,
                        dtype=torch.float64)
        K = A @ A.mT / N + torch.eye(N, device=dev, dtype=torch.float64)
        x = torch.randn(P, N, generator=gen, device=dev, dtype=torch.float64)
        del A
        _, self.a, self.wd, self.L = chol.chol_solve_strips(
            torch.tril(K).float(), x.float())
        self.N = N
        B = min(N, chol.BLOCK)
        self.X = torch.empty_like(self.L)
        self.fro_part = torch.empty((P, N // B), dtype=torch.float64,
                                    device=dev)
        self.beta = torch.empty((P, N), device=dev)
        self.fro = torch.empty((P,), device=dev)
        self.kinv = torch.empty_like(self.L)
        blk = torch.arange(N, device=dev) // B
        self.upper = blk[None, :] > blk[:, None]

    def call(self, lib):
        fn = lib.autogp_kinv
        fn.argtypes = _build.SIGNATURES["autogp_kinv"]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            err = fn(self.L.data_ptr(), self.wd.data_ptr(), self.a.data_ptr(),
                     self.X.data_ptr(), self.beta.data_ptr(),
                     self.fro_part.data_ptr(), self.fro.data_ptr(),
                     self.kinv.data_ptr(), P, self.N, stream)
            if err:
                raise RuntimeError(f"autogp_kinv: CUDA error {err} at launch")
            return self.kinv
        return run


def bound_ms(N):
    """(ms, what bounds it) of the K^-1 product at [P, N, N]."""
    ops = P * N ** 3 / PEAK_TF32             # 3 x N^3 / 3 TF32 flops
    nbytes = 4 * P * (N * (N + 1) // 2 + N * N) / PEAK_BYTES
    return (max(ops, nbytes) * 1e3,
            "operations" if ops >= nbytes else "bytes")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csrc", nargs="*", default=[str(_build.CSRC_DIR)])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kinv_ab needs a CUDA card")
    from autogp_tpu_torch.ops import kinv
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    trees = {f"{chr(65 + i)}:{d}": Path(d) for i, d in enumerate(args.csrc)}
    names = list(trees)
    order = names + names[::-1] if len(names) > 1 else names * 2
    with tempfile.TemporaryDirectory() as tmp:
        libs = build({n: ((d / "kinv.cu").read_text(), headers_of(d),
                          "kinv.cu") for n, d in trees.items()}, Path(tmp))
        for n, (_, lines) in libs.items():
            for ln in lines:
                print(f"ptxas [{n}] {ln}")
        for N in SHAPES:
            case = Case(N, dev)
            ref = kinv.kinv_beta_plain(case.L.double(), case.a.double())[0]
            ref = torch.tril(ref)
            res = {n: [] for n in names}
            for n in order:
                run = case.call(libs[n][0])
                res[n].append((kernel_ms(run, "kinv_lower_kernel"),
                               cuda_ms(run, 10)))
            for n in names:
                run = case.call(libs[n][0])
                k1 = run().clone()
                k2 = run().clone()
                err = float(((torch.tril(k1).double() - ref).abs()
                             .flatten(1).amax(1)
                             / ref.abs().flatten(1).amax(1)).max())
                zero = not bool(k1[:, case.upper].any())
                alone = ", ".join(f"{a:.4f}" for a, _ in res[n])
                whole = ", ".join(f"{w:.4f}" for _, w in res[n])
                print(f"[{n}] N={N}: kinv_lower_kernel alone ms {alone} "
                      f"(mean {sum(a for a, _ in res[n]) / len(res[n]):.4f})"
                      f"; autogp_kinv ms {whole}; lower K^-1 vs f64 normwise "
                      f"{err:.3e}; strictly-upper blocks 0: {zero}; two "
                      f"runs bitwise: {torch.equal(k1, k2)}")
            X = kinv.linv_beta(case.L, case.a, case.wd)[0]
            was = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                lib_ms = cuda_ms(lambda: torch.bmm(X.mT, X), 5)
                plain_ms = cuda_ms(lambda: gp_math.kinv_from_linv(X), 5)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = was
            b = bound_ms(N)
            print(f"N={N}: bound {b[0]:.4f} ms ({b[1]}); plain K^-1 half "
                  f"(gp_math.kinv_from_linv) {plain_ms:.4f} ms; "
                  f"torch.bmm(X^T, X) FP32, TF32 off, full square "
                  f"{lib_ms:.4f} ms")
            del case, ref, X
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
