"""The blocked Cholesky driver's float32 error and time, for one or more
versions of ops/chol.py, beside torch's dense float32 Cholesky.

For each source (default: the package's own ops/chol.py; pass the path of
another, an older tree's, to compare), on the card:

  - the LML of BASELINE config 2's joint gram (bench 2 of
    scripts/experiment_hmc.py: Linear + Periodic, 1000 points on [0, 10],
    condition ~6e5, numpy seeds 0-4) from a float32 gram assembled by
    kernel 1, against float64 on the same float32 gram (on the CPU);
    `cholesky_ex` (torch's dense float32 factorization) beside it;
  - chol_solve_diag's milliseconds at [64, N, N] for N = 256, 512, 1024
    (CUDA events, the sources in turns A B B A).

Usage:
    python3 -m autogp_tpu_torch.scripts.chol_ab [CHOL_PY ...]
"""

import importlib.util
import math
import subprocess
import sys

import numpy as np
import torch

from autogp_tpu_torch import GPConfig
from autogp_tpu_torch import model as M
from autogp_tpu_torch import tree as T
from autogp_tpu_torch.inference import smc
from autogp_tpu_torch.ops import chol, cov
from autogp_tpu_torch.scripts import experiment_hmc as X

LOG2PI = math.log(2 * math.pi)


def load(path):
    """ops/chol.py from `path` as a module of its own (it uses this
    package's kernels and backend)."""
    spec = importlib.util.spec_from_file_location(f"chol_ab_{abs(hash(path))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def joint_gram(seed, dev):
    """Kernel 1's float32 gram of config 2's 1000 points (observed first,
    as experiment_hmc orders the joint) and its data, on the 1024 bucket."""
    cfg = GPConfig(changepoints=True, max_depth=4)
    node, noise = X.BENCHMARKS[2]
    nz = float(M.untransform_param("noise", noise, cfg))
    ts_o, xs_o, ts_t, xs_t = X.simulate(2, 1000, 200,
                                        np.random.default_rng(seed), cfg)
    tab = M.prior_tables(cfg, dev, torch.float32)
    data = smc.make_dataset(np.concatenate([ts_o, ts_t]),
                            np.concatenate([xs_o, xs_t]),
                            dtype=torch.float32, device=dev)
    nt_np, pz = T.node_to_tensor(node, cfg)
    nt = torch.as_tensor(nt_np, device=dev)[None]
    pt = M.transform_params(nt, torch.as_tensor(
        pz, dtype=torch.float32, device=dev)[None], tab)
    noise_t = M.transform_noise(torch.full((1,), nz, device=dev), cfg)
    K = cov.cov_tape(nt, pt, noise_t, data.ts, data.ts, data.mask, data.mask,
                     cfg.depth_cap, gram=True, lower_only=True)
    return torch.tril(K) + torch.tril(K, -1).mT, (data.xs * data.mask)[None]


def lml(d, alpha):
    return float(-0.5 * (d.shape[-1] * LOG2PI
                         + 2 * torch.log(d.double()).sum()
                         + (alpha.double() ** 2).sum()))


def dense_lml(K, x):
    L, _ = torch.linalg.cholesky_ex(K)
    a = torch.linalg.solve_triangular(L, x[..., None], upper=False)[..., 0]
    return lml(torch.diagonal(L, dim1=-2, dim2=-1), a)


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def main(argv=None):
    paths = (sys.argv[1:] if argv is None else argv) or [chol.__file__]
    mods = [load(p) for p in paths]
    dev = "cuda"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for seed in range(5):
        K, x = joint_gram(seed, dev)
        ref = lml(*chol.chol_solve_diag(K.double().cpu(), x.double().cpu()))
        errs = [lml(*m.chol_solve_diag(K, x)) - ref for m in mods]
        print(f"seed {seed}: float64 LML {ref:.4f}; float32 error by source "
              + ", ".join(f"{e:+.4f}" for e in errs)
              + f"; cholesky_ex {dense_lml(K[0], x[0]) - ref:+.4f}",
              flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for N in (256, 512, 1024):
        Xr = torch.randn(64, N, N, generator=gen, device=dev)
        S = torch.tril(Xr @ Xr.mT / N + torch.eye(N, device=dev))
        xv = torch.randn(64, N, generator=gen, device=dev)
        order = list(range(len(mods))) + list(reversed(range(len(mods))))
        ms = [[] for _ in mods]
        for i in order:
            ms[i].append(cuda_ms(lambda: mods[i].chol_solve_diag(S, xv)))
        print(f"N={N}: chol_solve_diag [64, N, N] ms by source "
              + ", ".join(f"{np.mean(t):.4f}" for t in ms), flush=True)


if __name__ == "__main__":
    main()
