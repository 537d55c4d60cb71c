"""Which ops of config 4's path give a particle bits that depend on the
batch it runs in, on the card.

A sharded fit (parallel/mesh.py) equals the unsharded one bit for bit
only if every op computes a particle's values the same way whatever the
batch: HMC's compacted sweeps and a mesh's shards run batches of 1 to P
particles. Each op runs on 64 prior particles at N points (3/4 active)
and on row ranges of them; each line prints, per output of the op,
`rows:output:mismatched particles/rows` and the largest relative
difference among the mismatched particles.

    python3 -m autogp_tpu_torch.scripts.batch_bits [N ...] [--plain-sum]

`--plain-sum` replaces gp_math.row_sum by torch.sum, the per-particle
sums as they were before row_sum padded small batches.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import gp_math
from autogp_tpu_torch import model as M
from autogp_tpu_torch.inference import hmc
from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv

ROWS = ((0, 32), (32, 64), (5, 22), (40, 47), (0, 1), (9, 10), (3, 5),
        (10, 13), (20, 35))


def _bits(t):
    t = t.detach().contiguous()
    if not t.is_floating_point():
        return t
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def compare(full, sub, rows):
    """Per output: (mismatched particles, largest relative difference)."""
    out = []
    k = len(rows)
    for a, b in zip(full, sub):
        a = a[rows].reshape(k, -1)
        b = b.reshape(k, -1)
        neq = (_bits(a) != _bits(b)).any(1)
        rel = ((a.double() - b.double()).abs().amax(1)
               / a.double().abs().amax(1).clamp_min(1e-300))[neq]
        out.append((int(neq.sum()), float(rel.max()) if len(rel) else 0.0))
    return out


def ops(nt, pz, nz, ts, xs, mask, cfg, tab):
    """Every op's outputs on one batch, by name."""
    P, N = nt.shape[0], ts.shape[0]
    pt = M.transform_params(nt, pz, tab)
    noise = M.transform_noise(nz, cfg)
    K = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, cfg.depth_cap,
                     gram=True, lower_only=True)
    xm = (xs * mask).expand(P, N)
    d, alpha, wd, L = chol.chol_solve_strips(K, xm)
    beta_s, fro = kinv.linv_stats_wd(L, alpha, wd)
    Ki, beta_k, _ = kinv.kinv_beta_strips(alpha, wd, L)
    pbar, nbar = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, Ki, beta_k,
                                      torch.ones_like(nz), cfg.depth_cap)
    with torch.enable_grad():
        q = pz.clone().requires_grad_(True)
        v = M.lml(nt, q, nz, ts, xs, mask, cfg, tab)
        (g,) = torch.autograd.grad(v.sum(), q)
    K0 = M.assemble_K0(nt, pz, ts, mask, cfg, tab)
    nv, ng = M.lml_value_and_noise_grad_from_K0(K0, nz, xs, mask, cfg)
    pmask = (torch.arange(3, device=nt.device)
             < tab.arity[nt][..., None]).to(pz.dtype)
    return {"kernel 1 K": (K,), "driver d, alpha, Wd, L": (d, alpha, wd, L),
            "linv_stats_wd beta, fro": (beta_s, fro),
            "kinv_beta_strips K^-1, beta": (Ki, beta_k),
            "kernel 5 pbar, nbar": (pbar, nbar),
            "lml value": (M.lml(nt, pz, nz, ts, xs, mask, cfg, tab),),
            "lml under grad: value, z gradient": (v, g),
            "K0": (K0,), "noise value, gradient": (nv, ng),
            "HMC prior sum": (hmc._lp_params(pz, pmask),),
            "tree prior": (M.tree_prior_logpdf(nt, pz, tab),)}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--plain-sum" in argv:
        gp_math.row_sum = lambda x, dim=-1: torch.sum(x, dim=dim)
    sizes = [int(a) for a in argv if not a.startswith("--")] or [1024, 256]
    if not torch.cuda.is_available():
        raise SystemExit("batch_bits needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), "| per-particle sums:",
          "torch.sum" if "--plain-sum" in argv else "gp_math.row_sum")
    dev, f32 = torch.device("cuda"), torch.float32
    cfg = C.GPConfig(max_depth=5)
    tab = M.prior_tables(cfg, dev, f32)
    gen = torch.Generator(device=dev).manual_seed(5)
    nt, pz = M.sample_tree(gen, 64, tab, f32, dev)
    nz = torch.randn((64,), generator=gen, device=dev)
    for N in sizes:
        ts = torch.linspace(0, 1, N, device=dev)
        mask = (torch.arange(N, device=dev) < 3 * N // 4).to(f32)
        xs = torch.sin(20 * ts) * mask
        full = ops(nt, pz, nz, ts, xs, mask, cfg, tab)
        subs = []
        for a, b in ROWS:
            rows = torch.arange(a, b, device=dev)
            subs.append((rows, ops(nt[rows], pz[rows], nz[rows], ts, xs,
                                   mask, cfg, tab)))
        torch.cuda.synchronize()
        for name in full:
            cells = []
            for rows, sub in subs:
                for j, (n_bad, rel) in enumerate(compare(full[name],
                                                         sub[name], rows)):
                    cells.append(f"{len(rows)}:{j}:{n_bad}/{len(rows)}"
                                 + (f" ({rel:.1e})" if n_bad else ""))
            print(f"N={N} {name}: " + " ".join(cells), flush=True)


if __name__ == "__main__":
    main()
