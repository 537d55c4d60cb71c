"""A/B the two backward backends of the fused LML gradient (counterpart of
scripts/bench_grad_ab.py).

`cov_vjp.INTAPE_LINV = False`: K^-1 lower-only by the kinv kernel, then
the tape backward reads its tiles. `True`: L^-1 by the kinv kernel, then
the tape backward forms each K^-1 tile from two column strips of L^-1.
Both share one forward, so the values must agree exactly.

The batch is the reference's: 64 particles drawn by `smc.initialize` on a
1024-point series sin(2 pi 7 t) + 0.1 noise, t in [0, 1] (numpy seed 0),
and one timed call is `model.lml` with its gradient in (params_z,
noise_z). Times are CUDA events over `reps` calls, the two backends in
turns (A, B, B, A); on the CPU they are not measured.

Usage (on the card):
    python3 -m autogp_tpu_torch.scripts.bench_grad_ab
"""

from __future__ import annotations

import math

import numpy as np
import torch

from autogp_tpu_torch import backend
from autogp_tpu_torch import config as C
from autogp_tpu_torch import model as M
from autogp_tpu_torch.inference import smc
from autogp_tpu_torch.ops import cov_vjp


def grad_batch(N: int = 1024, P: int = 64, device="cuda", seed: int = 0):
    """A function that returns (LML [P], params_z gradient [P, M, 3],
    noise_z gradient [P]) of a fixed batch of prior particles."""
    dev = backend.resolve_device(device)
    dtype = torch.float32 if dev.type == "cuda" else torch.float64
    cfg = C.GPConfig(max_depth=5)
    tables = M.prior_tables(cfg, dev, dtype)
    rng = np.random.default_rng(seed)
    ts = np.linspace(0.0, 1.0, N)
    xs = np.sin(2 * np.pi * 7 * ts) + 0.1 * rng.standard_normal(N)
    data = smc.make_dataset(ts, xs, pad_to=N, dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    parts = smc.initialize(gen, P, data, cfg, tables)

    def run():
        pz = parts.params.clone().requires_grad_(True)
        nz = parts.noise_z.clone().requires_grad_(True)
        v = M.lml(parts.node_type, pz, nz, data.ts, data.xs, data.mask, cfg,
                  tables)
        gp, gn = torch.autograd.grad(v.sum(), (pz, nz))
        return v.detach(), gp, gn

    return run


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(N: int = 1024, P: int = 64, reps: int = 10, device="cuda",
        seed: int = 0) -> dict:
    """Both backends on one batch: their milliseconds per gradient batch
    (None on the CPU), the values' max |diff| and the gradients' max
    |diff| relative to the largest entry of the default backend's, over
    the particles whose gradients are finite under both."""
    fn = grad_batch(N, P, device, seed)
    on_card = backend.resolve_device(device).type == "cuda"
    old = cov_vjp.INTAPE_LINV
    times = {False: [], True: []}
    outs = {}
    try:
        for mode in (False, True, True, False):
            cov_vjp.INTAPE_LINV = mode
            if on_card:
                times[mode].append(_ms(fn, reps))
            outs[mode] = fn()
    finally:
        cov_vjp.INTAPE_LINV = old
    (va, gpa, gna), (vb, gpb, gnb) = outs[False], outs[True]
    fin = (torch.isfinite(gpa.flatten(1)).all(1) & torch.isfinite(gna)
           & torch.isfinite(gpb.flatten(1)).all(1) & torch.isfinite(gnb))

    def rel(a, b):
        a, b = a[fin].double(), b[fin].double()
        return float((a - b).abs().max() / a.abs().max())

    fin_v = torch.isfinite(va)
    value_diff = (float((va - vb)[fin_v].abs().max())
                  if torch.equal(fin_v, torch.isfinite(vb)) else math.inf)
    return {
        "ms": {mode: (sum(t) / len(t) if t else None)
               for mode, t in times.items()},
        "value_max_abs_diff": value_diff,
        "param_grad_rel": rel(gpa, gpb),
        "noise_grad_rel": rel(gna, gnb),
        "n_finite": int(fin.sum()),
    }


def main():
    r = run()
    for mode, name in ((False, "kinv kernel"), (True, "L^-1 in tape")):
        print(f"grad-LML [{name}]: {r['ms'][mode]:.4f} ms per batch of 64 "
              f"at N=1024")
    print(f"value max|diff|: {r['value_max_abs_diff']:.3e} (must be 0: one "
          f"forward)")
    print(f"param-grad max rel diff: {r['param_grad_rel']:.3e}; noise-grad: "
          f"{r['noise_grad_rel']:.3e} ({r['n_finite']} particles)")
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
