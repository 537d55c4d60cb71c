"""The depth-annealing posterior oracle (port of tests/test_inference.py:
347-398, with an exact reference added).

On a 12-point series with the noise fixed at 0.1, depth-annealed SMC
([1, 2]) and data-annealed SMC ([4, 8, 12]) both target p(structure |
data) at max_depth = 2 under one prior (ChangePoints off in both: the JAX
test's data-annealed config leaves them on). That posterior is also
computed directly: the 21 depth-2 structures' marginal likelihoods by
importance sampling from the parameter prior. `--reference-weight` runs the
depth-annealed arm with the JAX package's extension weight (without
`smc_depth.detach_support_logprob`) to show its bias.

Usage:
    python3 -m autogp_tpu_torch.scripts.depth_oracle [--device cpu]
        [--particles 4096] [--seeds 5 6] [--reference-weight]
"""

import argparse

import numpy as np
import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import model as M
from autogp_tpu_torch.inference import hmc, smc, smc_depth

NOISE = 0.1
HMC = hmc.HMCConfig(L_param=3, L_noise=3, n_exit=1)


def series():
    """The oracle's 12 points (tests/test_inference.py:363-366)."""
    rng = np.random.default_rng(3)
    ts = np.linspace(0.0, 1.0, 12)
    return ts, 0.6 * np.sin(2 * np.pi * 2 * ts) + 0.3 * rng.standard_normal(12)


def config():
    return C.GPConfig(max_depth=2, noise=NOISE, changepoints=False)


def structure_key(node_type):
    """root * 100 + left * 10 + right of each [P, 3] heap."""
    nt = node_type.cpu().numpy()
    return nt[:, 0] * 100 + nt[:, 1] * 10 + nt[:, 2]


def weighted_freqs(parts):
    """({structure: weight}, ESS) of an ensemble of depth-2 particles."""
    keys = structure_key(parts.node_type)
    w = smc.normalized_weights(parts.log_weights).double().cpu().numpy()
    return ({int(k): float(w[keys == k].sum()) for k in np.unique(keys)},
            float(smc.effective_sample_size(parts.log_weights)))


def total_variation(a, b):
    return 0.5 * sum(abs(a.get(k, 0.0) - b.get(k, 0.0))
                     for k in set(a) | set(b))


def exact_posterior(device, dtype, n_draws=200000, batch=20000, seed=0):
    """{structure: p(structure | data)} at max_depth 2: the prior
    probability of each structure times its marginal likelihood, the mean
    of exp(LML) over `n_draws` parameter vectors from the prior."""
    cfg = config()
    tables = M.prior_tables(cfg, device, dtype)
    ts, xs = series()
    data = smc.make_dataset(ts, xs, dtype=dtype, device=device)
    nz = torch.full((batch,), float(M.untransform_param("noise", NOISE, cfg)),
                    dtype=dtype, device=device)
    d_nocp, d_leaf = np.asarray(cfg.node_dist_nocp), np.asarray(
        cfg.node_dist_leaf)
    leaves = [c for c in range(1, 6) if d_leaf[c - 1] > 0]
    prior = {}
    for root in range(1, len(d_nocp) + 1):
        if d_nocp[root - 1] == 0:
            continue
        if root in (C.PLUS, C.TIMES):
            for lt in leaves:
                for rt in leaves:
                    prior[(root, lt, rt)] = (d_nocp[root - 1] * d_leaf[lt - 1]
                                             * d_leaf[rt - 1])
        else:
            prior[(root, 0, 0)] = d_nocp[root - 1]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    log_post = {}
    for st, p in prior.items():
        nt = torch.tensor(st, device=device).expand(batch, 3).contiguous()
        lmls = []
        for _ in range(n_draws // batch):
            pz = torch.randn((batch, 3, C.MAX_PARAMS), generator=gen,
                             dtype=dtype, device=device)
            pz = pz * M.param_slot_mask(nt, tables)
            lmls.append(M.lml(nt, pz, nz, data.ts, data.xs, data.mask, cfg,
                              tables).double())
        lml = torch.cat(lmls)
        if not bool(torch.isfinite(lml).all()):
            raise RuntimeError(f"non-finite LML for structure {st}")
        log_post[st[0] * 100 + st[1] * 10 + st[2]] = float(
            np.log(p) + torch.logsumexp(lml, 0) - np.log(len(lml)))
    z = np.logaddexp.reduce(list(log_post.values()))
    return {k: float(np.exp(v - z)) for k, v in log_post.items()}


def depth_annealed(P, seed, device, dtype=None):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ts, xs = series()
    parts, _ = smc_depth.run_smc_anneal_depth(
        gen, ts, xs, schedule=[1, 2], n_particles=P, n_mcmc=3, n_hmc=2,
        noise=NOISE, hmc_cfg=HMC, dtype=dtype, device=device)
    return weighted_freqs(parts)


def data_annealed(P, seed, device, dtype):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ts, xs = series()
    cfg = config()
    parts = smc.run_smc_anneal_data(
        gen, ts, xs, cfg, M.prior_tables(cfg, device, dtype), P,
        [4, 8, len(ts)], 3, 2, dtype=dtype, device=device, hmc_cfg=HMC)
    return weighted_freqs(parts)


def structure_gap(fa, ess_a, fb, ess_b):
    """The JAX test's per-structure check: the largest |pa - pb| over its
    bound 5 se + 0.03 (se from the two ESSs); < 1 passes."""
    worst = 0.0
    for k in set(fa) | set(fb):
        pa, pb = fa.get(k, 0.0), fb.get(k, 0.0)
        se = (np.sqrt(max(pa, pb) * (1 - min(pa, pb)))
              * (1 / np.sqrt(ess_a) + 1 / np.sqrt(ess_b)))
        worst = max(worst, abs(pa - pb) / (5.0 * se + 0.03))
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--particles", type=int, default=4096)
    ap.add_argument("--seeds", type=int, nargs="+", default=[5, 6])
    ap.add_argument("--reference-weight", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    if args.reference_weight:
        smc_depth.detach_support_logprob = (
            lambda nt, *a, **k: torch.zeros(nt.shape[0], dtype=dtype,
                                            device=nt.device))
    exact = exact_posterior(device, dtype)
    print(f"device {args.device}, P {args.particles}, "
          f"{'reference' if args.reference_weight else 'normalized'} "
          f"extension weight")
    for s in args.seeds:
        fd, ess_d = depth_annealed(args.particles, s, device, dtype)
        fa, ess_a = data_annealed(args.particles, s + 4, device, dtype)
        print(f"seed {s}: TV depth-data {total_variation(fd, fa):.4f}, "
              f"depth-exact {total_variation(fd, exact):.4f}, data-exact "
              f"{total_variation(fa, exact):.4f}; worst structure gap / "
              f"bound {structure_gap(fd, ess_d, fa, ess_a):.3f}; ESS depth "
              f"{ess_d:.1f}, data {ess_a:.1f}; leaves depth "
              f"{sum(v for k, v in fd.items() if k < 600):.4f}, data "
              f"{sum(v for k, v in fa.items() if k < 600):.4f}, exact "
              f"{sum(v for k, v in exact.items() if k < 600):.4f}",
              flush=True)


if __name__ == "__main__":
    main()
