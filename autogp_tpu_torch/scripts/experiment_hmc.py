"""HMC ground-truth-recovery experiment (counterpart of scripts/
experiment_hmc.py; reference: test/experiment_hmc.jl).

BASELINE config 2's workload: a fixed kernel structure, HMC over its
numeric hyperparameters and the noise on data simulated from known values,
the held-out predictive log-probability tracked per step. It includes the
reference's Bayes-rule oracle: the predictive log-probability through the
conditional MVN must equal the difference of the joint and the observed
LMLs (experiment_hmc.jl:111-132); on the card both LMLs run the kernels.
The data is simulated with numpy from the seed exactly as the JAX script
does, so both packages see the same observations (with the same numpy).
Runs on the card; `run(device="cpu")` takes the plain versions in
float64.

`config2_sweeps` is BASELINE config 2 as scripts/bench_configs.py:181-203
times it: 20 sweeps of parameter and noise HMC (L = 10) at N = 500.

Usage:
    BENCHMARK=2 N=1000 N_OBS=200 N_STEPS=100 \\
        python3 -m autogp_tpu_torch.scripts.experiment_hmc
"""

import os
import time

import numpy as np
import torch

from autogp_tpu_torch import GP, GPConfig
from autogp_tpu_torch import backend
from autogp_tpu_torch import config as C
from autogp_tpu_torch import gp_math
from autogp_tpu_torch import model as M
from autogp_tpu_torch import tree as T
from autogp_tpu_torch.inference import hmc as hmc_mod
from autogp_tpu_torch.inference import smc

BENCHMARKS = {
    1: (GP.SquaredExponential(2.0), 0.01),
    2: (GP.Linear(0.5) + GP.Periodic(2.0, 1.0), 0.05),
    3: (GP.ChangePoint(GP.Linear(0.5), GP.Linear(1.5), 1.0, 0.001), 0.001),
}


def main():
    return run(bench=int(os.environ.get("BENCHMARK", 2)),
               n=int(os.environ.get("N", 1000)),
               n_obs=int(os.environ.get("N_OBS", 200)),
               n_steps=int(os.environ.get("N_STEPS", 100)),
               seed=int(os.environ.get("SEED", 0)),
               eps=float(os.environ.get("EPS", 0.1)))


def simulate(bench, n, n_obs, rng, cfg):
    """The experiment's data, drawn from `rng` as the JAX script draws it:
    bench's structure and noise simulated on an n-point grid over [0, 10],
    a random n_obs of the points observed. Returns (ts_obs, xs_obs,
    ts_test, xs_test), each sorted by time."""
    node, noise = BENCHMARKS[bench]
    nz = float(M.untransform_param("noise", noise, cfg))
    ts = np.linspace(0, 10, n)
    noise_sim = float(M.transform_param("noise", nz, cfg) + C.MODEL_JITTER)
    Kt = GP.compute_cov_matrix_vectorized(node, noise_sim, ts)
    xs = rng.multivariate_normal(np.zeros(n), Kt)
    perm = rng.permutation(n)
    obs_idx = np.sort(perm[:n_obs])
    test_idx = np.sort(perm[n_obs:])
    return ts[obs_idx], xs[obs_idx], ts[test_idx], xs[test_idx]


def _resolve(device, dtype):
    device = backend.resolve_device(device)
    return device, dtype or (torch.float32 if device.type == "cuda"
                             else torch.float64)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(bench=2, n=1000, n_obs=200, n_steps=100, seed=0, eps=0.1,
        verbose=True, *, device="cuda", dtype=None):
    """Run the experiment; returns the metrics dict of the JAX script
    (lp_bayes, lp_true, lp_init, lp_final, lml_init, lml_final, acc_rate,
    ms_per_step). `dtype` defaults to float32 on the card, float64 on the
    CPU. Raises if the Bayes-rule oracle fails."""
    device, dtype = _resolve(device, dtype)
    cfg = GPConfig(changepoints=True, max_depth=4)
    tables = M.prior_tables(cfg, device, dtype)
    rng = np.random.default_rng(seed)

    node_true, noise_true = BENCHMARKS[bench]
    nz_true = float(M.untransform_param("noise", noise_true, cfg))
    if verbose:
        print(f"True structure: {GP.pretty(node_true)} noise={noise_true}")

    ts_obs, xs_obs, ts_test, xs_test = simulate(bench, n, n_obs, rng, cfg)

    nt_np, pz_true = T.node_to_tensor(node_true, cfg)
    nt = torch.as_tensor(nt_np, device=device)[None]

    data = smc.make_dataset(ts_obs, xs_obs, dtype=dtype, device=device)
    d = (data.ts, data.xs, data.mask)
    ts_test_t = torch.as_tensor(ts_test, dtype=dtype, device=device)
    xs_test_t = torch.as_tensor(xs_test, dtype=dtype, device=device)

    def lp_test(pz, nz):
        """Held-out predictive log-probability via the conditional MVN."""
        pt = M.transform_params(nt, pz, tables)
        noise = M.transform_noise(nz, cfg)
        mu, cov = gp_math.posterior_mvn_masked(
            nt, pt, noise, data.ts, data.xs, data.mask, ts_test_t,
            cfg.depth_cap)
        return float(gp_math.mvn_logpdf(mu, cov, xs_test_t)[0])

    # --- Bayes-rule oracle (experiment_hmc.jl:111-132) --------------------
    pz_j = torch.as_tensor(pz_true, dtype=dtype, device=device)[None]
    nz_j = torch.full((1,), nz_true, dtype=dtype, device=device)
    data_joint = smc.make_dataset(np.concatenate([ts_obs, ts_test]),
                                  np.concatenate([xs_obs, xs_test]),
                                  dtype=dtype, device=device)
    w_joint = M.lml(nt, pz_j, nz_j, data_joint.ts, data_joint.xs,
                    data_joint.mask, cfg, tables)
    w_obs = M.lml(nt, pz_j, nz_j, *d, cfg, tables)
    lp_bayes = float(w_joint[0]) - float(w_obs[0])
    lp_ll = lp_test(pz_j, nz_j)
    if verbose:
        print(f"predictive logp: conditional={lp_ll:.6f} bayes={lp_bayes:.6f} "
              f"diff={abs(lp_ll - lp_bayes):.2e}")
    # float64: near-exact identity. float32: each of the n_test log-terms
    # carries ~1e-4 roundoff, so the identity holds to ~3e-4 * n_test.
    tol = (max(1e-6 * abs(lp_bayes), 1e-3) if dtype == torch.float64
           else max(1e-4 * abs(lp_bayes), 3e-4 * len(ts_test)))
    if not abs(lp_ll - lp_bayes) < tol:
        raise RuntimeError(f"Bayes-rule oracle failed: diff "
                           f"{abs(lp_ll - lp_bayes)} > {tol}")

    # --- HMC from a prior draw (z ~ N(0, 1), as the reference generates
    # its initial trace) --------------------------------------------------
    pmask = T.param_mask(nt).to(dtype)
    pz0 = torch.as_tensor(rng.standard_normal(pz_true.shape), dtype=dtype,
                          device=device)[None] * pmask
    nz0 = torch.full((1,), float(rng.standard_normal()), dtype=dtype,
                     device=device)

    # Gen.hmc defaults (eps=0.1, L=10) as used by experiment_hmc.jl:237.
    hc = hmc_mod.HMCConfig(L_param=10, eps_param=eps, L_noise=10,
                           eps_noise=eps, n_exit=10 ** 9)

    lml0 = M.lml(nt, pz0, nz0, *d, cfg, tables)
    lp_init = lp_test(pz0, nz0)
    if verbose:
        print(f"init: score={float(lml0[0]):.3f} lp_test={lp_init:.3f} "
              f"(true lp_test={lp_ll:.3f})")

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pz, nz, lml = pz0, nz0, lml0
    t_total = 0.0
    acc_total = 0
    for i in range(1, n_steps + 1):
        _sync(device)
        t0 = time.perf_counter()
        pz, nz, lml, n_acc, _ = hmc_mod.rejuvenate_parameters(
            gen, nt, pz, nz, lml, d, cfg, tables, 1, hc, True)
        _sync(device)
        t_total += time.perf_counter() - t0
        acc_total += int(n_acc[0])
        if verbose and i % max(1, n_steps // 10) == 0:
            print(f"step {i:4d} acc={acc_total}/{i} "
                  f"lml={float(lml[0]):10.3f} "
                  f"lp_test={lp_test(pz, nz):10.3f}")

    lp_final = lp_test(pz, nz)
    if verbose:
        print(f"Completed {n_steps} HMC steps in {t_total:.2f}s "
              f"(avg {t_total / n_steps * 1000:.1f} ms/step)")
        print("inferred kernel:", T.tensor_to_node(
            nt_np, pz[0].cpu().numpy(), cfg))
        print("inferred noise:", float(M.transform_noise(nz, cfg)[0]))
    return {"lp_bayes": lp_bayes, "lp_true": lp_ll, "lp_init": lp_init,
            "lp_final": lp_final, "lml_init": float(lml0[0]),
            "lml_final": float(lml[0]), "acc_rate": acc_total / n_steps,
            "ms_per_step": t_total / n_steps * 1000}


def config2_problem():
    """BASELINE config 2's data and structure (scripts/bench_configs.py:
    181-203): N = 500 points on [0, 1] drawn from Linear(0.3, 0.9, 0.8) +
    Periodic(0.8, 0.25, 1.1) with noise 0.05 (numpy seed 2), under
    GPConfig(max_depth=3). Returns (ts, xs, node, config)."""
    N = 500
    rng = np.random.default_rng(2)
    ts = np.linspace(0, 1, N)
    node = GP.Linear(0.3, 0.9, 0.8) + GP.Periodic(0.8, 0.25, 1.1)
    xs = rng.multivariate_normal(
        np.zeros(N), GP.compute_cov_matrix_vectorized(node, 0.05, ts))
    return ts, xs, node, GPConfig(max_depth=3)


def config2_sweeps(device="cuda", n_sweeps=20, dtype=None):
    """BASELINE config 2: `n_sweeps` sweeps of parameter and noise HMC
    (HMCConfig(n_exit=100): L = 10 each, never cut short) on the true
    structure from noise_z = 0.1, on the 512-point bucket, one particle.
    Timed after one warm-up call (generator seed 0) on generator seed 1:
    CUDA events on the card, the host clock on the CPU. Returns a dict of
    the final node_type [1, M], params_z [1, M, 3], noise_z [1], lml [1],
    n_accept and n_sweeps (ints) and ms (the timed call)."""
    device, dtype = _resolve(device, dtype)
    ts, xs, node, cfg = config2_problem()
    tables = M.prior_tables(cfg, device, dtype)
    nt_np, pz_np = T.node_to_tensor(node, cfg)
    nt = torch.as_tensor(nt_np, device=device)[None]
    pz = torch.as_tensor(pz_np, dtype=dtype, device=device)[None]
    nz = torch.full((1,), 0.1, dtype=dtype, device=device)
    data = smc.make_dataset(ts, xs, dtype=dtype, device=device)
    d = (data.ts, data.xs, data.mask)
    hc = hmc_mod.HMCConfig(n_exit=100)
    lml0 = M.lml(nt, pz, nz, *d, cfg, tables)

    def sweeps(seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return hmc_mod.rejuvenate_parameters(gen, nt, pz, nz, lml0, d, cfg,
                                             tables, n_sweeps, hc, True)

    sweeps(0)
    _sync(device)
    if device.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = sweeps(1)
        ev[1].record()
        ev[1].synchronize()
        ms = ev[0].elapsed_time(ev[1])
    else:
        t0 = time.perf_counter()
        out = sweeps(1)
        ms = (time.perf_counter() - t0) * 1e3
    pz1, nz1, lml1, n_acc, n_sw = out
    return {"node_type": nt, "params_z": pz1, "noise_z": nz1, "lml": lml1,
            "n_accept": int(n_acc[0]), "n_sweeps": int(n_sw[0]), "ms": ms}


if __name__ == "__main__":
    main()
