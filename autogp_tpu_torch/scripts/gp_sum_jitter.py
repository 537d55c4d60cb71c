"""How the GP-sum posterior's precision and jitter set predict_mvn_sum's
error, on one NVIDIA GPU.

    python3 -m autogp_tpu_torch.scripts.gp_sum_jitter

Fits chip_smoke.py's config-4 model (64 particles, the synthetic N = 1024
series, seed 1, n_mcmc = n_hmc = 10), takes its 8 heaviest particles and
conditions their sum-of-products components (split by GP.Periodic) at 32
future points with `gp_math.infer_gp_sum_from_blocks`:

1. in float32 on kernel 1's float32 blocks with the reference's float32
   jitter (1e-5): the largest |mean(X) - mean(F_T) - mean(F_nT)| over
   max |mean(X)|, per particle;
2. in float64 on kernel 1's float32 blocks, and on float64 blocks of the
   plain evaluator (for comparison only), at each fixed jitter 1e-8,
   1e-7, 1e-6, 1e-5: how many particles factor, and each particle's mean
   and covariance error (normwise, data space) against predict_mvn_sum in
   float64 on the CPU, and the particles' posterior covariance scale.

Prints one line per measurement. It needs a card; it fails without one.
"""

from __future__ import annotations

import sys
import warnings

import numpy as np
import torch


def _blocks(A, m, ds_pred, dtype, plain):
    """[P, 2, n+p, n+p] component blocks of model m (kernel 1, or the plain
    evaluator with `plain`), as predict_mvn_sum builds them."""
    from autogp_tpu_torch import model as M
    from autogp_tpu_torch import tree as T
    from autogp_tpu_torch.ops import cov
    ts, tsp = m._ds_numeric(), m._ds_numeric(ds_pred)
    splits = A.api.sum_components(m, A.GP.Periodic)
    P = m.num_particles
    cfg = m.config.replace(max_depth=max(max(c.depth for c in s)
                                         for s in splits))
    nts = np.zeros((2 * P, cfg.max_nodes), np.int64)
    pzs = np.zeros((2 * P, cfg.max_nodes, 3))
    with np.errstate(divide="ignore"):
        for i, s in enumerate(splits):
            for j, c in enumerate(s):
                nts[2 * i + j], pzs[2 * i + j] = T.node_to_tensor(c, cfg)
    dev = torch.device("cuda")
    nt = torch.as_tensor(nts, device=dev)
    pt = M.transform_params(nt, torch.as_tensor(pzs, dtype=dtype, device=dev),
                            M.prior_tables(cfg, dev, dtype))
    z = torch.as_tensor(np.concatenate([ts, tsp]), dtype=dtype, device=dev)
    one = torch.ones_like(z)
    zero = torch.zeros(2 * P, dtype=dtype, device=dev)
    fn = cov.cov_tape_plain if plain else cov.cov_tape
    K = fn(nt, pt, zero, z, z, one, one, cfg.depth_cap, False, False)
    return K.reshape(P, 2, len(z), len(z)), len(ts), len(tsp)


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        sys.exit(1)
    warnings.simplefilter("ignore")
    import autogp_tpu_torch as A
    from autogp_tpu_torch import gp_math
    from autogp_tpu_torch.utils.profile_fit import _series

    t, y = _series(1024, skip=1024)
    A.seed(1)
    model = A.GPModel(t, y, n_particles=64)
    A.fit_smc(model, schedule=A.Schedule.linear_schedule(1024, 0.25),
              n_mcmc=10, n_hmc=10)
    ds_pred = np.arange(1024, 1056, dtype=np.float64)
    top = [int(i) for i in np.argsort(-model.particle_weights())[:8]]
    d = A.to_dict(model)
    for key in ("kernels", "noise_zs", "noises"):
        d[key] = [d[key][i] for i in top]
    d["pf_state"]["log_weights"] = [d["pf_state"]["log_weights"][i]
                                    for i in top]
    ref, _ = A.predict_mvn_sum(A.from_dict(d, device="cpu",
                                           dtype=torch.float64),
                               ds_pred, A.GP.Periodic)
    sub = A.from_dict(d, device="cuda")
    yt = sub.y_transform
    noises = sub.observation_noise_variances(reparameterize=False)
    print(f"device {torch.cuda.get_device_name(0)}; top 8 particles; "
          f"posterior covariance scale (model space) "
          + ", ".join(f"{float(np.abs(c.cov).max() * yt.slope ** 2):.2e}"
                      for c in ref.components), flush=True)

    def condition(K, n, dtype, jitter):
        f = {"dtype": dtype, "device": K.device}
        return gp_math.infer_gp_sum_from_blocks(
            K[:, :, :n, :n].to(dtype), K[:, :, :n, n:].to(dtype),
            K[:, :, n:, n:].to(dtype), torch.as_tensor(noises, **f),
            torch.as_tensor(sub._y_numeric(), **f), torch.ones(n, **f),
            jitter=(jitter,))

    K32, n, p = _blocks(A, sub, ds_pred, torch.float32, plain=False)
    mu, _ = condition(K32, n, torch.float32, 1e-5)
    mu = mu.double().cpu().numpy()
    sums = [float(np.abs(m[2 * p:] - m[:p] - m[p:2 * p]).max()
                  / np.abs(m[2 * p:]).max()) for m in mu]
    print("float32 conditioning, float32 blocks, jitter 1e-5: "
          "|mean(X) - mean(F_T) - mean(F_nT)| / max|mean(X)| "
          + ", ".join(f"{e:.2e}" for e in sums), flush=True)
    K64, _, _ = _blocks(A, sub, ds_pred, torch.float64, plain=True)
    for name, K in (("float32 kernel-1 blocks", K32),
                    ("float64 plain blocks", K64)):
        for jit in (1e-8, 1e-7, 1e-6, 1e-5):
            mu, cv = condition(K, n, torch.float64, jit)
            mu, cv = mu.cpu().numpy(), cv.cpu().numpy()
            errs = []
            for i, c in enumerate(ref.components):
                mm, cc = yt.unapply_mean_var(mu[i], cv[i])
                mm[:p] += yt.intercept / yt.slope
                errs.append(
                    f"{np.abs(mm - c.mean).max() / np.abs(c.mean).max():.1e}"
                    f"/{np.abs(cc - c.cov).max() / np.abs(c.cov).max():.1e}")
            ok = int(np.isfinite(cv).all(axis=(1, 2)).sum())
            print(f"float64 conditioning, {name}, jitter {jit:.0e}: "
                  f"{ok} of 8 factor; mean/cov error vs float64 CPU "
                  + ", ".join(errs), flush=True)


if __name__ == "__main__":
    main()
