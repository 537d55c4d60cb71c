"""iclaims: weekly unemployment claims in log space.

The port's counterpart of docs/tutorials/iclaims.py (the reference's
`iclaims.ipynb`): model the weekly US unemployment insurance claims
series on a log scale, fit with SMC (fixed resampling schedule), query
mixture quantiles, and convert mean forecasts back to direct space with
the log-normal moment correction.

Reference configuration (iclaims.md): n_particles=8,
linear_schedule(n_train, .20), n_mcmc=50, n_hmc=10, shuffle=true,
adaptive_resampling=false.

    AUTOGP_TUTORIAL_FAST=1 python -m \
        autogp_tpu_torch.scripts.tutorials.iclaims
"""

import time

import numpy as np
import torch

import autogp_tpu_torch as A
from autogp_tpu_torch import Schedule
from autogp_tpu_torch.scripts.tutorials._common import (
    FAST, load_iclaims, main_device, train_test_split)
from autogp_tpu_torch.transforms import LogTransform


def run(fast: bool, device=None, dtype=None) -> dict:
    """The flow; also returns the fit's seconds on the host clock (`fit_s`,
    the device synchronized at both ends on the card)."""
    df = load_iclaims()
    df["y"] = np.log(df["y"].to_numpy())  # model in log space (iclaims.md)
    if fast:
        df = df.iloc[:60].reset_index(drop=True)
    df_train, df_test = train_test_split(df, 0.8)
    n_train = len(df_train)

    # Fit.
    n_particles = 2 if fast else 8
    cfg = A.GPConfig(max_depth=3) if fast else None
    A.seed(10)
    model = A.GPModel(df_train["ds"], df_train["y"].to_numpy(),
                      n_particles=n_particles, config=cfg, device=device,
                      dtype=dtype)
    frac = 0.5 if fast else 0.20
    n_mcmc, n_hmc = (4, 4) if fast else (50, 10)
    on_card = model.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    A.fit_smc(model, schedule=Schedule.linear_schedule(n_train, frac),
              n_mcmc=n_mcmc, n_hmc=n_hmc, shuffle=True,
              adaptive_resampling=False, verbose=not fast)
    if on_card:
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0

    for w, k in zip(model.particle_weights(), model.covariance_kernels()):
        print(f"weight {w:.3f}: {A.GP.pretty(k)}")

    # Forecasts (log space).
    ds_future = df["ds"].max() + np.arange(1, 27) * (df["ds"].iloc[1]
                                                     - df["ds"].iloc[0])
    ds_query = np.concatenate([df["ds"].to_numpy(), np.asarray(ds_future)])
    forecasts = A.predict(model, ds_query, quantiles=[0.025, 0.975])

    # Overall mixture quantiles via the bracketed CDF bisection
    # (predict_quantile, api.jl:547-596).
    ds_q = ds_query[:: max(1, len(ds_query) // 32)]
    lo, _ = A.predict_quantile(model, ds_q, 0.025, tol=1e-6)
    md, _ = A.predict_quantile(model, ds_q, 0.50, tol=1e-6)
    hi, _ = A.predict_quantile(model, ds_q, 0.975, tol=1e-6)
    assert np.all(lo <= md) and np.all(md <= hi)
    # Quantiles transform directly: exp(q) is the direct-space quantile.
    print("direct-space median forecast head:", np.exp(md[:4]))

    # Direct-space mean forecasts need the log-normal moment correction
    # E[exp(Z)] = exp(mu + s^2/2), NOT exp(E[Z]) (iclaims.md MvLogNormal
    # note; Transforms.jl:84-91).
    mvn = A.predict_mvn(model, ds_q)
    lt = LogTransform()
    naive = np.exp(mvn.mean())
    correct = np.zeros_like(naive)
    for w, c in zip(mvn.weights, mvn.components):
        mu = c.mean
        var = np.diag(c.cov)
        m, _ = lt.unapply_mean_var(mu, var)
        correct += w * m
    bias = correct - naive
    assert np.all(bias >= -1e-8), "log-normal mean must exceed exp(mean)"
    print("max direct-space mean bias of the naive transform:",
          float(np.max(bias)))
    return {"model": model, "df": df, "df_test": df_test,
            "ds_query": ds_query, "ds_q": ds_q, "forecasts": forecasts,
            "lo": lo, "md": md, "hi": hi, "mvn": mvn, "naive": naive,
            "correct": correct, "bias": bias, "fit_s": fit_s}


if __name__ == "__main__":
    run(FAST, device=main_device())
    print("ICLAIMS TUTORIAL OK")
