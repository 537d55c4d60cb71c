"""Decomposition: interpreting learned structures (M1266).

The port's counterpart of docs/tutorials/decomposition.py (the
reference's `decomposition.ipynb`): fit the M3 monthly series M1266, then
break the learned kernels into interpretable temporal components three
ways -- `decompose` (expression-tree fragments), `split_kernel_sop`
(sum-of-products split by base kernel), and `predict_sum` (joint
posterior over the latent components).

Reference configuration (decomposition.md:69,81): n_particles=18,
schedule = 2:12:n_train, n_mcmc=100, n_hmc=20.

    AUTOGP_TUTORIAL_FAST=1 python -m \
        autogp_tpu_torch.scripts.tutorials.decomposition
"""

import numpy as np

import autogp_tpu_torch as A
from autogp_tpu_torch import GP
from autogp_tpu_torch.scripts.tutorials._common import (
    FAST, load_m1266, main_device, train_test_split)


def run(fast: bool, device=None, dtype=None) -> dict:
    df = load_m1266()
    if fast:
        df = df.iloc[::3].reset_index(drop=True)
    df_train, df_test = train_test_split(df, 0.85)
    n_train = len(df_train)

    # Fit.
    n_particles = 2 if fast else 18
    cfg = A.GPConfig(max_depth=3) if fast else None
    A.seed(4)
    model = A.GPModel(df_train["ds"], df_train["y"].to_numpy(),
                      n_particles=n_particles, config=cfg, device=device,
                      dtype=dtype)
    step = max(n_train // 2, 1) if fast else 12
    schedule = sorted(set(list(range(2, n_train, step)) + [n_train]))
    n_mcmc, n_hmc = (4, 4) if fast else (100, 20)
    A.fit_smc(model, schedule=schedule, n_mcmc=n_mcmc, n_hmc=n_hmc,
              verbose=False)

    ds_future = df["ds"].max() + np.arange(1, 25) * (df["ds"].iloc[1]
                                                     - df["ds"].iloc[0])
    ds_query = np.concatenate([df["ds"].to_numpy(), np.asarray(ds_future)])
    forecasts = A.predict(model, ds_query, quantiles=[0.025, 0.975])

    # 1. decompose: every expression-tree fragment as its own GP
    # (api.jl:731-771).
    decomposed = A.decompose(model)
    pid = 0
    frags = decomposed[pid].covariance_kernels(reparameterize=False)
    print(f"particle {pid} kernel:")
    print(GP.pretty(model.covariance_kernels(reparameterize=False)[pid]))
    print(f"decomposes into {len(frags)} fragments:")
    for f in frags:
        print("  ", GP.pretty(f))

    # 2. split_kernel_sop: seasonal (Periodic) part vs remainder
    # (api.jl:824-831).
    model_a, model_b = A.split_kernel_sop(model, GP.Periodic)
    print("seasonal part of particle 0:",
          GP.pretty(model_a.covariance_kernels(reparameterize=False)[0]))
    print("remainder of particle 0:",
          GP.pretty(model_b.covariance_kernels(reparameterize=False)[0]))

    # 3. predict_sum: joint posterior over the latent components and their
    # sum (api.jl:898-1034; kernel 1 on the components, on the card).
    ds_sum = ds_query[:: max(1, len(ds_query) // 64)]
    forecasts_sum = A.predict_sum(model, ds_sum, GP.Periodic,
                                  quantiles=[0.025, 0.975])
    print(forecasts_sum.head())
    # Component 0 = overall, 1 = Periodic part, 2 = remainder; the latent
    # means sum to the overall mean.
    p0 = forecasts_sum[forecasts_sum["particle"] == 1]
    overall = p0[p0["component"] == 0]["y_mean"].to_numpy()
    parts = (p0[p0["component"] == 1]["y_mean"].to_numpy()
             + p0[p0["component"] == 2]["y_mean"].to_numpy())
    assert np.allclose(overall, parts, rtol=1e-4, atol=1e-6)
    return {"model": model, "df_test": df_test, "ds_query": ds_query,
            "forecasts": forecasts, "decomposed": decomposed,
            "frags": frags, "model_a": model_a, "model_b": model_b,
            "ds_sum": ds_sum, "forecasts_sum": forecasts_sum,
            "overall": overall, "parts": parts}


if __name__ == "__main__":
    run(FAST, device=main_device())
    print("DECOMPOSITION TUTORIAL OK")
