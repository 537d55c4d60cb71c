"""Overview: structure discovery on the airline passengers series.

The port's counterpart of docs/tutorials/overview.py (the reference's
`overview.ipynb`): fit an ensemble of GP covariance structures to the
monthly airline passengers series (tsdl.161), forecast with uncertainty
bands, score held-out data, and stream new observations in online.

Reference configuration (overview.md:104,244): n_particles=6,
linear_schedule(n_train, .10), n_mcmc=75, n_hmc=10.

    AUTOGP_TUTORIAL_FAST=1 python -m \
        autogp_tpu_torch.scripts.tutorials.overview
"""

import numpy as np

import autogp_tpu_torch as A
from autogp_tpu_torch import Schedule
from autogp_tpu_torch.scripts.tutorials._common import (
    FAST, load_tsdl161, main_device, train_test_split)


def run(fast: bool, device=None, dtype=None) -> dict:
    df = load_tsdl161()
    if fast:  # CI smoke: subsample to keep the fit small
        df = df.iloc[::3].reset_index(drop=True)
    df_train, df_test = train_test_split(df, 0.8)
    n_train = len(df_train)
    print(f"{len(df)} observations; {n_train} train / {len(df_test)} test")

    # Initialize the model: particles are sampled from the PCFG prior.
    n_particles = 2 if fast else 6
    cfg = A.GPConfig(max_depth=3) if fast else None
    A.seed(6)
    model = A.GPModel(df_train["ds"], df_train["y"].to_numpy(),
                      n_particles=n_particles, config=cfg, device=device,
                      dtype=dtype)

    # Query horizon: observed + test + 36 months ahead.
    ds_future = df["ds"].max() + np.arange(1, 37) * (df["ds"].iloc[1]
                                                     - df["ds"].iloc[0])
    ds_query = np.concatenate([df["ds"].to_numpy(), np.asarray(ds_future)])

    # Prior forecasts (structures sampled from the prior, not yet fit).
    forecasts_prior = A.predict(model, ds_query, quantiles=[0.025, 0.975])
    print("prior forecast rows:", len(forecasts_prior))

    # Fit with SMC structure learning (fit_smc!, api.jl:212-249).
    n_mcmc, n_hmc = (4, 4) if fast else (75, 10)
    frac = 0.5 if fast else 0.10
    A.fit_smc(model, schedule=Schedule.linear_schedule(n_train, frac),
              n_mcmc=n_mcmc, n_hmc=n_hmc, verbose=not fast)

    # Inspect the discovered ensemble.
    for w, k in zip(model.particle_weights(), model.covariance_kernels()):
        print(f"weight {w:.3f}: {A.GP.pretty(k)}")
    print("log marginal likelihood estimate:",
          model.log_marginal_likelihood_estimate())

    # Forecasts + held-out predictive probability.
    forecasts = A.predict(model, ds_query, quantiles=[0.025, 0.975])
    logps = A.predict_proba(model, df_test["ds"], df_test["y"].to_numpy())
    print(logps)

    # The full predictive distribution as a particle-weighted MVN mixture.
    mvn = A.predict_mvn(model, df_test["ds"])
    print("mixture components:", mvn.n_components, "dim:", mvn.dim)

    # Online learning: absorb the test data, reweight, rejuvenate.
    print("weights before add_data:", model.particle_weights())
    A.add_data(model, df_test["ds"], df_test["y"].to_numpy())
    print("weights after add_data:", model.particle_weights())
    A.maybe_resample(model, ess_threshold=model.num_particles / 2)
    A.mcmc_structure(model, n_mcmc=2 if fast else 10,
                     n_hmc=2 if fast else 10)

    forecasts_final = A.predict(model, ds_query, quantiles=[0.025, 0.975])
    cols = ["y_mean", "y_0.025", "y_0.975"]
    assert np.isfinite(forecasts_final[cols].to_numpy()).all()
    return {"model": model, "df": df, "df_test": df_test,
            "ds_query": ds_query, "forecasts": forecasts, "logps": logps,
            "mvn": mvn, "forecasts_final": forecasts_final}


if __name__ == "__main__":
    run(FAST, device=main_device())
    print("OVERVIEW TUTORIAL OK")
