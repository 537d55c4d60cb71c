"""Callbacks: monitoring SMC inference.

The port's counterpart of docs/tutorials/callbacks.py (the reference's
`callbacks.ipynb`): register a callback with `fit_smc` via
`Callbacks.make_smc_callback` and watch the forecasts sharpen as each SMC
step incorporates more data.

Reference configuration (callbacks.md): n_particles=8,
linear_schedule(n, .05), n_mcmc=10, n_hmc=10, shuffle=false.

    AUTOGP_TUTORIAL_FAST=1 python -m \
        autogp_tpu_torch.scripts.tutorials.callbacks
"""

import numpy as np

import autogp_tpu_torch as A
from autogp_tpu_torch import Schedule
from autogp_tpu_torch.callbacks import make_smc_callback
from autogp_tpu_torch.scripts.tutorials._common import (
    FAST, load_tsdl161, main_device)


def run(fast: bool, device=None, dtype=None) -> dict:
    df = load_tsdl161()
    if fast:
        df = df.iloc[::3].reset_index(drop=True)
    ds = df["ds"]
    y = df["y"].to_numpy()
    n = len(df)

    n_particles = 2 if fast else 8
    cfg = A.GPConfig(max_depth=3) if fast else None
    A.seed(3)
    model = A.GPModel(ds, y, n_particles=n_particles, config=cfg,
                      device=device, dtype=dtype)

    # The callback: keyword-only args + **kwargs (Callbacks.jl:29-56
    # signature contract). Collects per-step ESS, runtime and forecasts.
    history = []

    def fn(*, history, model, ds_next, y_next, step, elapsed, resampled,
           rejuvenated, **kwargs):
        fc = A.predict(model, ds, quantiles=[0.025, 0.975])
        history.append({
            "step": step,
            "elapsed": elapsed,
            "ess": model.effective_sample_size(),
            "resampled": resampled,
            "rejuvenated": rejuvenated,
            "n_observed": len(model.ds),
            "mean_band": float(np.mean(fc["y_0.975"] - fc["y_0.025"])),
        })
        print(f"step {step:3d}: observed={len(model.ds):3d} "
              f"ess={history[-1]['ess']:.2f} elapsed={elapsed:.1f}s "
              f"band={history[-1]['mean_band']:.2f}")

    callback_fn = make_smc_callback(fn, model, history=history)

    # Fit with the callback attached.
    frac = 0.5 if fast else 0.05
    n_mcmc, n_hmc = (3, 3) if fast else (10, 10)
    A.fit_smc(model, schedule=Schedule.linear_schedule(n, frac),
              n_mcmc=n_mcmc, n_hmc=n_hmc, shuffle=False,
              callback_fn=callback_fn)

    # The callback fired at step 0 (prior) and at every schedule step, and
    # the predictive bands tighten as data accumulates.
    assert len(history) >= 2
    assert history[0]["step"] == 0
    assert history[-1]["n_observed"] == n
    assert history[-1]["mean_band"] < history[0]["mean_band"]
    return {"model": model, "history": history}


if __name__ == "__main__":
    run(FAST, device=main_device())
    print("CALLBACKS TUTORIAL OK")
