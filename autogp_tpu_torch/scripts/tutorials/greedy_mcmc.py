"""Greedy search and MCMC sampling.

The port's counterpart of docs/tutorials/greedy_mcmc.py (the reference's
`greedy_mcmc.ipynb`): two alternatives to SMC for structure learning --
greedy AIC-driven search (`fit_greedy`, single particle, no changepoints)
and pure involutive MCMC (`fit_mcmc`) -- and the hybrid greedy/MCMC chain
(`fit_greedy_mcmc`).

Reference configuration (greedy_mcmc.md): greedy with max_depth=10 and a
per-step callback; MCMC with 2 particles, n_mcmc=45, n_hmc=10.

    AUTOGP_TUTORIAL_FAST=1 python -m \
        autogp_tpu_torch.scripts.tutorials.greedy_mcmc
"""

import autogp_tpu_torch as A
from autogp_tpu_torch import GP, GPConfig
from autogp_tpu_torch.scripts.tutorials._common import (
    FAST, load_tsdl161, main_device)

PARTS = ("greedy", "greedy_mcmc", "mcmc")


def run(fast: bool, device=None, dtype=None, parts=PARTS) -> dict:
    """The flow's three parts, or those named in `parts`, each from its
    own seed as the JAX flow runs them."""
    df = load_tsdl161()
    ds = df["ds"]
    y = df["y"].to_numpy()
    if fast:
        ds, y = ds[:48], y[:48]
    out = {}

    # Greedy search: requires 1 particle, finite depth, no changepoints
    # (api.jl:334-336).
    config = GPConfig(changepoints=False, max_depth=5 if not fast else 3)
    if "greedy" in parts:
        A.seed(2)
        model = A.GPModel(ds, y, n_particles=1, config=config,
                          device=device, dtype=dtype)
        aic_trace = []

        def greedy_callback(*, model, step, aic, elapsed, **kwargs):
            k = model.covariance_kernels(reparameterize=False)[0]
            aic_trace.append((step, aic))
            print(f"greedy step {step}: AIC={aic:.2f} kernel={GP.pretty(k)}")

        A.fit_greedy(model, max_depth=2 if fast else 4,
                     callback_fn=greedy_callback)
        assert len(aic_trace) >= 1
        # AIC is non-increasing across accepted greedy steps.
        aics = [a for _, a in aic_trace]
        assert all(b <= a + 1e-9 for a, b in zip(aics, aics[1:]))
        forecasts = A.predict(model, ds, quantiles=[0.025, 0.975])
        out.update(model=model, aic_trace=aic_trace, forecasts=forecasts)

    # Hybrid greedy/MCMC chain ("Algorithm 0", Greedy.jl:59-130): n_mcmc
    # AIC-monotone steps, each keeping the best of n_parallel independent
    # subtree-replace + MAP-optimize proposals.
    if "greedy_mcmc" in parts:
        A.seed(7)
        model_h = A.GPModel(ds, y, n_particles=1, config=config,
                            device=device, dtype=dtype)
        hybrid_aics = []
        A.fit_greedy_mcmc(
            model_h, n_mcmc=4 if fast else 20, n_parallel=2 if fast else 4,
            callback_fn=lambda *, step, aic, accepted, **kw:
            hybrid_aics.append(aic))
        assert all(b <= a + 1e-9 for a, b in zip(hybrid_aics,
                                                  hybrid_aics[1:]))
        print(f"greedy-mcmc chain: AIC {hybrid_aics[0]:.2f} -> "
              f"{hybrid_aics[-1]:.2f}")
        k_h = model_h.covariance_kernels(reparameterize=False)[0]
        print("greedy-mcmc kernel:", GP.pretty(k_h))
        out.update(model_h=model_h, hybrid_aics=hybrid_aics)

    # MCMC sampling: each particle is an independent chain
    # (fit_mcmc!, api.jl:280-307).
    if "mcmc" in parts:
        A.seed(11)
        cfg2 = GPConfig(max_depth=3) if fast else None
        model2 = A.GPModel(ds, y, n_particles=2, config=cfg2, device=device,
                           dtype=dtype)
        steps_seen = []

        def mcmc_callback(*, model, step, elapsed, **kwargs):
            steps_seen.append(step)

        n_mcmc, n_hmc = (5, 3) if fast else (45, 10)
        A.fit_mcmc(model2, n_mcmc=n_mcmc, n_hmc=n_hmc,
                   callback_fn=mcmc_callback)
        print("MCMC accepted-step callbacks at:", steps_seen)
        for k in model2.covariance_kernels():
            print("chain kernel:", GP.pretty(k))
        out.update(model2=model2, steps_seen=steps_seen)
    return out


if __name__ == "__main__":
    run(FAST, device=main_device())
    print("GREEDY/MCMC TUTORIAL OK")
