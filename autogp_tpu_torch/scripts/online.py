"""Online GP forecasting script (counterpart of scripts/online.py;
reference: scripts/online.jl).

Env-var-configured SMC run over a two-column CSV (ds, y): incorporates one
observation per SMC step, logging per-step predictions, held-out test log
probabilities, and particle parents to a timestamped logs/ directory. Runs
on the card; `main(device="cpu")` takes the plain versions.

Usage:
    DATASET=data.csv N_PARTICLES=6 N_MCMC=200 N_HMC=10 \\
        python3 -m autogp_tpu_torch.scripts.online
"""

import datetime
import os

import numpy as np
import pandas as pd

import autogp_tpu_torch as A
from autogp_tpu_torch import Callbacks, GPConfig
from autogp_tpu_torch.api import to_numeric


def env(name, default=None, cast=str):
    v = os.environ.get(name)
    if v is None:
        return default
    if cast is bool:
        return v.lower() in ("1", "true", "yes")
    return cast(v)


def load_data(path, n_test=0, time_type="NUMERIC"):
    df = pd.read_csv(path, header=None, names=["ds", "y"])
    if time_type in ("DATE", "DATETIME"):
        ds = pd.to_datetime(df["ds"]).values
    else:
        ds = df["ds"].astype(float).values
    y = df["y"].astype(float).values
    n_train = len(ds) - n_test
    assert 1 <= n_train <= len(ds)
    return ds, y, n_train


def extend_data(ds, n_future, freq=None):
    """Extend the time index by n_future steps at the observed frequency
    (online.jl:131-140)."""
    if freq is None:
        freqs = ds[1:] - ds[:-1]
        freq = freqs[-1]
        if not np.all(freqs == freq):
            raise ValueError("Cannot determine freq; use FREQ=")
    ds_future = ds[-1] + freq * np.arange(1, n_future + 1)
    y_future = np.full(n_future, np.nan)
    return ds_future, y_future


def make_log_dir(config, schedule, log_root="logs"):
    base = os.path.basename(config["DATASET"])
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    log_dir = os.path.join(log_root, f"{stamp}.{base}")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "config"), "w") as f:
        for k, v in config.items():
            f.write(f"{k} {v}\n")
        f.write(f"SCHEDULE {schedule}\n")
    if config["VERBOSE"]:
        print(log_dir)
    return log_dir


def fn_callback(*, ds_test, y_test, log_dir, plot=False, **kwargs):
    """Per-step logging callback (online.jl:30-114)."""
    model = kwargs["model"]
    ds_next = kwargs["ds_next"]
    y_next = kwargs["y_next"]
    step = kwargs["step"]

    # ds_test arrives numeric (it includes the synthetic future grid);
    # align the model's raw index (possibly datetime64) to numeric too.
    ds_obs = to_numeric(model.ds)
    ds_next = to_numeric(ds_next)
    ds_query = np.concatenate([ds_obs, ds_next, ds_test])
    y_true = np.concatenate([model.y, y_next, y_test])
    predictions = A.predict(model, ds_query, quantiles=[0.025, 0.975])

    ds_type = np.full(len(ds_query), "", dtype=object)
    ds_type[np.isin(ds_query, ds_obs)] = "ds_obs"
    ds_type[np.isin(ds_query, ds_next)] = "ds_next"
    ds_type[np.isin(ds_query, ds_test)] = "ds_test"
    type_map = dict(zip(ds_query.tolist(), ds_type.tolist()))
    predictions["ds_type"] = [type_map[d] for d in predictions["ds"]]
    predictions["elapsed"] = kwargs["elapsed"]
    predictions["step"] = step
    predictions["resampled"] = kwargs["resampled"]
    predictions["rejuvenated"] = kwargs["rejuvenated"]

    test_mask = ~np.isnan(y_test)
    if test_mask.any() and len(model.ds) > 0:
        logps = A.predict_proba(model, ds_test[test_mask], y_test[test_mask])
    else:
        logps = None

    parents = model.particles.parents.cpu().numpy()
    predictions["logp_test"] = 0.0
    predictions["parent"] = 0
    for i in range(1, model.num_particles + 1):
        m = predictions["particle"] == i
        if logps is not None:
            predictions.loc[m, "logp_test"] = float(
                logps[logps["particle"] == i]["logp"].iloc[0])
        predictions.loc[m, "parent"] = int(parents[i - 1]) + 1

    truth = pd.DataFrame({"ds": ds_query, "y_true": y_true})
    predictions = predictions.merge(truth.drop_duplicates("ds"), on="ds",
                                    how="left")

    fname = os.path.join(log_dir, f"gp.{step:03d}")
    predictions.to_csv(fname, index=False)
    print(fname, flush=True)

    if plot:
        _plot_step(model, predictions, ds_query, ds_next, y_next, ds_test,
                   y_test, fname)


def _plot_step(model, predictions, ds_query, ds_next, y_next, ds_test,
               y_test, fname):
    """Overlay plot of observed/future/test data + per-particle forecasts
    (online.jl:80-114); saved as PNG next to the CSV (headless)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    order = np.argsort(ds_query)
    weights = model.particle_weights()
    fig, ax = plt.subplots()
    ax.scatter(model.ds, model.y, marker="o", color="k", s=20,
               label="Observed Data")
    ax.scatter(ds_next, y_next, label="Training Data (Future)", marker="o",
               s=20, alpha=.1, color="gray")
    ax.scatter(ds_test, y_test, label="Test Data", marker="o", s=20,
               color="r")
    for i in range(1, model.num_particles + 1):
        sub = predictions[predictions["particle"] == i]
        sub = sub.set_index("ds").loc[ds_query[order]].reset_index()
        ax.plot(sub["ds"], sub["y_mean"], linewidth=.5 * weights[i - 1],
                color="k")
        ax.fill_between(sub["ds"], sub["y_0.025"], sub["y_0.975"],
                        color="tab:green", alpha=.05)
    ax.legend(loc="upper left", fontsize=6)
    fig.savefig(fname + ".png", dpi=100)
    plt.close(fig)


def read_config():
    """The run's settings from the environment (online.jl:142-172)."""
    return {
        "DATASET": os.environ["DATASET"],
        "TIMETYPE": env("TIMETYPE", "DATE"),
        "N_PARTICLES": env("N_PARTICLES", 6, int),
        "SEED": env("SEED", int(np.random.default_rng().integers(1, 10000)),
                    int),
        "N_MCMC": env("N_MCMC", 200, int),
        "N_HMC": env("N_HMC", 10, int),
        "SAVE": env("SAVE", True, bool),
        "ADAPTIVE_RESAMPLING": env("ADAPTIVE_RESAMPLING", False, bool),
        "ADAPTIVE_REJUVENATION": env("ADAPTIVE_REJUVENATION", False, bool),
        "N_HMC_EXIT": env("N_HMC_EXIT", 10, int),
        "MAX_DEPTH": env("MAX_DEPTH", -1, int),
        "NOISE": env("NOISE", None, float),
        "SHUFFLE": env("SHUFFLE", False, bool),
        "N_TEST": env("N_TEST", 0, int),
        "N_FUTURE": env("N_FUTURE", 100, int),
        "BIASED": env("BIASED", False, bool),
        "CHANGEPOINTS": env("CHANGEPOINTS", False, bool),
        "PLOT": env("PLOT", False, bool),
        "VERBOSE": env("VERBOSE", False, bool),
        "CHECK": env("CHECK", False, bool),
        "FREQ": env("FREQ", None, float),
        "SCHEDULE_STEP": env("SCHEDULE_STEP", 1, int),
    }


def per_point_schedule(n_train, step=1):
    """Per-point schedule (online.jl:200), optionally strided for speed."""
    schedule = list(range(step, n_train + 1, step))
    if not schedule or schedule[-1] != n_train:
        schedule.append(n_train)
    return schedule


def main(device="cuda", schedule=None, log_root="logs"):
    """Run the script as the environment says and return the fitted model.
    `schedule` defaults to the per-point schedule with stride
    SCHEDULE_STEP; the step files go into a new directory under
    `log_root`."""
    config = read_config()
    A.seed(config["SEED"])
    ds, y, n_train = load_data(config["DATASET"], config["N_TEST"],
                               config["TIMETYPE"])
    if schedule is None:
        schedule = per_point_schedule(n_train, config["SCHEDULE_STEP"])
    if config["VERBOSE"]:
        print(schedule)

    ds_train, y_train = ds[:n_train], y[:n_train]
    ds_test, y_test = ds[n_train:], y[n_train:]

    model = A.GPModel(
        ds_train, y_train,
        n_particles=config["N_PARTICLES"],
        config=GPConfig(changepoints=config["CHANGEPOINTS"],
                        noise=config["NOISE"],
                        max_depth=config["MAX_DEPTH"]),
        device=device)

    if config["SAVE"]:
        log_dir = make_log_dir(config, schedule, log_root)
        ds_future, y_future = extend_data(
            to_numeric(ds), config["N_FUTURE"], freq=config["FREQ"])
        callback_fn = Callbacks.make_smc_callback(
            fn_callback, model,
            ds_test=np.concatenate([to_numeric(ds_test), ds_future]),
            y_test=np.concatenate([y_test, y_future]),
            log_dir=log_dir,
            plot=config["PLOT"])
    else:
        callback_fn = None

    A.fit_smc(
        model,
        schedule=schedule,
        n_mcmc=config["N_MCMC"],
        n_hmc=config["N_HMC"],
        biased=config["BIASED"],
        shuffle=config["SHUFFLE"],
        adaptive_resampling=config["ADAPTIVE_RESAMPLING"],
        adaptive_rejuvenation=config["ADAPTIVE_REJUVENATION"],
        hmc_config={"n_exit": config["N_HMC_EXIT"]},
        verbose=config["VERBOSE"],
        check=config["CHECK"],
        callback_fn=callback_fn)

    predictions = A.predict(model, ds, quantiles=[0.025, 0.975])
    print(predictions)
    for k, w in zip(model.covariance_kernels(), model.particle_weights()):
        print(f"w={w:.4f}  {k}")
    return model


if __name__ == "__main__":
    main()
