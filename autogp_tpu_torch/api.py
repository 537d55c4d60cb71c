"""User-facing API, the SMC subset (port of autogp_tpu/api.py).

`GPModel` holds a batch of tensor-trace particles on one device (the card
unless the caller asks for the CPU) plus the data transforms; `fit_smc`
runs SMC with data annealing, parameter and noise HMC included; `predict`
returns per-particle
predictive means and quantiles in the original data space; `to_dict` /
`from_dict` use the dict format of autogp_tpu.api.to_dict (:916-993), so a
model fitted by the JAX package can be carried over and back.

Not ported yet: greedy search, MCMC-only fits, add_data/remove_data,
predict_proba/predict_mvn/predict_sum, decompose and friends, fit_smc's
callback_fn, depth annealing and the mesh.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import List, Optional, Sequence

import numpy as np
import pandas as pd
import torch

from autogp_tpu_torch import backend
from autogp_tpu_torch import config as C
from autogp_tpu_torch import gp_math
from autogp_tpu_torch import kernels as GP
from autogp_tpu_torch import model as M
from autogp_tpu_torch import transforms as TR
from autogp_tpu_torch import tree as T
from autogp_tpu_torch.config import GPConfig
from autogp_tpu_torch.inference import smc
from autogp_tpu_torch.inference.hmc import HMCConfig

# ---------------------------------------------------------------------------
# Global seeding (api.jl:34-37; autogp_tpu/api.py:38-49)
# ---------------------------------------------------------------------------

_GLOBAL = {"gen": torch.Generator().manual_seed(0),
           "rng": np.random.default_rng(0)}


def seed(s: int):
    """Set the global random seed (api.jl:34-37)."""
    _GLOBAL["gen"] = torch.Generator().manual_seed(s)
    _GLOBAL["rng"] = np.random.default_rng(s)


def _next_generator(device) -> torch.Generator:
    """A fresh generator on `device`, seeded from the global stream (the
    counterpart of splitting the global JAX key)."""
    s = int(torch.randint(0, 2 ** 62, (1,), generator=_GLOBAL["gen"]))
    g = torch.Generator(device=device)
    g.manual_seed(s)
    return g


def to_numeric(ds) -> np.ndarray:
    """Time indexes to float seconds (dates -> unix time; api.jl:47-51)."""
    a = np.asarray(ds)
    if np.issubdtype(a.dtype, np.datetime64):
        return a.astype("datetime64[ns]").astype(np.int64) / 1e9
    if a.dtype == object and len(a) and isinstance(
            a.flat[0], (_dt.date, _dt.datetime)):
        out = []
        for v in a:
            if not isinstance(v, _dt.datetime):
                v = _dt.datetime(v.year, v.month, v.day)
            out.append(v.replace(tzinfo=_dt.timezone.utc).timestamp())
        return np.asarray(out, dtype=np.float64)
    return a.astype(np.float64)


# ---------------------------------------------------------------------------
# GPModel (api.jl:83-112)
# ---------------------------------------------------------------------------

class GPModel:
    """Weighted particle collection over GP kernel structures + parameters.

    `device` defaults to "cuda": without a card that raises, and nothing
    falls back to the CPU; pass device="cpu" for the plain versions.
    `dtype` defaults to float32 on CUDA (the kernels' type) and float64
    on the CPU (the parity type)."""

    def __init__(self, ds, y, n_particles: int = 8,
                 config: Optional[GPConfig] = None, *, device="cuda",
                 dtype: Optional[torch.dtype] = None,
                 _defer_init: bool = False):
        self.device = backend.resolve_device(device)
        self.dtype = dtype or (torch.float32 if self.device.type == "cuda"
                               else torch.float64)
        self.config = config or GPConfig()
        self.tables = M.prior_tables(self.config, self.device, self.dtype)
        self.ds = np.asarray(ds)
        self.y = np.asarray(y, dtype=np.float64)
        self.ds_transform = TR.LinearTransform.from_minmax(
            to_numeric(self.ds), 0, 1)
        self.y_transform = TR.LinearTransform.from_mean_width(self.y, 1)
        self.round_stats: List[dict] = []   # per-round totals of fit_smc
        if not _defer_init:
            self.particles = smc.initialize(
                _next_generator(self.device), n_particles, self._dataset(),
                self.config, self.tables)

    @classmethod
    def _from_state(cls, particles: smc.Particles, config: GPConfig, ds, y,
                    ds_transform, y_transform) -> "GPModel":
        """A model over (ds, y) holding `particles` as they are, with the
        given transforms (the intermediate models of callbacks.py)."""
        m = cls(ds, y, n_particles=particles.n_particles, config=config,
                device=particles.params.device, dtype=particles.params.dtype,
                _defer_init=True)
        m.ds_transform, m.y_transform = ds_transform, y_transform
        m.particles = particles
        return m

    @property
    def particles(self) -> smc.Particles:
        return self._particles

    @particles.setter
    def particles(self, p: smc.Particles):
        # Every state change flows through here: drop the cached factor.
        self._particles = p
        self._train_factor_cache = None

    def _train_factor(self):
        """Per-particle (L, alpha) of the training block, cached until the
        next state change (autogp_tpu/api.py:145-164)."""
        if self._train_factor_cache is None:
            data = self._dataset()
            p = self.particles
            params_t = M.transform_params(p.node_type, p.params, self.tables)
            noise = M.transform_noise(p.noise_z, self.config)
            self._train_factor_cache = gp_math.train_cholesky_masked(
                p.node_type, params_t, noise, data.ts, data.xs, data.mask,
                self.tables.depth_cap)
        return self._train_factor_cache

    def _ds_numeric(self, ds=None) -> np.ndarray:
        return self.ds_transform.apply(to_numeric(self.ds if ds is None
                                                  else np.asarray(ds)))

    def _y_numeric(self) -> np.ndarray:
        return self.y_transform.apply(self.y)

    def _dataset(self) -> smc.Dataset:
        return smc.make_dataset(self._ds_numeric(), self._y_numeric(),
                                dtype=self.dtype, device=self.device)

    def __repr__(self):
        return (f"GPModel(n_particles={self.num_particles}, "
                f"n={len(self.ds)}, device={self.device})")

    # -- accessors (api.jl:114-171) ----------------------------------------

    @property
    def num_particles(self) -> int:
        return self.particles.n_particles

    def particle_weights(self) -> np.ndarray:
        return smc.normalized_weights(
            self.particles.log_weights).cpu().numpy().astype(np.float64)

    def effective_sample_size(self) -> float:
        return float(smc.effective_sample_size(self.particles.log_weights))

    def log_marginal_likelihood_estimate(self) -> float:
        return float(self.particles.log_ml_est)

    def covariance_kernels(self, reparameterize: bool = True
                           ) -> List[GP.Node]:
        nts = self.particles.node_type.cpu().numpy()
        pzs = self.particles.params.cpu().numpy().astype(np.float64)
        ks = [T.tensor_to_node(nts[i], pzs[i], self.config)
              for i in range(self.num_particles)]
        if reparameterize:
            y_inv = self.y_transform.invert()
            ks = [GP.rescale(GP.reparameterize(k, self.ds_transform), y_inv)
                  for k in ks]
        return ks

    def observation_noise_variances(self, reparameterize: bool = True
                                    ) -> np.ndarray:
        nz = self.particles.noise_z.cpu().numpy().astype(np.float64)
        p = self.config.prior["wildcard"]
        noises = np.exp(p["mu"] + p["sigma"] * nz) + C.MODEL_JITTER
        if reparameterize:
            noises = self.y_transform.unapply_var(noises)
        return noises


def particle_weights(model: GPModel):
    return model.particle_weights()


def effective_sample_size(model: GPModel):
    return model.effective_sample_size()


def log_marginal_likelihood_estimate(model: GPModel):
    return model.log_marginal_likelihood_estimate()


def covariance_kernels(model: GPModel, reparameterize: bool = True):
    return model.covariance_kernels(reparameterize=reparameterize)


def observation_noise_variances(model: GPModel, reparameterize: bool = True):
    return model.observation_noise_variances(reparameterize=reparameterize)


# ---------------------------------------------------------------------------
# fit_smc (api.jl:212-249)
# ---------------------------------------------------------------------------

def _hmc_config(hmc_config, default_n_exit) -> HMCConfig:
    """HMCConfig from None, a dict of its fields, or an HMCConfig
    (autogp_tpu/api.py:263-270)."""
    if isinstance(hmc_config, HMCConfig):
        return hmc_config
    d = dict(hmc_config or {})
    return HMCConfig(
        L_param=d.get("L_param", 10), eps_param=d.get("eps_param", 0.02),
        L_noise=d.get("L_noise", 10), eps_noise=d.get("eps_noise", 0.02),
        n_exit=d.get("n_exit", default_n_exit))


def fit_smc(model: GPModel, schedule: Sequence[int], n_mcmc, n_hmc,
            biased: bool = False, shuffle: bool = True,
            adaptive_resampling: bool = True,
            adaptive_rejuvenation: bool = False, hmc_config=None,
            verbose: bool = False, check: bool = False):
    """SMC structure learning with data annealing (api.jl:212-249). After
    every MH step the particles that accepted it get n_hmc sweeps of
    parameter and noise HMC (`hmc_config`: L_param, eps_param, L_noise,
    eps_noise, n_exit; n_exit defaults to 1). Per-round totals (MH and
    HMC acceptances, HMC sweeps) are left in `model.round_stats`."""
    n = len(model.ds)
    model.round_stats = []
    perm = _GLOBAL["rng"].permutation(n) if shuffle else np.arange(n)
    model.particles = smc.run_smc_anneal_data(
        _next_generator(model.device), model._ds_numeric(),
        model._y_numeric(), model.config, model.tables, model.num_particles,
        list(schedule), n_mcmc, n_hmc, dtype=model.dtype,
        device=model.device, biased=biased,
        hmc_cfg=_hmc_config(hmc_config, default_n_exit=1), permutation=perm,
        adaptive_resampling=adaptive_resampling,
        adaptive_rejuvenation=adaptive_rejuvenation, verbose=verbose,
        check=check, round_stats=model.round_stats)
    return model


# ---------------------------------------------------------------------------
# predict (api.jl:633-661; autogp_tpu/api.py:531-587)
# ---------------------------------------------------------------------------

def _posterior_summary_all(model: GPModel, ds_pred,
                           noise_pred: Optional[float]):
    """Per-particle posterior marginals (mu, std) at ds_pred, model space,
    as float64 numpy [P, p]."""
    data = model._dataset()
    p = model.particles
    tsp = torch.as_tensor(model._ds_numeric(ds_pred), dtype=model.dtype,
                          device=model.device)
    L, alpha = model._train_factor()
    params_t = M.transform_params(p.node_type, p.params, model.tables)
    np_eff = (M.transform_noise(p.noise_z, model.config)
              if noise_pred is None
              else torch.full_like(p.noise_z, float(noise_pred)))
    mus, stds = gp_math.posterior_marginals_from_factor(
        p.node_type, params_t, L, alpha, data.mask, data.ts, tsp, np_eff,
        model.tables.depth_cap)
    return (mus.cpu().numpy().astype(np.float64),
            stds.cpu().numpy().astype(np.float64))


def predict(model: GPModel, ds, quantiles: Sequence[float] = (),
            noise_pred: Optional[float] = None) -> pd.DataFrame:
    """Per-particle predictive means and marginal quantiles, in the
    original data space (api.jl:633-661)."""
    from scipy.stats import norm as _norm

    quantiles = list(quantiles)
    if not all(0 <= q <= 1 for q in quantiles):
        raise ValueError("Quantiles must be in [0,1]")
    mus, stds = _posterior_summary_all(model, ds, noise_pred)
    weights = model.particle_weights()
    frames = []
    nq = len(ds)
    for i in range(model.num_particles):
        rec = {
            "ds": np.asarray(ds),
            "particle": np.full(nq, i + 1),
            "weight": np.full(nq, weights[i]),
            "y_mean": model.y_transform.unapply(mus[i]),
        }
        for q in quantiles:
            rec[f"y_{q}"] = model.y_transform.unapply(
                _norm.ppf(q, loc=mus[i], scale=stds[i]))
        frames.append(pd.DataFrame(rec))
    return pd.concat(frames, ignore_index=True)


# ---------------------------------------------------------------------------
# Serialization (api.jl:1038-1112; autogp_tpu/api.py:916-993)
# ---------------------------------------------------------------------------

def particles_from_numpy(node_type, params, noise_z, log_weights, lml,
                         log_ml_est, parents, *, device,
                         dtype) -> smc.Particles:
    """Particles on `device` from numpy arrays ([P, M], [P, M, 3], [P],
    [P], [P], scalar, [P])."""
    dev = backend.resolve_device(device)
    for name, a in (("node_type", node_type), ("params", params),
                    ("noise_z", noise_z), ("log_weights", log_weights),
                    ("lml", lml), ("parents", parents)):
        if not isinstance(a, np.ndarray):
            raise TypeError(f"{name}: expected a numpy array")

    # torch.tensor copies: the arrays may be read-only views (of JAX
    # arrays, for instance), which torch must not alias.
    def f(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=dev)

    def i(a):
        return torch.tensor(np.asarray(a), dtype=torch.int64, device=dev)

    return smc.Particles(node_type=i(node_type), params=f(params),
                         noise_z=f(noise_z), log_weights=f(log_weights),
                         lml=f(lml), log_ml_est=f(log_ml_est),
                         parents=i(parents))


def to_dict(model: GPModel) -> dict:
    """Serializable dict (Base.Dict(model), api.jl:1061-1081)."""
    kernels = model.covariance_kernels(reparameterize=False)
    noises = model.observation_noise_variances(reparameterize=False)
    p = model.particles
    return {
        "pf_state": {
            "log_weights": p.log_weights.cpu().numpy().astype(
                np.float64).tolist(),
            "log_ml_est": float(p.log_ml_est),
        },
        "kernels": [_kernel_to_dict(k) for k in kernels],
        "noises": np.asarray(noises).tolist(),
        "noise_zs": p.noise_z.cpu().numpy().astype(np.float64).tolist(),
        "config": model.config.to_dict(),
        "ds": _ds_to_jsonable(model.ds),
        "y": model.y.tolist(),
        "ds_transform": model.ds_transform.to_dict(),
        "y_transform": model.y_transform.to_dict(),
    }


def from_dict(d: dict, *, device="cuda",
              dtype: Optional[torch.dtype] = None) -> GPModel:
    """Rebuild a GPModel on `device` (the card unless the caller asks for
    the CPU) from a `to_dict` dict -- this package's or autogp_tpu's
    (GPModel(::Dict), api.jl:1084-1106). The LMLs are recomputed on the
    device from the decoded particles."""
    config = GPConfig.from_dict(d["config"])
    ds = _ds_from_jsonable(d["ds"])
    y = np.asarray(d["y"], dtype=np.float64)
    m = GPModel(ds, y, n_particles=len(d["kernels"]), config=config,
                device=device, dtype=dtype, _defer_init=True)
    m.ds_transform = TR.LinearTransform.from_dict(d["ds_transform"])
    m.y_transform = TR.LinearTransform.from_dict(d["y_transform"])
    kernels = [_kernel_from_dict(k) for k in d["kernels"]]
    if "noise_zs" in d:
        noise_zs = np.asarray(d["noise_zs"], dtype=np.float64)
    else:
        noise_zs = np.array([M.untransform_param("noise", v, config)
                             for v in d["noises"]])
    P = len(kernels)
    nts = np.zeros((P, config.max_nodes), np.int64)
    pzs = np.zeros((P, config.max_nodes, C.MAX_PARAMS), np.float64)
    for i, k in enumerate(kernels):
        nts[i], pzs[i] = T.node_to_tensor(k, config)
    lw = np.asarray(d["pf_state"]["log_weights"], np.float64)
    parts = particles_from_numpy(
        nts, pzs, noise_zs, lw, np.zeros(P), np.float64(
            d["pf_state"]["log_ml_est"]), np.arange(P),
        device=m.device, dtype=m.dtype)
    m.particles = parts.replace(
        lml=smc.lml_all(parts, m._dataset(), config, m.tables))
    return m


def _kernel_to_dict(node: GP.Node) -> dict:
    out = {"type": type(node).__name__}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        out[f.name] = (_kernel_to_dict(v) if isinstance(v, GP.Node)
                       else float(v))
    return out


def _kernel_from_dict(d: dict) -> GP.Node:
    cls = getattr(GP, d["type"])
    kw = {k: (_kernel_from_dict(v) if isinstance(v, dict) else v)
          for k, v in d.items() if k != "type"}
    return cls(**kw)


def _ds_to_jsonable(ds: np.ndarray):
    if np.issubdtype(ds.dtype, np.datetime64):
        return {"kind": "datetime64",
                "values": ds.astype("datetime64[ns]").astype(
                    np.int64).tolist()}
    return {"kind": "numeric", "values": ds.astype(np.float64).tolist()}


def _ds_from_jsonable(d):
    if isinstance(d, dict):
        if d["kind"] == "datetime64":
            return np.asarray(d["values"],
                              dtype=np.int64).astype("datetime64[ns]")
        return np.asarray(d["values"], dtype=np.float64)
    return np.asarray(d)
