"""User-facing API: SMC, MCMC and streaming (port of autogp_tpu/api.py).

`GPModel` holds a batch of tensor-trace particles on one device (the card
unless the caller asks for the CPU) plus the data transforms; `fit_smc`
runs SMC with data annealing, parameter and noise HMC included, with an
optional per-round callback; `mcmc_structure`, `fit_mcmc` and
`mcmc_parameters` rejuvenate the particles on the data they hold;
`add_data`, `remove_data` and `maybe_resample` are the streaming entry
points; `predict` returns per-particle predictive means and quantiles in
the original data space, `predict_mvn` the mixture with full covariances,
`predict_quantile` the mixture's marginal quantiles and `predict_proba`
the per-particle log density of held-out values; `to_dict` / `from_dict`
use the dict format of autogp_tpu.api.to_dict (:916-993), so a model
fitted by the JAX package can be carried over and back.

`fit_greedy` and `fit_greedy_mcmc` are the greedy AIC engines
(inference/greedy.py); `decompose`, `extract_kernel`, `split_kernel_sop`
and `gp_model_from_kernels` rebuild models from edited kernels, and
`predict_mvn_sum` / `predict_sum` split a prediction into its
sum-of-products components (GP-sum posterior, kernel 1 on the components).

Depth-annealed SMC is `inference.smc_depth.run_smc_anneal_depth`, called
directly as in the JAX package.

`GPModel(..., mesh=m)` shards the particles over the ranks of a
torch.distributed group (parallel/mesh.py, autogp_tpu/api.py:82-186):
`model.particles` holds the rank's rows on the mesh's device, and
`fit_smc`, the MCMC fits and the streaming entry points run on them,
each rank ending with its rows of the unsharded result when every rank
has called `seed` with the same value. The accessors, the predict family
and `to_dict` gather the batch and run the unsharded code, so every rank
gets the unsharded answer. Every rank must make the same calls in the
same order: they hold collectives.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import time
from typing import Callable, List, Optional, Sequence, Tuple, Type

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
from autogp_tpu_torch.distributions import (MixtureMvNormal, MvNormal,
                                            mixture_marginal_quantile)
from autogp_tpu_torch.inference import hmc as hmc_mod
from autogp_tpu_torch.inference import smc
from autogp_tpu_torch.inference.hmc import HMCConfig
from autogp_tpu_torch.parallel import mesh as pmesh

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

def _normalize_mesh(mesh, device) -> Optional[pmesh.ParticleMesh]:
    """GPModel's `mesh` argument as a ParticleMesh (autogp_tpu/api.py:
    82-92): None; a ParticleMesh, whose device the model takes; or an int
    that must equal the default group's world size, the mesh then on
    `device` (default "cuda")."""
    if mesh is None:
        return None
    if isinstance(mesh, pmesh.ParticleMesh):
        if device is not None:
            raise ValueError("with a ParticleMesh, pass the device to "
                             "particle_mesh, not to GPModel")
        return mesh
    m = pmesh.particle_mesh(device="cuda" if device is None else device)
    if mesh != m.size:
        raise ValueError(f"mesh={mesh} but the process group has {m.size} "
                         f"ranks")
    return m


class GPModel:
    """Weighted particle collection over GP kernel structures + parameters.

    `device` defaults to "cuda": without a card that raises, and nothing
    falls back to the CPU; pass device="cpu" for the plain versions.
    `dtype` defaults to float32 on CUDA (the kernels' type) and float64
    on the CPU (the parity type).

    `mesh` (optional): a `parallel.mesh.ParticleMesh` over the ranks of
    an initialized torch.distributed group, or an int equal to the
    default group's world size. `particles` then holds this rank's
    n_particles / size rows on the mesh's device, and results equal the
    unsharded program's; an n_particles the size does not divide raises
    ValueError."""

    def __init__(self, ds, y, n_particles: int = 8,
                 config: Optional[GPConfig] = None, *, device=None,
                 dtype: Optional[torch.dtype] = None, mesh=None,
                 _defer_init: bool = False):
        self.mesh = _normalize_mesh(mesh, device)
        if self.mesh is not None:
            self.mesh.rows(n_particles)   # raises unless size divides P
            self.device = self.mesh.device
        else:
            self.device = backend.resolve_device(device or "cuda")
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
                self.config, self.tables, mesh=self.mesh)

    @classmethod
    def _from_state(cls, particles: smc.Particles, config: GPConfig, ds, y,
                    ds_transform, y_transform, mesh=None) -> "GPModel":
        """A model over (ds, y) holding the whole batch `particles` as they
        are (the intermediate models of callbacks.py), with the given
        transforms; with a ParticleMesh, this rank's rows of them."""
        m = cls.__new__(cls)   # no transforms fitted: ds may be empty
        m.mesh = mesh
        m.device = particles.params.device if mesh is None else mesh.device
        m.dtype = particles.params.dtype
        m.config = config
        m.tables = M.prior_tables(config, m.device, m.dtype)
        m.ds = np.asarray(ds)
        m.y = np.asarray(y, dtype=np.float64)
        m.ds_transform, m.y_transform = ds_transform, y_transform
        m.round_stats = []
        m.particles = (particles if mesh is None
                       else pmesh.shard_particles(particles, mesh))
        return m

    @property
    def particles(self) -> smc.Particles:
        return self._particles

    @particles.setter
    def particles(self, p: smc.Particles):
        # Every state change flows through here: drop the cached factor
        # and the cached gather.
        self._particles = p
        self._train_factor_cache = None
        self._all_cache = None

    def _all(self) -> smc.Particles:
        """The whole batch: the particles, or under a mesh their gather
        from every rank (a collective), cached until the next state
        change."""
        if self.mesh is None:
            return self.particles
        if self._all_cache is None:
            self._all_cache = pmesh.gather_particles(self.particles,
                                                     self.mesh)
        return self._all_cache

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """A per-particle tensor of the rank's rows, over the whole batch."""
        return x if self.mesh is None else self.mesh.gather(x)

    def _train_factor(self):
        """Per-particle (L, alpha) of the training block over the whole
        batch, cached until the next state change (autogp_tpu/api.py:
        145-164)."""
        if self._train_factor_cache is None:
            data = self._dataset()
            p = self._all()
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
        """The whole batch's P, on every rank of a mesh."""
        return self.particles.n_particles * (1 if self.mesh is None
                                             else self.mesh.size)

    def particle_weights(self) -> np.ndarray:
        return smc.normalized_weights(
            self._all().log_weights).cpu().numpy().astype(np.float64)

    def effective_sample_size(self) -> float:
        return float(smc.effective_sample_size(self._all().log_weights))

    def log_marginal_likelihood_estimate(self) -> float:
        return float(self.particles.log_ml_est)

    def covariance_kernels(self, reparameterize: bool = True
                           ) -> List[GP.Node]:
        nts = self._all().node_type.cpu().numpy()
        pzs = self._all().params.cpu().numpy().astype(np.float64)
        ks = [T.tensor_to_node(nts[i], pzs[i], self.config)
              for i in range(self.num_particles)]
        if reparameterize:
            y_inv = self.y_transform.invert()
            ks = [GP.rescale(GP.reparameterize(k, self.ds_transform), y_inv)
                  for k in ks]
        return ks

    def observation_noise_variances(self, reparameterize: bool = True
                                    ) -> np.ndarray:
        nz = self._all().noise_z.cpu().numpy().astype(np.float64)
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


def num_particles(model: GPModel):
    return model.num_particles


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
            verbose: bool = False, check: bool = False,
            callback_fn: Optional[Callable] = None,
            hmc_compact: bool = True):
    """SMC structure learning with data annealing (api.jl:212-249). After
    every MH step the particles that accepted it get n_hmc sweeps of
    parameter and noise HMC (`hmc_config`: L_param, eps_param, L_noise,
    eps_noise, n_exit; n_exit defaults to 1). Per-round totals (MH and
    HMC acceptances, HMC sweeps) are left in `model.round_stats`.
    `callback_fn` (see callbacks.make_smc_callback) is called with
    keywords at step 0 and after every round. `hmc_compact` (the
    reference's option, autogp_tpu/api.py:283) runs each HMC sweep on the
    live particles only; False runs it on all P, the live ones kept (the
    reference's chunk width P, `_hmc_chunk_width(P, False)`). Both give
    the same fit. Under a mesh the batch stays sharded for the whole run
    and `round_stats` hold the sums over the ranks; the callback gets the
    gathered particles."""
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
        check=check, round_stats=model.round_stats, callback_fn=callback_fn,
        hmc_compact=hmc_compact, mesh=model.mesh)
    return model


# ---------------------------------------------------------------------------
# fit_mcmc / mcmc_structure / mcmc_parameters (api.jl:280-420)
# ---------------------------------------------------------------------------

def mcmc_structure(model: GPModel, n_mcmc: int, n_hmc: int,
                   biased: bool = False, hmc_config=None,
                   verbose: bool = False, check: bool = False):
    """n_mcmc involutive MCMC steps on all particles, each followed by
    n_hmc HMC sweeps on the particles that accepted it (n_exit defaults
    to 2). Returns the per-particle count of accepted moves [P] (the
    whole batch under a mesh)."""
    hc = _hmc_config(hmc_config, default_n_exit=2)
    particles, n_acc, _, _, ok = smc.rejuvenate_structure(
        _next_generator(model.device), model.particles, model._dataset(),
        model.config, model.tables, n_mcmc, n_hmc, biased, hmc_cfg=hc,
        check=check, mesh=model.mesh)
    model.particles = particles
    if check:
        assert bool(model._gather(ok).all()), \
            "per-move involution round trip failed"
        smc.validate_particles(particles, model.config, tables=model.tables,
                               gen=_next_generator(model.device),
                               mesh=model.mesh)
    return model._gather(n_acc).cpu().numpy()


def fit_mcmc(model: GPModel, n_mcmc: int, n_hmc: int, biased: bool = False,
             hmc_config=None, verbose: bool = False, check: bool = False,
             callback_fn: Optional[Callable] = None):
    """Pure involutive-MCMC engine (api.jl:280-307): n_mcmc single steps;
    `callback_fn(model=, step=, elapsed=)` after each step in which some
    particle accepted a move."""
    elapsed = 0.0
    for step in range(1, n_mcmc + 1):
        t0 = time.time()
        n_acc = mcmc_structure(model, 1, n_hmc, biased=biased,
                               hmc_config=_hmc_config(hmc_config, 2),
                               verbose=verbose, check=check)
        elapsed += time.time() - t0
        if callback_fn is not None and (n_acc > 0).any():
            callback_fn(model=model, step=step, elapsed=elapsed)
    return model


def mcmc_parameters(model: GPModel, n_hmc: int, hmc_config=None,
                    verbose: bool = False, check: bool = False):
    """n_hmc HMC sweeps on all particles (api.jl:385-393; n_exit defaults
    to n_hmc). Returns the per-particle count of accepted parameter
    trajectories [P] (the whole batch under a mesh)."""
    hc = _hmc_config(hmc_config, default_n_exit=n_hmc)
    p = model.particles
    data = model._dataset()
    pz, nz, lml, n_acc, _ = hmc_mod.rejuvenate_parameters(
        _next_generator(model.device), p.node_type, p.params, p.noise_z,
        p.lml, (data.ts, data.xs, data.mask), model.config, model.tables,
        n_hmc, hc, model.config.noise is None, mesh=model.mesh)
    model.particles = p.replace(params=pz, noise_z=nz, lml=lml)
    return model._gather(n_acc).cpu().numpy()


# ---------------------------------------------------------------------------
# add_data / remove_data / maybe_resample (api.jl:426-479)
# ---------------------------------------------------------------------------

def add_data(model: GPModel, ds, y):
    """Incorporate new observations via one SMC reweight (api.jl:426-443)."""
    model.ds = np.concatenate([model.ds, np.asarray(ds)])
    model.y = np.concatenate([model.y, np.asarray(y, dtype=np.float64)])
    _reweight_current(model)
    return model


def remove_data(model: GPModel, ds):
    """Remove the observations at time points ds (api.jl:449-468)."""
    ds = np.asarray(ds)
    sel = np.isin(model.ds, ds)
    if not sel.any():
        raise ValueError(f"No such time points {ds}")
    model.ds = model.ds[~sel]
    model.y = model.y[~sel]
    _reweight_current(model)
    return model


def _reweight_current(model: GPModel):
    """Reweight the particles on the data the model holds now."""
    model.particles = smc.reweight(model.particles, model._dataset(),
                                   model.config, model.tables)


def maybe_resample(model: GPModel, ess_threshold: float) -> bool:
    """Multinomial resampling if the ESS is below `ess_threshold`
    (api.jl:472-479). Returns whether it resampled."""
    model.particles, did = smc.maybe_resample(
        _next_generator(model.device), model.particles, ess_threshold,
        model.mesh)
    return bool(did)


# ---------------------------------------------------------------------------
# predict (api.jl:633-661; autogp_tpu/api.py:531-587)
# ---------------------------------------------------------------------------

def _posterior_summary_all(model: GPModel, ds_pred,
                           noise_pred: Optional[float]):
    """Per-particle posterior marginals (mu, std) at ds_pred, model space,
    as float64 numpy [P, p]."""
    data = model._dataset()
    p = model._all()
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


def _posterior_terms(model: GPModel, ds_pred):
    """What the joint-Cholesky posteriors take: (node_type, params_t,
    noise, ts, xs, mask, ts_pred, depth_cap)."""
    data = model._dataset()
    p = model._all()
    tsp = torch.as_tensor(model._ds_numeric(ds_pred), dtype=model.dtype,
                          device=model.device)
    return (p.node_type, M.transform_params(p.node_type, p.params,
                                            model.tables),
            M.transform_noise(p.noise_z, model.config), data.ts, data.xs,
            data.mask, tsp, model.tables.depth_cap)


def predict_mvn(model: GPModel, ds, noise_pred: Optional[float] = None
                ) -> MixtureMvNormal:
    """Posterior predictive mixture in the original data space, one
    component with its full covariance per particle (api.jl:482-545)."""
    *terms, depth_cap = _posterior_terms(model, ds)
    np_pred = (None if noise_pred is None
               else torch.full_like(model._all().noise_z,
                                    float(noise_pred)))
    mus, covs = gp_math.posterior_mvn_masked(*terms, depth_cap,
                                             noise_pred=np_pred)
    mus = mus.cpu().numpy().astype(np.float64)
    covs = covs.cpu().numpy().astype(np.float64)
    comps = [MvNormal(*model.y_transform.unapply_mean_var(mus[i], covs[i]))
             for i in range(model.num_particles)]
    return MixtureMvNormal(comps, model.particle_weights())


def predict_quantile(model: GPModel, ds, q: float,
                     noise_pred: Optional[float] = None, tol: float = 1e-5,
                     max_iter: int = 10 ** 6):
    """Quantile q of the mixture's marginals at ds, by bisection of the
    mixture CDF (api.jl:547-596). Only marginal moments enter, so it runs
    on `predict`'s per-particle (mu, std) and the cached train factor."""
    if not (0 < q < 1):
        raise ValueError("Quantile must be in (0,1).")
    mus, stds = _posterior_summary_all(model, ds, noise_pred)
    mean_o, var_o = model.y_transform.unapply_mean_var(mus, stds ** 2)
    return mixture_marginal_quantile(model.particle_weights(), mean_o,
                                     np.sqrt(var_o), q, tol=tol,
                                     max_iter=max_iter)


def predict_proba(model: GPModel, ds, y) -> pd.DataFrame:
    """Predictive log density of y at ds under each particle
    (api.jl:686-699), as columns particle, weight, logp. For the affine
    y_transform the data-space density is the model-space one plus
    len(y) log|slope|, so only P scalars leave the device."""
    y = np.asarray(y, dtype=np.float64)
    n = model.num_particles
    if len(y) == 0:
        logps = np.zeros(n)
    elif isinstance(model.y_transform, TR.LinearTransform):
        ym = torch.as_tensor(model.y_transform.apply(y), dtype=model.dtype,
                             device=model.device)
        *terms, depth_cap = _posterior_terms(model, ds)
        lp = gp_math.posterior_logpdf_masked(*terms, ym, depth_cap)
        logps = (lp.cpu().numpy().astype(np.float64)
                 + len(y) * np.log(abs(model.y_transform.slope)))
    else:
        dist = predict_mvn(model, ds)
        logps = np.array([c.logpdf(y) for c in dist.components])
    return pd.DataFrame({"particle": np.arange(1, n + 1),
                         "weight": model.particle_weights(), "logp": logps})


# ---------------------------------------------------------------------------
# decomposition / kernel surgery (api.jl:731-850; autogp_tpu/api.py:662-738)
# ---------------------------------------------------------------------------

def _particles_from_kernels(kernels: List[GP.Node], noise_zs, model: GPModel,
                            config: GPConfig, log_weights=None,
                            lml_f64: bool = False) -> smc.Particles:
    """node_to_trace equivalent: a particle batch on the model's device
    from symbolic kernels with given whitened noises, LMLs computed on the
    model's data (inference_utils.jl:257-284). A Constant(0) encodes as
    z = -inf, which the transforms map to exactly 0. With `lml_f64` the
    LMLs of a model below float64 come from `model.lml_f64` on float64
    encodings, data and tables on the model's device, then take the
    model's dtype."""
    P = len(kernels)
    Mn = config.max_nodes
    nts = np.zeros((P, Mn), np.int64)
    pzs = np.zeros((P, Mn, C.MAX_PARAMS), np.float64)
    with np.errstate(divide="ignore"):
        for i, k in enumerate(kernels):
            nts[i], pzs[i] = T.node_to_tensor(k, config)
    tables = M.prior_tables(config, model.device, model.dtype)
    lw = np.zeros(P) if log_weights is None else np.asarray(log_weights)
    parts = particles_from_numpy(
        nts, pzs, np.asarray(noise_zs, np.float64), lw, np.zeros(P),
        np.float64(0.0), np.arange(P), device=model.device,
        dtype=model.dtype)
    if lml_f64 and model.dtype != torch.float64:
        f64, dev = torch.float64, model.device
        data = smc.make_dataset(model._ds_numeric(), model._y_numeric(),
                                dtype=f64, device=dev)
        lml = M.lml_f64(
            torch.as_tensor(nts, device=dev),
            torch.as_tensor(pzs, dtype=f64, device=dev),
            torch.as_tensor(np.asarray(noise_zs, np.float64), device=dev),
            data.ts, data.xs, data.mask, config,
            M.prior_tables(config, dev, f64)).to(model.dtype)
    else:
        lml = smc.lml_all(parts, model._dataset(), config, tables)
    return parts.replace(lml=lml, log_weights=(
        lml.clone() if log_weights is None else parts.log_weights))


def gp_model_from_kernels(model: GPModel, kernels: List[GP.Node],
                          config: Optional[GPConfig] = None) -> GPModel:
    """GPModel(model, kernels) rebuild (api.jl:833-850): same data,
    transforms, device and mesh, particles forced to the given kernels,
    weights copied; `config` defaults to the model's."""
    assert len(kernels) == model.num_particles
    config = model.config if config is None else config
    p = model._all()
    particles = _particles_from_kernels(
        kernels, p.noise_z.cpu().numpy().astype(np.float64), model, config,
        log_weights=p.log_weights.cpu().numpy().astype(np.float64))
    return GPModel._from_state(particles, config, model.ds, model.y,
                               model.ds_transform, model.y_transform,
                               mesh=model.mesh)


def decompose(model: GPModel) -> List[GPModel]:
    """Unroll each particle's kernel into a GPModel of its fragments, one
    particle per fragment, equal weights, near-zero observation noise
    (api.jl:731-771). Each lives on the parent's device with its
    transforms, unsharded: under a mesh every rank builds the same models
    from the gathered batch, as the JAX package does. A fragment's gram
    at noise 1e-10 is too ill-conditioned for float32 (its rounding is far
    larger than the noise), so a float32 model's fragment LMLs are
    computed in float64 (`model.lml_f64`)."""
    kernels = model.covariance_kernels(reparameterize=False)
    cfg = model.config.replace(noise=1e-10)
    nz = M.untransform_param("noise", 1e-10, cfg)
    out = []
    for k in kernels:
        frags = GP.unroll(k)
        sub = GPModel._from_state(
            _particles_from_kernels(frags, np.full(len(frags), nz), model,
                                    cfg, log_weights=np.zeros(len(frags)),
                                    lml_f64=True),
            cfg, model.ds, model.y, model.ds_transform, model.y_transform)
        out.append(sub)
    return out


def extract_kernel(model: GPModel, leaf_type: Type[GP.LeafNode],
                   retain: bool = True) -> GPModel:
    """Keep only leaves of `leaf_type` (or, with retain=False, the others)
    in every particle (api.jl:797-802); under a mesh, from the gathered
    batch, each rank keeping its rows (gp_model_from_kernels)."""
    kernels = model.covariance_kernels(reparameterize=False)
    new = [GP.extract_kernel(k, leaf_type, retain=retain) for k in kernels]
    return gp_model_from_kernels(model, new)


def split_kernel_sop(model: GPModel, leaf_type: Type[GP.LeafNode]
                     ) -> Tuple[GPModel, GPModel]:
    """Sum-of-products split of every particle by `leaf_type`
    (api.jl:824-831): (the terms with such a leaf, the rest).

    A split can be deeper than the model's depth cap (each product of sums
    adds levels), where the reference's encoding raises. Then both sides'
    sums are balanced (the same covariance, fewer levels) and the two
    models take the model's config with its depth cap raised to hold them
    (max_depth, or static_max_depth where max_depth is unbounded), which
    the kernels take at any depth (ops/cov.py TAPE_LIMITS). Under a mesh,
    from the gathered batch, each rank keeping its rows."""
    kernels = model.covariance_kernels(reparameterize=False)
    splits = [GP.split_kernel_sop(k, leaf_type) for k in kernels]
    sides = [[s[i] for s in splits] for i in (0, 1)]
    config = model.config
    depth = max(k.depth for side in sides for k in side)
    if depth > config.depth_cap:
        sides = [[_balance_sums(k) for k in side] for side in sides]
        depth = max(k.depth for side in sides for k in side)
        field = "max_depth" if config.max_depth > 0 else "static_max_depth"
        config = config.replace(**{field: max(depth, config.depth_cap)})
    return (gp_model_from_kernels(model, sides[0], config),
            gp_model_from_kernels(model, sides[1], config))


# ---------------------------------------------------------------------------
# predict_sum / predict_mvn_sum (api.jl:898-1034; autogp_tpu/api.py:741-888)
# ---------------------------------------------------------------------------

def _balance_sums(node: GP.Node) -> GP.Node:
    """Rebuild Plus chains as balanced binary trees (equal covariance:
    Plus is associative; GP.jl:358-400). split_kernel_sop emits left-heavy
    sum chains whose heap depth would explode the tensor encoding; the
    balanced form needs only ceil(log2(#terms)) extra levels."""
    if isinstance(node, GP.Plus):
        terms = []

        def flat(k):
            if isinstance(k, GP.Plus):
                flat(k.left)
                flat(k.right)
            else:
                terms.append(_balance_sums(k))

        flat(node)
        while len(terms) > 1:
            terms = [terms[i] + terms[i + 1] if i + 1 < len(terms)
                     else terms[i] for i in range(0, len(terms), 2)]
        return terms[0]
    if isinstance(node, GP.Times):
        return GP.Times(_balance_sums(node.left), _balance_sums(node.right))
    if isinstance(node, GP.ChangePoint):
        return GP.ChangePoint(_balance_sums(node.left),
                              _balance_sums(node.right), node.location,
                              node.scale)
    return node


def sum_components(model: GPModel, leaf_type: Type[GP.LeafNode]
                   ) -> List[List[GP.Node]]:
    """Per particle, the two balanced components of its sum-of-products
    split by `leaf_type`: what predict_mvn_sum conditions on."""
    return [[_balance_sums(c) for c in GP.split_kernel_sop(k, leaf_type)]
            for k in model.covariance_kernels(reparameterize=False)]


def sum_component_heaps(model: GPModel, ds, leaf_type: Type[GP.LeafNode]):
    """predict_mvn_sum's input to kernel 1: particle i's two components
    (`sum_components`) as heaps 2i and 2i + 1, encoded at the depth of the
    deepest component (Constant(0) pads as z = -inf), on the model's
    device and dtype. Returns (node_type [2P, M], transformed params
    [2P, M, 3], ds_train + ds numeric [n + p], depth cap)."""
    dev, dt = model.device, model.dtype
    splits = sum_components(model, leaf_type)
    enc_depth = max(max(c.depth for c in s) for s in splits)
    enc_cfg = model.config.replace(max_depth=int(max(enc_depth, 1)))
    Mn = enc_cfg.max_nodes
    nts = np.zeros((2 * len(splits), Mn), np.int64)
    pzs = np.zeros((2 * len(splits), Mn, C.MAX_PARAMS), np.float64)
    with np.errstate(divide="ignore"):  # Constant(0) pads -> z = -inf
        for i, s in enumerate(splits):
            for j, comp in enumerate(s):
                nts[2 * i + j], pzs[2 * i + j] = T.node_to_tensor(comp,
                                                                  enc_cfg)
    nt_t = torch.as_tensor(nts, device=dev)
    pt = M.transform_params(nt_t, torch.as_tensor(pzs, dtype=dt, device=dev),
                            M.prior_tables(enc_cfg, dev, dt))
    z = torch.as_tensor(np.concatenate([model._ds_numeric(),
                                        model._ds_numeric(ds)]),
                        dtype=dt, device=dev)
    return nt_t, pt, z, enc_cfg.depth_cap


def predict_mvn_sum(model: GPModel, ds, leaf_type: Type[GP.LeafNode],
                    noise_pred: Optional[float] = None):
    """Joint posterior over [F_T, F_nT, X] at ds per particle, through the
    GP-sum system (api.jl:978-1034). Returns (MixtureMvNormal over 3p
    dims, indexes {"F": [range of F_T, range of F_nT], "Y": range of X}).

    The components are encoded back into heaps (`sum_component_heaps`)
    and their covariance blocks over ds_train + ds come from kernel 1 in
    one launch (on the card, components deeper than 8 levels raise). The
    joint conditioning, `gp_math.infer_gp_sum_from_blocks`, runs on the
    model's device in float64 whatever the model's dtype, with the jitters
    of the blocks' dtype (`gp_math.sum_gp_jitters`). Under a mesh every
    rank conditions the gathered batch and gets the unsharded answer.
    X(T*) = F_T + F_nT + noise makes the
    joint singular up to its jitter, and in float32 the rounding of its
    factor broke mean(X) = mean(F_T) + mean(F_nT) by up to 4.2e-4
    normwise on config 4's fitted model (NVIDIA H100,
    scripts/gp_sum_jitter.py)."""
    from autogp_tpu_torch.ops import cov
    ts = model._ds_numeric()
    xs = model._y_numeric()
    n, p = len(ts), len(model._ds_numeric(ds))
    P = model.num_particles
    dev, dt = model.device, model.dtype
    noises = np.asarray(
        model.observation_noise_variances(reparameterize=False), np.float64)
    m = 2  # split_kernel_sop always yields (leaf part, remainder)
    nt_t, pt, z, depth_cap = sum_component_heaps(model, ds, leaf_type)
    ones = torch.ones_like(z)
    K = cov.cov_tape(nt_t, pt, torch.zeros(P * m, dtype=dt, device=dev), z,
                     z, ones, ones, depth_cap, gram=False)
    K = K.reshape(P, m, n + p, n + p).to(torch.float64)
    noise_preds = (noises if noise_pred is None
                   else np.full(P, noise_pred, np.float64))

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)
    mu_all, cov_all = gp_math.infer_gp_sum_from_blocks(
        K[:, :, :n, :n], K[:, :, :n, n:], K[:, :, n:, n:], f64(noises),
        f64(xs), f64(np.ones(n)), noise_pred=f64(noise_preds),
        jitter=gp_math.sum_gp_jitters(dt))
    mu_all = mu_all.cpu().numpy().astype(np.float64)
    cov_all = cov_all.cpu().numpy().astype(np.float64)

    fidx = [np.arange(j * p, (j + 1) * p) for j in range(m)]
    xidx = np.arange(m * p, (m + 1) * p)
    indexes = {"F": fidx, "Y": xidx}
    comps = []
    for i in range(P):
        mu, cv = model.y_transform.unapply_mean_var(mu_all[i], cov_all[i])
        # Correct the double-counted linear offset (api.jl:1013-1020).
        mu[fidx[0]] += (model.y_transform.intercept
                        / model.y_transform.slope)
        comps.append(MvNormal(mu, cv))
    return MixtureMvNormal(comps, model.particle_weights()), indexes


def predict_sum(model: GPModel, ds, leaf_type: Type[GP.LeafNode],
                quantiles: Sequence[float] = (),
                noise_pred: Optional[float] = None) -> pd.DataFrame:
    """predict() split by SOP components (api.jl:898-935): component 0 is
    the overall prediction, 1 the `leaf_type` part, 2 the remainder."""
    quantiles = list(quantiles)
    mixture, indexes = predict_mvn_sum(model, ds, leaf_type,
                                       noise_pred=noise_pred)
    weights = mixture.weights
    frames = []
    nq = len(ds)
    for particle in range(model.num_particles):
        mvn = mixture.components[particle]
        bounds = mvn.quantile(quantiles) if quantiles else None
        for comp, idx in enumerate([indexes["Y"]] + list(indexes["F"])):
            rec = {
                "ds": np.asarray(ds),
                "y_mean": mvn.mean[idx],
                "component": np.full(nq, comp),
                "particle": np.full(nq, particle + 1),
                "weight": np.full(nq, weights[particle]),
            }
            for j, q in enumerate(quantiles):
                rec[f"y_{q}"] = bounds[idx, j]
            frames.append(pd.DataFrame(rec))
    return pd.concat(frames, ignore_index=True)


# ---------------------------------------------------------------------------
# fit_greedy / fit_greedy_mcmc (api.jl:327-378; autogp_tpu/api.py:891-913)
# ---------------------------------------------------------------------------

def fit_greedy(model: GPModel, max_depth: Optional[int] = None,
               verbose: bool = False, check: bool = False,
               callback_fn: Optional[Callable] = None):
    """Greedy AIC structure search (inference/greedy.fit_greedy). It
    takes one particle, so under a mesh only a one-rank mesh, whose shard
    is the whole batch; a larger mesh cannot hold one particle per rank
    and raises ValueError."""
    from autogp_tpu_torch.inference import greedy
    return greedy.fit_greedy(model, max_depth=max_depth, verbose=verbose,
                             check=check, callback_fn=callback_fn)


def fit_greedy_mcmc(model: GPModel, n_mcmc: int, n_parallel: int = 1,
                    biased: bool = False, verbose: bool = False,
                    check: bool = False,
                    callback_fn: Optional[Callable] = None):
    """Hybrid greedy/MCMC chain ("Algorithm 0", Greedy.jl:59-130): n_mcmc
    AIC-monotone steps, each taking the best of `n_parallel` independent
    subtree-replace + MAP-optimize proposals. One particle, as
    fit_greedy: a mesh of more than one rank raises ValueError."""
    from autogp_tpu_torch.inference import greedy
    return greedy.fit_greedy_mcmc(model, n_mcmc, n_parallel=n_parallel,
                                  biased=biased, verbose=verbose,
                                  check=check, callback_fn=callback_fn)


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
    """Serializable dict (Base.Dict(model), api.jl:1061-1081); under a
    mesh, of the whole batch on every rank."""
    kernels = model.covariance_kernels(reparameterize=False)
    noises = model.observation_noise_variances(reparameterize=False)
    p = model._all()
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


def from_dict(d: dict, *, device=None, dtype: Optional[torch.dtype] = None,
              mesh=None) -> GPModel:
    """Rebuild a GPModel on `device` (the card unless the caller asks for
    the CPU) from a `to_dict` dict -- this package's or autogp_tpu's
    (GPModel(::Dict), api.jl:1084-1106). The LMLs are recomputed on the
    device from the decoded particles. `mesh` as in GPModel: each rank
    keeps its rows."""
    config = GPConfig.from_dict(d["config"])
    ds = _ds_from_jsonable(d["ds"])
    y = np.asarray(d["y"], dtype=np.float64)
    m = GPModel(ds, y, n_particles=len(d["kernels"]), config=config,
                device=device, dtype=dtype, mesh=mesh, _defer_init=True)
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
    parts = parts.replace(lml=smc.lml_all(parts, m._dataset(), config,
                                          m.tables))
    m.particles = (parts if m.mesh is None
                   else pmesh.shard_particles(parts, m.mesh))
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
