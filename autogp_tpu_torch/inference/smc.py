"""Sequential Monte Carlo with data annealing over a padded particle batch.

Port of autogp_tpu/inference/smc.py (reference: src/inference_smc_anneal_
data.jl). Each round reweights on the grown data prefix, resamples when the
ESS falls below the threshold, and rejuvenates with involutive structure
moves. Growing prefixes are padded to power-of-two buckets with a mask.
Particle state is a batch of tensor traces on one device:
node_type [P, M] int64, params [P, M, 3], noise_z [P], log_weights [P],
lml [P], log_ml_est [], parents [P] int64. After every MH step the
particles whose structure move was accepted get parameter and noise HMC
(inference/hmc.py).

With a `mesh` (parallel/mesh.py) every function here runs on the rank's
shard of the batch: draws through `model.draw` with the rank's
`model.Shard`, the initialization's retries and the HMC sweeps ended by
reductions over the ranks, and resampling on the gathered batch, so each
rank ends with its rows of the unsharded result.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import model as M
from autogp_tpu_torch.inference import check as check_mod
from autogp_tpu_torch.inference import hmc as hmc_mod
from autogp_tpu_torch.inference import moves
from autogp_tpu_torch.parallel import mesh as pmesh

# Finite stand-in for the cached LML of a particle whose factorization
# failed (smc.py:45-51): its weight becomes -inf while later weight
# arithmetic stays NaN-free, and an MH move away from it sees a huge ratio.
BAD_LML = -1e30


@dataclasses.dataclass(frozen=True)
class Particles:
    """Gen.ParticleFilterState analog (api.jl:83-90)."""
    node_type: torch.Tensor    # [P, M] int64
    params: torch.Tensor       # [P, M, 3]
    noise_z: torch.Tensor      # [P]
    log_weights: torch.Tensor  # [P]
    lml: torch.Tensor          # [P] cached LML for the current data mask
    log_ml_est: torch.Tensor   # [] accumulated at resampling
    parents: torch.Tensor      # [P] parents from the last resample

    @property
    def n_particles(self) -> int:
        return self.node_type.shape[0]

    def replace(self, **kw) -> "Particles":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Dataset:
    ts: torch.Tensor     # [N] padded time grid
    xs: torch.Tensor     # [N] padded observations (0 at padding)
    mask: torch.Tensor   # [N] {0,1}


def bucket_size(n: int, minimum: int = 32) -> int:
    """Pad target: next power of two >= n (smc.py:60-64)."""
    if n <= minimum:
        return minimum
    return 1 << math.ceil(math.log2(n))


def make_dataset(ts, xs, n: Optional[int] = None,
                 pad_to: Optional[int] = None, *, dtype,
                 device) -> Dataset:
    """Padded (ts, xs, mask) of the first n points, on `device`."""
    ts = np.asarray(ts, dtype=np.float64)
    xs = np.asarray(xs, dtype=np.float64)
    n = len(ts) if n is None else n
    size = pad_to if pad_to is not None else bucket_size(max(n, 1))
    tp, xp, mk = np.zeros(size), np.zeros(size), np.zeros(size)
    tp[:n] = ts[:n]
    xp[:n] = xs[:n]
    mk[:n] = 1.0

    def f(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return Dataset(f(tp), f(xp), f(mk))


def _data(d: Dataset):
    return d.ts, d.xs, d.mask


# ---------------------------------------------------------------------------
# Initialization (Gen.initialize_particle_filter, api.jl:108; smc.py:141-197)
# ---------------------------------------------------------------------------

def initialize(gen, n_particles: int, data: Dataset, cfg: C.GPConfig,
               tables: M.PriorTables, max_retries: int = 3,
               mesh=None) -> Particles:
    """Draw the initial batch from the prior. Lanes whose LML or weight is
    not finite (an ill-conditioned f32 gram) are redrawn up to
    `max_retries` times; a lane still bad gets log_weight = -inf and
    lml = BAD_LML. With a `mesh`, `n_particles` is the global P and the
    rank's shard is returned; every rank redraws while any rank has a bad
    lane (smc.py:182-190 of the JAX package)."""
    noise_c = (None if cfg.noise is None
               else M.untransform_param("noise", cfg.noise, cfg))
    ts, xs, mask = _data(data)
    rows = slice(None) if mesh is None else mesh.rows(n_particles)
    n_local = n_particles if mesh is None else n_particles // mesh.size
    shard = None if mesh is None else mesh.shard(n_local)

    def gen_batch():
        nt, pz, nz, w = M.generate(gen, n_local, ts, xs, mask, cfg,
                                   tables, noise_z_constraint=noise_c,
                                   shard=shard)
        lml = M.lml(nt, pz, nz, ts, xs, mask, cfg, tables)
        return nt, pz, nz, w, lml

    def any_bad():
        return bool(bad.any()) if mesh is None else mesh.any(bad)

    nt, pz, nz, w, lml = gen_batch()
    bad = ~(torch.isfinite(w) & torch.isfinite(lml))
    retry = 0
    while any_bad() and retry < max_retries:
        retry += 1
        nt2, pz2, nz2, w2, lml2 = gen_batch()
        nt = torch.where(bad[:, None], nt2, nt)
        pz = torch.where(bad[:, None, None], pz2, pz)
        nz = torch.where(bad, nz2, nz)
        w = torch.where(bad, w2, w)
        lml = torch.where(bad, lml2, lml)
        bad = ~(torch.isfinite(w) & torch.isfinite(lml))
    w = torch.where(bad, float("-inf"), w)
    lml = torch.where(bad, BAD_LML, lml)
    return Particles(
        node_type=nt, params=pz, noise_z=nz, log_weights=w, lml=lml,
        log_ml_est=torch.zeros((), dtype=ts.dtype, device=ts.device),
        parents=torch.arange(n_particles, device=ts.device)[rows])


def lml_all(particles: Particles, data: Dataset, cfg, tables):
    """[P] LMLs of the particles on `data`."""
    return M.lml(particles.node_type, particles.params, particles.noise_z,
                 *_data(data), cfg, tables)


# ---------------------------------------------------------------------------
# Weights / ESS (Gen.normalize_weights / effective_sample_size)
# ---------------------------------------------------------------------------

def log_normalized_weights(log_weights):
    return log_weights - torch.logsumexp(log_weights, dim=0)


def normalized_weights(log_weights):
    return torch.exp(log_normalized_weights(log_weights))


def effective_sample_size(log_weights):
    return 1.0 / torch.sum(torch.exp(2.0 * log_normalized_weights(
        log_weights)))


# ---------------------------------------------------------------------------
# Reweight, resample (smc.py:234-281)
# ---------------------------------------------------------------------------

def reweight(particles: Particles, data: Dataset, cfg, tables) -> Particles:
    """Gen.update with incremental data: weight += LML_new - LML_cached. A
    non-finite new LML sets the weight to -inf and the cached LML to the
    finite BAD_LML instead of propagating NaN."""
    lml_new = lml_all(particles, data, cfg, tables)
    ok = torch.isfinite(lml_new)
    return particles.replace(
        log_weights=torch.where(
            ok, particles.log_weights + lml_new - particles.lml,
            float("-inf")),
        lml=torch.where(ok, lml_new, BAD_LML))


def maybe_resample(gen, particles: Particles, ess_threshold, mesh=None):
    """Multinomial resampling when ESS < threshold: folds the weight
    normalizer into log_ml_est and zeroes the weights. `parents` persists
    from the LAST resample (Gen semantics; scripts/online.jl:67). Returns
    (particles, resampled bool tensor). With a `mesh` it runs on the
    gathered batch, the (P, P) Gumbel drawn whole on every rank, and
    returns the rank's rows: the ESS, the decision, the fold and the
    parents are the unsharded program's bits."""
    if mesh is not None:
        out, do = maybe_resample(gen, pmesh.gather_particles(particles, mesh),
                                 ess_threshold)
        return pmesh.shard_particles(out, mesh), do
    P = particles.n_particles
    lw = particles.log_weights
    lnw = log_normalized_weights(lw)
    ess = 1.0 / torch.sum(torch.exp(2.0 * lnw))
    do = ess < ess_threshold
    # Categorical draws by Gumbel-max (no host sync, no NaN-check raise).
    g = M.gumbel(gen, (P, P), lw.dtype, lw.device)
    parents = torch.argmax(lnw[None, :] + g, dim=1)
    keep = torch.arange(P, device=lw.device)
    sel = torch.where(do, parents, keep)
    fold = torch.logsumexp(lw, dim=0) - math.log(float(P))
    resampled = Particles(
        node_type=particles.node_type[sel],
        params=particles.params[sel],
        noise_z=particles.noise_z[sel],
        log_weights=torch.where(do, torch.zeros_like(lw), lw),
        lml=particles.lml[sel],
        log_ml_est=particles.log_ml_est + torch.where(
            do, fold, torch.zeros_like(fold)),
        parents=torch.where(do, parents, particles.parents))
    return resampled, do


# ---------------------------------------------------------------------------
# Rejuvenation (rejuvenate_particle_structure; smc.py:311-442)
# ---------------------------------------------------------------------------

def rejuvenate_structure(gen, particles: Particles, data: Dataset,
                         cfg: C.GPConfig, tables, n_mcmc: int, n_hmc: int,
                         biased: bool = False,
                         hmc_cfg: hmc_mod.HMCConfig = hmc_mod.HMCConfig(),
                         check: bool = False, hmc_compact: bool = True,
                         mesh=None):
    """n_mcmc involutive-MH steps on the whole batch; after each, the
    particles that accepted their structure move get up to n_hmc sweeps
    of parameter [+ noise] HMC (smc.py:311-442). Noise HMC runs when the
    config leaves the noise free; `hmc_compact` as in
    hmc.rejuvenate_parameters.

    With check=True every step also runs the round-trip checks on the
    post-move state (Gen.metropolis_hastings(check=true)). Returns
    (particles, n_accepted [P], n_hmc_sweeps [P], n_hmc_accepted [P]
    (parameter trajectories), check_ok [P, 4]: structural validity,
    subtree-replace, detach, attach). With a `mesh`, the rank's shard."""
    infer_noise = cfg.noise is None
    P = particles.n_particles
    shard = None if mesh is None else mesh.shard(P)
    dev = particles.noise_z.device
    d = _data(data)
    nt, pz, nz, lml = (particles.node_type, particles.params,
                       particles.noise_z, particles.lml)
    n_acc = torch.zeros((P,), dtype=torch.int64, device=dev)
    n_sweeps = torch.zeros_like(n_acc)
    n_hmc_acc = torch.zeros_like(n_acc)
    ok = torch.ones((P, 4), dtype=torch.bool, device=dev)
    for _ in range(n_mcmc):
        res = moves.tree_rejuvenation_step(gen, nt, pz, nz, lml, d, cfg,
                                           tables, biased=biased,
                                           shard=shard)
        nt, pz, lml = res.node_type, res.params, res.lml
        if check:
            valid = check_mod.trace_structurally_valid(
                nt, changepoints=cfg.changepoints)
            rts = check_mod.roundtrip_all(gen, nt, pz, tables,
                                          changepoints=cfg.changepoints,
                                          biased=biased, shard=shard)
            ok = ok & torch.cat([valid[:, None], rts], dim=1)
        if n_hmc > 0:
            pz, nz, lml, acc, sw = hmc_mod.rejuvenate_parameters(
                gen, nt, pz, nz, lml, d, cfg, tables, n_hmc, hmc_cfg,
                infer_noise, enabled=res.accepted, compact=hmc_compact,
                mesh=mesh)
            n_hmc_acc = n_hmc_acc + acc
            n_sweeps = n_sweeps + sw
        n_acc = n_acc + res.accepted.to(torch.int64)
    return (particles.replace(node_type=nt, params=pz, noise_z=nz, lml=lml),
            n_acc, n_sweeps, n_hmc_acc, ok)


def smc_round(gen, particles: Particles, data: Dataset, cfg: C.GPConfig,
              tables, n_mcmc: int, n_hmc: int, biased: bool,
              allow_resample: bool, ess_threshold: float,
              adaptive_rejuvenation: bool,
              hmc_cfg: hmc_mod.HMCConfig = hmc_mod.HMCConfig(),
              check: bool = False, hmc_compact: bool = True, mesh=None):
    """reweight -> maybe_resample -> rejuvenate (inference_smc_anneal_
    data.jl:206-253). Returns (particles, stats); with a `mesh`, the
    rank's shard and its per-particle stats, `resampled` and `ess` (the
    reweighted batch's, before resampling) global."""
    dev = particles.noise_z.device
    particles = reweight(particles, data, cfg, tables)
    ess = effective_sample_size(
        particles.log_weights if mesh is None
        else mesh.gather(particles.log_weights))
    resampled = torch.zeros((), dtype=torch.bool, device=dev)
    if allow_resample:
        particles, resampled = maybe_resample(gen, particles, ess_threshold,
                                              mesh)
    rejuvenated = (not adaptive_rejuvenation) or bool(resampled)
    P = particles.n_particles
    if rejuvenated:
        particles, n_acc, n_sweeps, n_hmc_acc, check_ok = \
            rejuvenate_structure(gen, particles, data, cfg, tables, n_mcmc,
                                 n_hmc, biased, hmc_cfg=hmc_cfg, check=check,
                                 hmc_compact=hmc_compact, mesh=mesh)
    else:
        n_acc = torch.zeros((P,), dtype=torch.int64, device=dev)
        n_sweeps = torch.zeros_like(n_acc)
        n_hmc_acc = torch.zeros_like(n_acc)
        check_ok = torch.ones((P, 4), dtype=torch.bool, device=dev)
    return particles, {"resampled": resampled, "rejuvenated": rejuvenated,
                       "ess": ess, "mh_accepted": n_acc,
                       "hmc_sweeps": n_sweeps, "hmc_accepted": n_hmc_acc,
                       "check_ok": check_ok}


# ---------------------------------------------------------------------------
# Driver (run_smc_anneal_data, :143-273)
# ---------------------------------------------------------------------------

def validate_particles(particles: Particles, cfg: C.GPConfig, tables=None,
                       gen=None, mesh=None):
    """Dynamic self-checks (the reference's check=true analog): finite
    LMLs, no NaN weights, heap invariants; with `tables`, one random
    subtree-replace, detach and attach round trip per particle (with a
    `mesh`, on the rank's shard, drawn as the unsharded batch draws)."""
    nts = particles.node_type.cpu().numpy()
    Mn = nts.shape[1]
    assert not torch.isnan(particles.log_weights).any(), "NaN log weights"
    assert torch.isfinite(particles.lml).all(), "non-finite LML"
    assert (nts[:, 0] > 0).all(), "inactive root slot"
    for s in range(1, Mn):
        par = (s - 1) // 2
        is_op = np.isin(nts[:, par], list(C.OP_CODES))
        assert ((nts[:, s] > 0) == is_op).all(), \
            f"slot {s} active without operator parent"
        bad_cp = (nts[:, s] == C.CHANGEPOINT) & (nts[:, par] != C.CHANGEPOINT)
        assert not bad_cp.any(), "ChangePoint below a non-ChangePoint"
    if tables is not None:
        if gen is None:
            gen = torch.Generator(device=particles.params.device)
            gen.manual_seed(0)
        shard = (None if mesh is None
                 else mesh.shard(particles.n_particles))
        ok = check_mod.roundtrip_all(gen, particles.node_type,
                                     particles.params, tables,
                                     changepoints=cfg.changepoints,
                                     shard=shard)
        assert ok[:, 0].all(), "subtree-replace round trip failed"
        assert ok[:, 1].all(), "detach round trip failed"
        assert ok[:, 2].all(), "attach round trip failed"


def run_smc_anneal_data(gen, ts, xs, cfg: C.GPConfig, tables,
                        n_particles: int, schedule: Sequence[int], n_mcmc,
                        n_hmc, *, dtype, device, biased: bool = False,
                        hmc_cfg: hmc_mod.HMCConfig = hmc_mod.HMCConfig(),
                        permutation: Optional[np.ndarray] = None,
                        adaptive_resampling: bool = True,
                        adaptive_rejuvenation: bool = False,
                        verbose: bool = False, check: bool = False,
                        round_stats: Optional[list] = None,
                        callback_fn: Optional[Callable] = None,
                        hmc_compact: bool = True, mesh=None) -> Particles:
    """Anneal over data prefixes ts[perm][:step] for step in schedule.
    With a list `round_stats`, one dict of totals per round is appended
    to it: step, resampled, ess (before resampling), mh_accepted,
    hmc_sweeps, hmc_accepted.
    `callback_fn` is called after the initialization (step 0) and after
    every round with the keywords particles, ts, xs (permuted), permutation,
    schedule, step, elapsed (seconds of SMC work so far, the callback's own
    time left out), rejuvenated, resampled, verbose (smc.py:671-675,
    723-729).

    With a `mesh` (smc.py:626-697 of the JAX package) the batch lives
    sharded for the whole run and the rank's shard is returned;
    `round_stats` hold the sums over the ranks, the callback gets the
    gathered particles and rank 0 prints the verbose lines."""
    n = len(ts)
    ts = np.asarray(ts, np.float64)
    xs = np.asarray(xs, np.float64)
    if permutation is None:
        permutation = np.arange(n)
    if sorted(np.asarray(permutation).tolist()) != list(range(n)):
        raise ValueError("permutation must be a permutation of range(n)")
    ts = ts[permutation]
    xs = xs[permutation]
    schedule = list(schedule)
    if not (1 <= schedule[0] and schedule[-1] == n
            and all(b > a for a, b in zip(schedule, schedule[1:]))):
        raise ValueError(f"schedule must increase from >= 1 to n={n}")
    n_mcmc = ([n_mcmc] * len(schedule) if np.isscalar(n_mcmc)
              else list(n_mcmc))
    n_hmc = [n_hmc] * len(schedule) if np.isscalar(n_hmc) else list(n_hmc)
    if len(n_mcmc) != len(schedule) or len(n_hmc) != len(schedule):
        raise ValueError("n_mcmc / n_hmc lists must match the schedule")

    def clock():
        # Elapsed times count finished device work, as the reference's
        # block_until_ready does.
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        return time.time()

    def gathered(p):
        return p if mesh is None else pmesh.gather_particles(p, mesh)

    def total(x):
        return int(x.sum() if mesh is None else mesh.sum(x.sum()))

    def call_back(step, rejuvenated, resampled):
        callback_fn(particles=gathered(particles), ts=ts, xs=xs,
                    permutation=permutation, schedule=schedule, step=step,
                    elapsed=elapsed, rejuvenated=rejuvenated,
                    resampled=resampled, verbose=verbose)

    # Initialize from the prior on empty data (:180-190).
    t0 = clock()
    data0 = make_dataset(ts, xs, n=0, pad_to=bucket_size(1), dtype=dtype,
                         device=device)
    particles = initialize(gen, n_particles, data0, cfg, tables,
                           mesh=mesh)
    elapsed = clock() - t0
    if callback_fn is not None:
        call_back(0, False, False)
    for i, step in enumerate(schedule):
        t0 = clock()
        data = make_dataset(ts, xs, n=step, pad_to=bucket_size(step),
                            dtype=dtype, device=device)
        ess_threshold = (n_particles / 2 if adaptive_resampling
                         else float(n_particles))
        particles, stats = smc_round(
            gen, particles, data, cfg, tables, int(n_mcmc[i]),
            int(n_hmc[i]), biased, step < schedule[-1], ess_threshold,
            adaptive_rejuvenation, hmc_cfg=hmc_cfg, check=check,
            hmc_compact=hmc_compact, mesh=mesh)
        dt_round = clock() - t0
        elapsed += dt_round
        if round_stats is not None:
            round_stats.append({
                "step": step, "resampled": bool(stats["resampled"]),
                "ess": float(stats["ess"]),
                **{k: total(stats[k]) for k in (
                    "mh_accepted", "hmc_sweeps", "hmc_accepted")}})
        if verbose:
            lw = gathered(particles).log_weights
            acc, sweeps = (total(stats[k]) for k in ("mh_accepted",
                                                     "hmc_sweeps"))
        if verbose and (mesh is None or mesh.rank == 0):
            w = normalized_weights(lw).cpu().numpy()
            ess = float(effective_sample_size(lw))
            print(f"SMC round {step}/{schedule[-1]} ({dt_round:.3f} s)")
            print("Particle Weights:", np.array2string(w, precision=3))
            print(f"Particle ESS: {ess / n_particles}")
            print(f"resampled {bool(stats['resampled'])}")
            print(f"accepted MCMC[{acc}/{n_particles * n_mcmc[i]}]")
            print(f"HMC sweeps {sweeps}")
        if check:
            ok = stats["check_ok"]
            assert ok[:, 0].all(), "per-move structural trace validity"
            assert ok[:, 1].all(), "per-move subtree-replace round trip"
            assert ok[:, 2].all(), "per-move detach round trip"
            assert ok[:, 3].all(), "per-move attach round trip"
            validate_particles(particles, cfg, tables=tables, gen=gen,
                               mesh=mesh)
        if callback_fn is not None:
            call_back(step, stats["rejuvenated"], bool(stats["resampled"]))
    return particles
