"""Hamiltonian Monte Carlo on whitened kernel parameters and noise, batched.

Port of autogp_tpu/inference/hmc.py (reference: inference_smc_anneal_data.
jl:33-76): per rejuvenation sweep, one HMC trajectory over all numeric
tree parameters, then one over the noise, with an early exit after
`n_exit` consecutive rejections of the parameter kernel. The target is
the joint score; the parameter gradient comes from autograd through
`model.lml`, which then routes through `cov_vjp.LmlTapeFused` (kinv and
tape-backward kernels), and the noise gradient from the closed form of
`model.lml_value_and_noise_grad_from_K0`.

Every function takes the particle axis first. Each step is a
deterministic trajectory function of its momenta and acceptance uniforms
(`params_trajectory`, `noise_trajectory`, in the leapfrog arithmetic
order of hmc.py:69-93) and a thin sampler around it. The samplers draw for
the whole batch (`n_lanes`) and keep the rows of the particles that run
(`lanes`), so a particle's trajectory does not depend on which others run
beside it: `rejuvenate_parameters` gathers the live particles before each
sweep and scatters them back, with no chunk width to choose. Under a
particle mesh (parallel/mesh.py) the batch is the global P and the rows
sit at the rank's offset, and the sweeps end when no rank has a live
particle. Each sweep's gradients take the partition of the batch the
unsharded program runs (its live particles over all ranks, or all P
without compaction: `part_batch` of model.lml), so a particle's
trajectory is the same bits in any shard.

A trajectory's L + 1 leapfrogs run one body on buffers of the
trajectory. Its shapes, tree and step stay fixed from leapfrog 1 on, so
on the card a trajectory on heaps that bound their own tapes, in a
bucket of the closed-form gradient (`_use_graph`), captures leapfrog 1
as a CUDA graph and replays it L times: one eager leapfrog and one
capture of host work in place of L + 1, the same launches and bits.
Spans: `hmc.leapfrog` around each leapfrog, with `hmc.capture` and
`hmc.replay` inside it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import gp_math
from autogp_tpu_torch import model as M
from autogp_tpu_torch import tree as T
from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv
from autogp_tpu_torch.utils import trace


class HMCConfig(NamedTuple):
    """hmc_config dict of the reference (api.jl:201-206)."""
    L_param: int = 10
    eps_param: float = 0.02
    L_noise: int = 10
    eps_noise: float = 0.02
    n_exit: int = 1


def _lp_params(params_z, pmask):
    return gp_math.row_sum(M.normal_logpdf(params_z) * pmask, dim=(-2, -1))


def _accept(u0, u1, p_sq, mom_sq, u):
    """Metropolis test of a trajectory: dH finite and log u < -dH."""
    dh = (u1 - u0) + 0.5 * (p_sq - mom_sq)
    return (torch.log(u) < -dh) & torch.isfinite(dh)


def _use_graph(node_type, ts) -> bool:
    """Whether a trajectory on heaps node_type [P, M] and the time grid ts
    [N] replays its leapfrog as a CUDA graph: ts on a CUDA device, heaps
    of at most cov.SMALL_HEAP slots, whose tapes size the kernels without
    a read-back (ops/cov.py), and a bucket whose gradient takes the
    closed-form K^-1 (gp_math.use_blocked_inv). The other buckets' dense
    gradient solves with torch.cholesky_solve, whose batched MAGMA path
    allocates inside a capture and aborts the process (torch 2.11, H100).
    Elsewhere every leapfrog runs eagerly."""
    return (ts.is_cuda and node_type.shape[1] <= cov.SMALL_HEAP
            and gp_math.use_blocked_inv(ts.shape[0]))


# The ops' launch counters: each counts a replay's launches as the eager
# call's.
_COUNTERS = tuple((mod, name) for mod in (cov, chol, kinv, cov_vjp)
                  for name, v in vars(mod).items()
                  if name.endswith("launches") and isinstance(v, int))
# By device index: the side stream captures run on, the memory pool they
# share, each made once, and the last graph captured. torch lets a pool go
# with the last graph that uses it, and a capture into it then fails (torch
# 2.11, H100): the last graph, never replayed again, keeps it until the
# next capture has taken it.
_side_streams = {}
_pools = {}
_last_graphs = {}


def _capture(fn, device):
    """(graph, counts): a CUDA graph of `fn()`, captured on the device's
    side stream into its shared pool (no sync, no cache emptied), and the
    launch counts of one replay. The capture itself launches nothing, so
    the counters are left as they were."""
    i = device.index
    if i not in _side_streams:
        _side_streams[i] = torch.cuda.Stream(device)
        _pools[i] = torch.cuda.graph_pool_handle()
    side, caller = _side_streams[i], torch.cuda.current_stream(device)
    before = [getattr(mod, name) for mod, name in _COUNTERS]
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        graph.capture_begin(pool=_pools[i])
        try:
            fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass            # the capture fn broke: its error is raised
            raise
        graph.capture_end()
    caller.wait_stream(side)
    _last_graphs[i] = graph
    counts = []
    for (mod, name), n in zip(_COUNTERS, before):
        counts.append(getattr(mod, name) - n)
        setattr(mod, name, n)
    return graph, counts


def _leapfrogs(leapfrog, u, eps: float, L: int, graphed: bool):
    """Run `leapfrog(e)`, which updates its trajectory's buffers in place
    and writes the energy into `u`, once with e = 0 and then L times with
    e = eps; return the energy after the first (the initial U). Graphed,
    the L leapfrogs are L replays of one CUDA graph of `leapfrog(eps)`,
    captured in the first of them and never replayed after; each replay
    is the eager leapfrog's launches on the same buffers, bit for bit."""
    with trace.span("hmc.leapfrog"):
        leapfrog(0.0)
    u0 = u.clone()
    graph = None
    for _ in range(L):
        with trace.span("hmc.leapfrog"):
            if not graphed:
                leapfrog(eps)
                continue
            if graph is None:
                with trace.span("hmc.capture"):
                    graph, counts = _capture(lambda: leapfrog(eps),
                                             u.device)
            with trace.span("hmc.replay"):
                graph.replay()
            for (mod, name), n in zip(_COUNTERS, counts):
                setattr(mod, name, getattr(mod, name) + n)
    return u0


def params_trajectory(node_type, params_z, noise_z, lml_cached, data,
                      cfg: C.GPConfig, tables, eps: float, L: int, mom0, u,
                      part_batch=None):
    """One HMC trajectory over the tree parameters (noise fixed) from
    momenta mom0 [P, M, 3] (zero off the active slots) and uniforms u [P].
    Returns (params_z, lml, accepted), the old values where rejected.
    `part_batch`: as in model.lml.

    Iteration 0 runs the leapfrog body with step 0, which reduces it to
    the initial U and gradient at q0; the last iteration's U is the
    endpoint energy (hmc.py:69-93). Each leapfrog gives the gradient
    call a fresh q and keeps q, p, the gradient, U and the LML in
    buffers of the trajectory, so that on the card (`_use_graph`) the
    last L leapfrogs replay one CUDA graph."""
    ts, xs, mask = data

    def value_and_grad(q):
        with torch.enable_grad():
            q = q.detach().requires_grad_(True)
            lml = M.lml(node_type, q, noise_z, ts, xs, mask, cfg, tables,
                        part_batch=part_batch)
            u_q = -(_lp_params(q, pmask) + M.normal_logpdf(noise_z) + lml)
            with trace.span("model.lml_grad"):
                (g,) = torch.autograd.grad(u_q.sum(), q)
        return u_q.detach(), lml.detach(), g * pmask

    def leapfrog(e):
        p.sub_(0.5 * e * g)
        q_new = q + e * p * pmask
        for buf, v in zip((q, u_q, lml, g),
                          (q_new, *value_and_grad(q_new))):
            buf.copy_(v)
        p.sub_(0.5 * e * g)

    with trace.span("hmc.params_trajectory"):
        pmask = T.param_mask(node_type).to(params_z.dtype)
        q, p = params_z.clone(), mom0.clone()
        g = torch.zeros_like(params_z)
        u_q, lml = torch.empty_like(lml_cached), torch.empty_like(lml_cached)
        u0 = _leapfrogs(leapfrog, u_q, eps, L, _use_graph(node_type, ts))
        accept = _accept(u0, u_q, gp_math.row_sum(p * p, dim=(-2, -1)),
                         gp_math.row_sum(mom0 * mom0, dim=(-2, -1)), u)
        return (torch.where(accept[:, None, None], q, params_z),
                torch.where(accept, lml, lml_cached), accept)


def noise_trajectory(node_type, params_z, noise_z, lml_cached, data,
                     cfg: C.GPConfig, tables, eps: float, L: int, mom0, u,
                     part_batch=None):
    """One HMC trajectory on the noise (params fixed) from momenta mom0
    [P] and uniforms u [P]. Returns (noise_z, lml, accepted).
    `part_batch`: as in model.lml (the buckets without the closed form).

    For power-of-two buckets >= 64 the noise-free gram K0 is assembled
    once and every leapfrog pays the factorization and the kinv
    statistics only (hmc.py:96-156). The leapfrogs keep their state as
    `params_trajectory`'s do, and replay one CUDA graph on the card."""
    ts, xs, mask = data
    use_k0 = gp_math.use_blocked_inv(ts.shape[0])

    def value_and_grad(nz):
        if use_k0:
            lml, glml = M.lml_value_and_noise_grad_from_K0(K0, nz, xs,
                                                           mask, cfg)
        else:
            lml, glml = M.lml_value_and_noise_grad(
                node_type, params_z, nz, ts, xs, mask, cfg, tables,
                part_batch=part_batch)
        u_q = -(lp_params + M.normal_logpdf(nz) + lml)
        return u_q, lml, -(-nz + glml)

    def leapfrog(e):
        p.sub_(0.5 * e * g)
        q_new = q + e * p
        for buf, v in zip((q, u_q, lml, g),
                          (q_new, *value_and_grad(q_new))):
            buf.copy_(v)
        p.sub_(0.5 * e * g)

    with trace.span("hmc.noise_trajectory"):
        pmask = T.param_mask(node_type).to(params_z.dtype)
        lp_params = _lp_params(params_z, pmask)
        K0 = (M.assemble_K0(node_type, params_z, ts, mask, cfg, tables)
              if use_k0 else None)
        q, p = noise_z.clone(), mom0.clone()
        g = torch.zeros_like(noise_z)
        u_q, lml = torch.empty_like(lml_cached), torch.empty_like(lml_cached)
        u0 = _leapfrogs(leapfrog, u_q, eps, L, _use_graph(node_type, ts))
        accept = _accept(u0, u_q, p * p, mom0 * mom0, u)
        return (torch.where(accept, q, noise_z),
                torch.where(accept, lml, lml_cached), accept)


def hmc_params_step(gen, node_type, params_z, noise_z, lml_cached, data,
                    cfg: C.GPConfig, tables, eps: float, L: int,
                    lanes: torch.Tensor, n_lanes: int, part_batch=None):
    """Draw momenta and uniforms for an `n_lanes`-wide batch, keep the
    rows `lanes` (this batch's particles) and run `params_trajectory`
    (with `part_batch`). With no lane, only the draws are made."""
    dt, dev = params_z.dtype, params_z.device
    pmask = T.param_mask(node_type).to(dt)
    mom0 = torch.randn((n_lanes,) + tuple(params_z.shape[1:]), generator=gen,
                       dtype=dt, device=dev)[lanes] * pmask
    u = torch.rand((n_lanes,), generator=gen, dtype=dt, device=dev)[lanes]
    if lanes.numel() == 0:
        return params_z, lml_cached, torch.zeros_like(lanes, dtype=torch.bool)
    return params_trajectory(node_type, params_z, noise_z, lml_cached, data,
                             cfg, tables, eps, L, mom0, u, part_batch)


def hmc_noise_step(gen, node_type, params_z, noise_z, lml_cached, data,
                   cfg: C.GPConfig, tables, eps: float, L: int,
                   lanes: torch.Tensor, n_lanes: int, part_batch=None):
    """Draw momenta and uniforms as `hmc_params_step` does and run
    `noise_trajectory`."""
    dt, dev = noise_z.dtype, noise_z.device
    mom0 = torch.randn((n_lanes,), generator=gen, dtype=dt,
                       device=dev)[lanes]
    u = torch.rand((n_lanes,), generator=gen, dtype=dt, device=dev)[lanes]
    if lanes.numel() == 0:
        return noise_z, lml_cached, torch.zeros_like(lanes, dtype=torch.bool)
    return noise_trajectory(node_type, params_z, noise_z, lml_cached, data,
                            cfg, tables, eps, L, mom0, u, part_batch)


def rejuvenate_parameters(gen, node_type, params_z, noise_z, lml_cached,
                          data, cfg: C.GPConfig, tables, n_hmc: int,
                          hmc: HMCConfig, infer_noise: bool, enabled=None,
                          compact: bool = True, mesh=None):
    """Up to n_hmc sweeps of (parameter HMC [+ noise HMC]) per particle,
    each stopping after `n_exit` consecutive parameter rejections
    (hmc.py:159-211). `enabled` [P] bool restricts the sweeps to some
    particles (the MH-accepted ones; default all). Returns (params_z,
    noise_z, lml, n_accept [P], n_sweeps [P]).

    With `compact`, each sweep gathers the live particles, runs both steps
    on them only (their draws are rows of P-wide draws) and scatters the
    results back; without it, each sweep runs on all P particles and
    keeps the live ones' results (the reference's hmc_compact=False). The
    loop ends when none is live: with a `mesh` (parallel/mesh.py), when
    none is live on any rank, a rank without one still making the
    sweep's draws."""
    P = node_type.shape[0]
    dev = params_z.device
    shard = M.Shard(0, P) if mesh is None else mesh.shard(P)
    alive = (torch.ones((P,), dtype=torch.bool, device=dev) if enabled is None
             else enabled.clone())
    n_reject = torch.zeros((P,), dtype=torch.int64, device=dev)
    n_accept = torch.zeros_like(n_reject)
    n_sweeps = torch.zeros_like(n_reject)
    params_z, noise_z, lml = params_z.clone(), noise_z.clone(), \
        lml_cached.clone()
    for _ in range(n_hmc):
        with trace.span("hmc.sweep"):
            with trace.sync("hmc.live"):
                idx = torch.nonzero(alive).flatten()
                # The unsharded sweep's batch: the live particles of every
                # rank.
                n_live = (idx.numel() if mesh is None
                          else int(mesh.sum(torch.tensor(idx.numel()))))
            if n_live == 0:
                break
            if not compact:
                idx = torch.arange(P, device=dev)
                n_live = shard.total
            nt_i = node_type[idx]
            pz_i, lml_i, acc_i = hmc_params_step(
                gen, nt_i, params_z[idx], noise_z[idx], lml[idx], data, cfg,
                tables, hmc.eps_param, hmc.L_param, idx + shard.offset,
                shard.total, part_batch=n_live)
            nz_i = noise_z[idx]
            if infer_noise:
                nz_i, lml_i, _ = hmc_noise_step(
                    gen, nt_i, pz_i, nz_i, lml_i, data, cfg, tables,
                    hmc.eps_noise, hmc.L_noise, idx + shard.offset,
                    shard.total, part_batch=n_live)
            if compact:
                params_z[idx] = pz_i
                noise_z[idx] = nz_i
                lml[idx] = lml_i
                acc = torch.zeros_like(alive)
                acc[idx] = acc_i
            else:
                params_z = torch.where(alive[:, None, None], pz_i, params_z)
                noise_z = torch.where(alive, nz_i, noise_z)
                lml = torch.where(alive, lml_i, lml)
                acc = acc_i & alive
            n_accept += acc.to(torch.int64)
            n_sweeps += alive.to(torch.int64)
            n_reject = torch.where(acc, 0, n_reject + alive.to(torch.int64))
            alive = alive & (n_reject < hmc.n_exit)
    return params_z, noise_z, lml, n_accept, n_sweeps
