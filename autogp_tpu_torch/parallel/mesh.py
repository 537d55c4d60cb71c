"""Particle-axis data parallelism over torch.distributed ranks.

Port of autogp_tpu/parallel/mesh.py. The model has one parallel axis, the
particles (autogp_tpu/parallel/README.md): each rank holds a contiguous
shard of P / R particles on its own device. All work is per particle
except resampling, which needs the weights of every particle (the ESS and
the normalizer) and a gather of the resampled states. The JAX package
lets XLA insert those collectives from sharding annotations; here
`inference/smc.py`, `inference/hmc.py` and `api.py` call them through a
`ParticleMesh`.

The contract is the JAX package's: a sharded fit gives every rank the
unsharded fit's result. Every rank calls `api.seed` with the same seed,
draws what the unsharded program draws and keeps its own rows
(`model.Shard`), and decides every loop bound and branch from values
reduced over all ranks. So every rank of the group must make the same
calls in the same order.

Collectives. `gather` is an all_reduce sum of a zero-filled [R, n, ...]
buffer that holds the rank's rows in its own slot, viewed as integers of
the element's width (float32 as int32, float64 as int64): integer sums
with zeros are exact, so every entry arrives with its bits, -0.0 and NaN
included. `any` and `sum` are all_reduce sums of int64. The module
chooses no backend and uses the caller's group as it is; all_reduce is
the one collective that gloo runs on CPU tensors and on CUDA tensors
(through host memory) and NCCL runs on CUDA tensors, so the same calls
serve all three.

This module imports neither jax nor anything of autogp_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from autogp_tpu_torch import backend
from autogp_tpu_torch.model import Shard

# Integer views of the same width, for the bitwise gather.
_INT_VIEW = {torch.float32: torch.int32, torch.float64: torch.int64,
             torch.int32: torch.int32, torch.int64: torch.int64}


@dataclasses.dataclass(frozen=True)
class ParticleMesh:
    """A 1-D mesh over the ranks of a process group: rank `rank` of `size`
    holds rows [rank * n, (rank + 1) * n) of a P = size * n batch on
    `device`. `group` None is the default group."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device

    def shard(self, n_local: int) -> Shard:
        """This rank's rows of a batch of `n_local` particles per rank."""
        return Shard(self.rank * n_local, self.size * n_local)

    def rows(self, n_total: int) -> slice:
        """This rank's rows of a batch of `n_total` particles."""
        if n_total % self.size:
            raise ValueError(f"n_particles={n_total} not divisible by mesh "
                             f"size {self.size}")
        n = n_total // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch [size * n, ...] of every rank's rows x [n, ...],
        bit for bit, on every rank."""
        if x.dtype == torch.bool:
            return self.gather(x.to(torch.int32)).bool()
        buf = torch.zeros((self.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        buf[self.rank] = x
        dist.all_reduce(buf.view(_INT_VIEW[x.dtype]), group=self.group)
        return buf.reshape((-1,) + tuple(x.shape[1:]))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of an integer tensor (int64)."""
        out = x.to(device=self.device, dtype=torch.int64).clone()
        dist.all_reduce(out, group=self.group)
        return out

    def any(self, flag) -> bool:
        """True when `flag` (a bool or a tensor of them) holds anywhere on
        any rank."""
        local = bool(flag.any()) if torch.is_tensor(flag) else bool(flag)
        return bool(self.sum(torch.tensor(int(local))) > 0)


def particle_mesh(group: Optional[dist.ProcessGroup] = None,
                  device="cuda") -> ParticleMesh:
    """1-D mesh over the ranks of an initialized torch.distributed group
    (the default group if None), the rank's particles on `device`."""
    if not dist.is_initialized():
        raise RuntimeError("particle_mesh needs an initialized "
                           "torch.distributed process group "
                           "(torch.distributed.init_process_group)")
    return ParticleMesh(group, dist.get_rank(group),
                        dist.get_world_size(group),
                        backend.resolve_device(device))


def shard_particles(particles, mesh: ParticleMesh):
    """This rank's rows of the whole batch `particles` (the same on every
    rank), every field on the mesh's device; scalars (log_ml_est) are
    replicated. Requires P % size == 0."""
    rows = mesh.rows(particles.n_particles)
    out = {}
    for f in dataclasses.fields(particles):
        x = getattr(particles, f.name)
        out[f.name] = (x[rows] if x.dim() >= 1 else x).to(mesh.device)
    return dataclasses.replace(particles, **out)


def gather_particles(particles, mesh: ParticleMesh):
    """The whole batch, bit for bit, on every rank, from each rank's
    shard; scalars (log_ml_est, the same on every rank) are kept."""
    return dataclasses.replace(particles, **{
        f.name: mesh.gather(getattr(particles, f.name))
        for f in dataclasses.fields(particles)
        if getattr(particles, f.name).dim() >= 1})


def replicate_dataset(data, mesh: ParticleMesh):
    """The dataset on the mesh's device: every rank holds all of it."""
    return dataclasses.replace(data, **{
        f.name: getattr(data, f.name).to(mesh.device)
        for f in dataclasses.fields(data)})
