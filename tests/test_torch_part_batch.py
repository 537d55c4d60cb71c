"""Kernel 5's partition given the whole batch's count (`part_batch`).

Kernel 5 (csrc/cov_tape_bwd.cu) splits each particle's tiles into runs by
the size of the batch and groups its double sums by them, so a mesh's
shard or a compacted HMC sweep, which launch part of a batch, pass the
whole batch's count. Held here on the CPU: the geometry a part is given
(`bwd_chunks`, `tile_runs`, `given_scratch`) is the whole batch's, and
`hmc.rejuvenate_parameters` passes the unsharded sweep's batch to every
LML gradient. The card's bits: tests/test_torch_cuda.py
(test_kernel5_shard_given_the_whole_batch_is_bitwise).
"""

import numpy as np
import pytest
import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.inference import hmc
from autogp_tpu_torch.model import Shard
from autogp_tpu_torch.ops import cov_vjp

P_GLOBAL = 64


def _live(seed=0):
    """A compacted sweep's live lanes: some rows of the 64."""
    rng = np.random.default_rng(seed)
    return int((rng.random(P_GLOBAL) < 0.3).sum())


@pytest.mark.parametrize("N,fused", [
    (32, True), (256, True), (1024, True), (32, False), (33, False),
    (200, False), (1024, False)])
@pytest.mark.parametrize("P", [P_GLOBAL // 2, P_GLOBAL // 4, _live(), 1])
def test_part_gets_the_whole_batch_geometry(N, fused, P):
    """A batch of P of the 64 particles, given part_batch = 64, gets the
    whole batch's blocks per particle, tile runs and partial scratch; with
    its own count it gets other runs wherever 8448 / P splits finer. (The
    fused entries take N a multiple of 32.)"""
    mask = (torch.arange(N) < 3 * N // 4).double()
    whole = cov_vjp.tile_runs(mask, P_GLOBAL, fused)
    assert cov_vjp.bwd_chunks(P, N, fused, P_GLOBAL) == \
        cov_vjp.bwd_chunks(P_GLOBAL, N, fused) == len(whole)
    assert cov_vjp.tile_runs(mask, P, fused, part_batch=P_GLOBAL) == whole
    M = 31
    part, tapes = cov_vjp.given_scratch(P, M, N, part_batch=P_GLOBAL)
    assert part == (P, cov_vjp.bwd_chunks(P_GLOBAL, N, False), 3 * M + 1)
    assert tapes == cov_vjp.given_scratch(P, M, N)[1]
    own = cov_vjp.tile_runs(mask, P, fused)
    nt = -(-N // 32)
    tiles = nt * (nt + 1) // 2 if fused else nt * nt
    if 8448 // P_GLOBAL < tiles:     # the whole batch splits coarser
        assert own != whole


def test_part_batch_below_the_batch_raises():
    with pytest.raises(ValueError):
        cov_vjp.bwd_chunks(32, 1024, True, part_batch=16)
    with pytest.raises(ValueError):
        cov_vjp.given_scratch(32, 31, 1024, part_batch=31)
    assert cov_vjp.bwd_chunks(32, 1024, True, part_batch=None) == \
        cov_vjp.bwd_chunks(32, 1024, True)


class _TwinMesh:
    """A stand-in for a two-rank ParticleMesh whose other rank holds the
    same live lanes: rank 0 of a batch twice the local one."""
    size, rank = 2, 0

    def shard(self, n_local):
        return Shard(0, 2 * n_local)

    def sum(self, x):
        return 2 * torch.as_tensor(x, dtype=torch.int64)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("mesh", [None, _TwinMesh()])
@pytest.mark.parametrize("N", [32, 64])
def test_hmc_passes_the_unsharded_sweeps_batch(monkeypatch, compact, mesh,
                                               N):
    """Each LML gradient of a sweep is given the batch the unsharded
    program runs: the live lanes over all ranks (compact), else all P.
    Without a mesh that is the launched batch itself. N = 32 takes the
    dense route (the noise trajectory's gradient too), N = 64 the fused
    one."""
    cfg = C.GPConfig(max_depth=3)
    tab = TM.prior_tables(cfg, "cpu", torch.float64)
    gen = torch.Generator().manual_seed(3)
    P = 6
    nt, pz = TM.sample_tree(gen, P, tab, torch.float64, "cpu")
    nz = torch.randn(P, generator=gen, dtype=torch.float64)
    ts = torch.linspace(0, 1, N, dtype=torch.float64)
    mask = (torch.arange(N) < N - 5).double()
    xs = torch.sin(6 * ts) * mask
    lml0 = TM.lml(nt, pz, nz, ts, xs, mask, cfg, tab)
    seen = []
    real = TM.lml

    def spy(node_type, *args, part_batch=None, **kw):
        if torch.is_grad_enabled():
            seen.append((node_type.shape[0], part_batch))
        return real(node_type, *args, part_batch=part_batch, **kw)
    monkeypatch.setattr(TM, "lml", spy)
    enabled = torch.tensor([True, False, True, True, False, True])
    hmc.rejuvenate_parameters(
        gen, nt, pz, nz, lml0, (ts, xs, mask), cfg, tab, 3,
        hmc.HMCConfig(L_param=2, L_noise=2, n_exit=3), True,
        enabled=enabled, compact=compact, mesh=mesh)
    assert seen
    twice = 1 if mesh is None else 2
    for launched, part in seen:
        if compact:
            assert launched <= int(enabled.sum())
            assert part == twice * launched
        else:
            assert launched == P and part == twice * P
