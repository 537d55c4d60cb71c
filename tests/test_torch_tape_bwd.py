"""The tape backward's block geometry (csrc/cov_tape_bwd.cu) on the CPU.

The kernel runs only on the card; what its wrapper and its walk must get
right is held here against plain counterparts: the per-particle block
count that sizes the partial scratch (`cov_vjp.bwd_chunks`; with the
per-slot backward's tapes, `cov_vjp.given_scratch`), the tiles
each block visits (`cov_vjp.tile_runs`: the active lower tiles of the
fused entries, every tile of the unfused one), the threads a block runs
for its tape (`cov_vjp.bwd_threads`, the shared-memory sizing by tape
length), the compact term count per tape, and the partial layout: the
blocks' sums, added in order, give the plain vector-Jacobian product.
"""

import numpy as np
import pytest
import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import gp_math
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.ops import cov, cov_vjp

TILE = cov_vjp.TILE
LEAVES = (C.CONSTANT, C.LINEAR, C.SQUARED_EXPONENTIAL, C.GAMMA_EXPONENTIAL,
          C.PERIODIC, C.WHITE_NOISE)
OPS = (C.PLUS, C.TIMES, C.CHANGEPOINT)


def _heaps(depth_cap, n_leaves):
    """Heaps [len(n_leaves), 2^D - 1]: tree p expands leaves breadth-first
    until it has n_leaves[p] (a tape of 2 n - 1 positions)."""
    M = (1 << depth_cap) - 1
    nt = torch.zeros(len(n_leaves), M, dtype=torch.int64)
    for p, n in enumerate(n_leaves):
        leaves, ops = [0], []
        while len(leaves) < n:
            s = leaves.pop(0)
            ops.append(s)
            leaves += [2 * s + 1, 2 * s + 2]
        for k, s in enumerate(ops):
            nt[p, s] = OPS[(k + p) % 3]
        for k, s in enumerate(sorted(leaves)):
            nt[p, s] = LEAVES[(k + p) % 6]
    return nt


def _mask(N, n_act, scatter, seed=0):
    if scatter:
        rng = np.random.default_rng(seed)
        return torch.as_tensor(rng.random(N) < 0.5, dtype=torch.float64)
    return (torch.arange(N) < n_act).double()


def test_bwd_chunks():
    """min(tiles, max(1, 8448 // P)) blocks per particle, as the kernel
    launches them."""
    assert cov_vjp.bwd_chunks(64, 1024, True) == 132
    assert cov_vjp.bwd_chunks(64, 256, True) == 36
    assert cov_vjp.bwd_chunks(64, 64, True) == 3
    assert cov_vjp.bwd_chunks(128, 32, False) == 1
    assert cov_vjp.bwd_chunks(128, 33, False) == 4
    assert cov_vjp.bwd_chunks(128, 1024, True) == 66
    assert cov_vjp.bwd_chunks(1, 1024, False) == 1024
    assert cov_vjp.bwd_chunks(5000, 1024, True) == 1


SHAPES = [(32, 0, False), (32, 1, False), (32, 31, False), (32, 32, False),
          (256, 224, False), (256, 225, False), (1024, 768, False),
          (1024, 1024, False), (256, 0, True)]


@pytest.mark.parametrize("fused,N,n_act,scatter", [
    (True, *s) for s in SHAPES] + [(False, *s) for s in SHAPES] + [
    (False, 33, 0, False), (False, 200, 150, False)])
@pytest.mark.parametrize("P", [1, 64, 400])
def test_tile_runs_cover_the_cotangent(fused, N, n_act, scatter, P):
    """Each tile is visited once, by contiguous runs of near-equal length.
    Fused: exactly the lower tiles whose rows and columns each hold an
    active point, so every element with a nonzero cotangent (i >= j,
    m_i m_j != 0) is visited and no wholly masked tile is; zero active
    points visit nothing. Unfused: every tile of the ceil(N / 32) grid."""
    mask = _mask(N, n_act, scatter, seed=N)
    runs = cov_vjp.tile_runs(mask, P, fused)
    assert len(runs) == cov_vjp.bwd_chunks(P, N, fused)
    seen = [t for run in runs for t in run]
    assert len(seen) == len(set(seen))
    longest = max(len(r) for r in runs)
    assert all(len(r) == longest for r in runs if r is not runs[-1]
               and len(runs[runs.index(r) + 1]) > 0)
    nt = -(-N // TILE)
    if not fused:
        assert sorted(seen) == [(a, b) for a in range(nt) for b in range(nt)]
        return
    row_act = mask.view(nt, TILE).ne(0).any(1)
    want = [(a, b) for a in range(nt) for b in range(a + 1)
            if row_act[a] and row_act[b]]
    assert seen == want
    m = mask.numpy()
    i, j = np.nonzero(np.tril(np.outer(m, m)))
    need = set(zip((i // TILE).tolist(), (j // TILE).tolist()))
    assert need <= set(seen)
    if n_act == 0 and not scatter:
        assert seen == []


@pytest.mark.parametrize("P,N,depth", [
    (1, 1, 5), (16, 33, 5), (64, 32, 5), (64, 1024, 5), (128, 200, 5),
    (400, 1024, 5), (16, 1024, 8), (64, 200, 8)])
def test_given_scratch_fits_the_runs(P, N, depth):
    """The scratch of the given-cotangent entries (kernels 5b and 7, one
    body): a float64 partial row of 3M + 1 sums for each block of the
    unfused walk, so a particle's partials are its runs of tiles, and
    kernel 7's tapes, build_tape's slot, type, lpos and rpos [P, M] and
    the lengths [P] in one int32 buffer."""
    M = (1 << depth) - 1
    part, tapes = cov_vjp.given_scratch(P, M, N)
    runs = cov_vjp.tile_runs(torch.ones(N, dtype=torch.float64), P, False)
    assert part == (P, len(runs), 3 * M + 1)
    assert part[1] <= (-(-N // TILE)) ** 2
    nt = _heaps(depth, [1 + p % 4 for p in range(P)])
    assert tapes == (sum(t.numel() for t in cov.build_tape(nt, depth)),)


def test_terms_per_type_are_the_parameters():
    """A leaf or operator adds one gradient term per parameter it has."""
    kinds = (C.PARAM_KIND > 0).sum(1)
    assert tuple(int(k) for k in kinds) == cov_vjp.TERMS_OF_TYPE


def test_tape_terms_and_threads_fit_the_budget():
    """On tapes of 1 to 31 positions (the single node and the full depth-5
    heap included) and the full depth-8 heap: at most 2 len + 2 terms;
    the threads a block runs fit the shared-memory budget with their
    accumulators and stacks (or the in-tape staging strips), are the
    most that do, and are all 256 for tapes of up to 5 positions."""
    for depth, n_leaves in ((5, range(1, 17)), (8, (128,))):
        nt = _heaps(depth, n_leaves)
        _, ttype, _, _, tlen = cov.build_tape(nt, depth)
        terms = cov_vjp.tape_terms(ttype, tlen)
        for L, n, types in zip(tlen.tolist(), terms.tolist(),
                               ttype.tolist()):
            assert n == sum(cov_vjp.TERMS_OF_TYPE[t] for t in types[:L]) + 1
            assert n <= 2 * L + 2
            for linv in (False, True):
                T = cov_vjp.bwd_threads(L, n, linv)
                stag = cov_vjp.BWD_STAGING if linv else 0
                budget = (cov_vjp.BWD_BUDGET_LINV if linv
                          else cov_vjp.BWD_BUDGET)

                def fits(t):
                    stacks = 12 * L * t
                    return 8 * n * t + max(stacks, stag) <= budget
                assert 1 <= T <= cov_vjp.BWD_THREADS and fits(T)
                if T >= 32 and T < cov_vjp.BWD_THREADS:
                    assert not fits(T + 32)
                if T < 32:
                    assert not fits(T + 1)
                if L <= 5:
                    assert T == cov_vjp.BWD_THREADS
    assert cov_vjp.bwd_threads(1, 4, False) == 256
    assert cov_vjp.bwd_threads(31, 64, True) >= 32
    assert cov_vjp.bwd_threads(255, 512, True) >= 1
    # A grid too small to fill the card gives each block a larger budget.
    assert cov_vjp.bwd_threads(31, 64, False, 225 * 1024) == 256


def _prior_batch(P, N, n_act, seed):
    """Depth-2 trees (the geometry does not depend on the tree) with one
    or two leaves, their parameters, sorted times, n_act points active."""
    cfg = C.GPConfig(max_depth=2)
    f64 = torch.float64
    tab = TM.prior_tables(cfg, "cpu", f64)
    nt = _heaps(cfg.depth_cap, [1 + p % 2 for p in range(P)])
    rng = np.random.default_rng(seed)
    pz = torch.as_tensor(0.5 * rng.standard_normal((P, nt.shape[1], 3)))
    pt = TM.transform_params(nt, pz, tab)
    ts = torch.as_tensor(np.sort(rng.random(N)))
    mask = (torch.arange(N) < n_act).to(f64)
    return cfg, nt, pt, ts, mask, rng


def _vjp(nt, pt, kbar, ts, mask, D):
    with torch.enable_grad():
        par = pt.detach().requires_grad_(True)
        nz = torch.zeros(pt.shape[0], dtype=pt.dtype, requires_grad=True)
        K = cov.cov_tape_plain(nt, par, nz, ts, ts, mask, mask, D, True,
                               False)
        return torch.autograd.grad(K, (par, nz), grad_outputs=kbar)


@pytest.mark.parametrize("fused", [True, False])
def test_block_partials_sum_to_the_plain_gradient(fused, monkeypatch):
    """The partial layout [P, chunks, 3M + 1]: each block's sum over the
    elements of its run of tiles (the fused entries: lower triangle,
    weight 2 below the diagonal and 1 on it), added over the blocks in
    order, is the plain vector-Jacobian product (float64, 1e-12 per
    particle). Few particles, so the block target is lowered to give
    runs of several tiles."""
    monkeypatch.setattr(cov_vjp, "BWD_TARGET_BLOCKS", 12)
    P, N = 4, 96
    cfg, nt, pt, ts, mask, rng = _prior_batch(P, N, 70, seed=int(fused))
    D = cfg.depth_cap
    if fused:
        A = torch.as_tensor(rng.standard_normal((P, N, N)))
        Kinv = A @ A.mT / N
        beta = torch.as_tensor(rng.standard_normal((P, N)))
        g = torch.as_tensor(rng.standard_normal(P))
        full = gp_math.mvn_logpdf_cotangent(beta, Kinv, mask, g)
        pr, nr = cov_vjp.cov_tape_bwd_plain(nt, pt, ts, mask,
                                            torch.tril(Kinv), beta, g, D)
        w = torch.tril(2.0 * torch.ones(N, N, dtype=torch.float64), -1)
        kbar = full * (w + torch.eye(N, dtype=torch.float64))
    else:
        kbar = torch.as_tensor(rng.standard_normal((P, N, N)))
        pr, nr = cov_vjp.cov_grads_plain(nt, pt, kbar, ts, mask, D)
    runs = cov_vjp.tile_runs(mask, P, fused)
    assert len(runs) > 1 and sum(len(r) for r in runs) > len(runs)
    pb = torch.zeros_like(pr)
    nb = torch.zeros_like(nr)
    for run in runs:
        sel = torch.zeros(N, N, dtype=torch.float64)
        for a, b in run:
            sel[a * TILE:(a + 1) * TILE, b * TILE:(b + 1) * TILE] = 1.0
        p_b, n_b = _vjp(nt, pt, kbar * sel, ts, mask, D)
        pb, nb = pb + p_b, nb + n_b
    rel = (pb - pr).abs().flatten(1).amax(1) / pr.abs().flatten(1).amax(1)
    assert float(rel.max()) <= 1e-12
    assert float(((nb - nr).abs() / nr.abs().clamp_min(1e-300)).max()) <= 1e-12
