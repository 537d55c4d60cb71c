"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`; every test skips when torch.cuda.is_available() is False
(decided in a fixture, never at import). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m gpu
"""

import warnings

import pytest
import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import gp_math
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _prior(dev, P, N, seed):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = C.GPConfig()
    tab = TM.prior_tables(cfg, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nt, pz = TM.sample_tree(gen, P, tab, torch.float32, dev)
    noise = TM.transform_noise(torch.randn(P, generator=gen, device=dev),
                               cfg)
    ts = torch.rand(N, generator=gen, device=dev).sort().values
    mask = (torch.arange(N, device=dev) < 3 * N // 4).float()
    return cfg, nt, TM.transform_params(nt, pz, tab), noise, ts, mask


@pytest.mark.parametrize("N", [32, 256])
@pytest.mark.parametrize("lower_only", [False, True])
def test_cov_kernel_matches_plain(cuda, N, lower_only):
    """Normwise relative error <= 1e-5 per particle: the same float32
    formulas, accurate expf/sinf/logf (no fast math)."""
    cfg, nt, pt, noise, ts, mask = _prior(cuda, 16, N, seed=N)
    before = cov.launches
    K = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, cfg.depth_cap,
                     gram=True, lower_only=lower_only)
    torch.cuda.synchronize()
    assert cov.launches == before + 1
    Kp = cov.cov_tape_plain(nt, pt, noise, ts, ts, mask, mask,
                            cfg.depth_cap, True, lower_only)
    err = ((K - Kp).abs().amax((1, 2)) / Kp.abs().amax((1, 2))).max()
    assert float(err) <= 1e-5


@pytest.mark.parametrize("N", [32, 256])
def test_chol_kernel_matches_f64(cuda, N):
    """The kernel-driven factor of well-conditioned SPD batches within
    1e-4 (normwise) of the float64 factor; NaN on a non-PD particle."""
    gen = torch.Generator(device=cuda).manual_seed(N)
    X = torch.randn(8, N, N, generator=gen, device=cuda, dtype=torch.float64)
    K = X @ X.mT / N + torch.eye(N, device=cuda, dtype=torch.float64)
    x = torch.randn(8, N, generator=gen, device=cuda, dtype=torch.float64)
    before = chol.launches
    L, a = chol.chol_solve(torch.tril(K).float(), x.float())
    torch.cuda.synchronize()
    assert chol.launches == before + N // min(N, chol.BLOCK)
    Lr = torch.linalg.cholesky(K)
    ar = torch.linalg.solve_triangular(Lr, x[..., None], upper=False)[..., 0]
    assert float((L.double() - Lr).abs().max() / Lr.abs().max()) <= 1e-4
    assert float((a.double() - ar).abs().max() / ar.abs().max()) <= 1e-4
    Kb = torch.tril(K).float()
    Kb[2, N // 2, N // 2] = -1.0
    d, a2 = chol.chol_solve_diag(Kb, x.float())
    assert torch.isnan(d[2]).any() and torch.isnan(a2[2]).any()
    assert torch.isfinite(d[:2]).all()


def _panel_input(dev, P, B, seed):
    """[P, B, B] float32 SPD blocks (condition number <= 5), handed over
    as a strided view (row stride B + 7, offset 3) of a larger batch; the
    strict upper triangle holds junk the kernel must not read."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn(P, B, B, generator=gen, device=dev, dtype=torch.float64)
    K = X @ X.mT / B + torch.eye(B, device=dev, dtype=torch.float64)
    big = torch.full((P, B + 7, B + 7), 1e30, device=dev)
    view = big[:, 3:3 + B, 3:3 + B]
    view.copy_(torch.where(torch.ones(B, B, device=dev, dtype=torch.bool)
                           .tril(), K, torch.full_like(K, 1e30)))
    return view, K


@pytest.mark.parametrize("B", [1, 7, 8, 9, 15, 16, 17, 72, 127, 128])
def test_panel_factor_matches_f64(cuda, B):
    """Kernel 2 alone at every kind of width (below, at and past the
    16-column sub-panel, ragged, full): L and L^-1 within 1e-4 normwise
    of panel_factor_plain in float64 on the same blocks, exact zeros above
    the diagonal, one launch, two launches bitwise equal."""
    A, K = _panel_input(cuda, 8, B, seed=B)
    before = chol.launches
    L, W = chol.panel_factor(A)
    L2, W2 = chol.panel_factor(A)
    torch.cuda.synchronize()
    assert chol.launches == before + 2
    assert torch.equal(L, L2) and torch.equal(W, W2)
    Lr, Wr = chol.panel_factor_plain(K)
    for got, ref in ((L, Lr), (W, Wr)):
        err = ((got.double() - ref).abs().flatten(1).amax(1)
               / ref.abs().flatten(1).amax(1))
        assert float(err.max()) <= 1e-4
        assert not torch.triu(got, 1).any()


@pytest.mark.parametrize("bad", [0, 15, 16, 127])
def test_panel_factor_nan_pivot(cuda, bad):
    """A pivot that is not > 0 at column 0, at the last and the first
    column of a 16-column sub-panel, and at the last column: NaN on the
    diagonal from that column on and in L^-1's rows from there, finite
    before it; the other particles untouched; zeros above the diagonal
    stay exact."""
    A, _ = _panel_input(cuda, 4, 128, seed=bad)
    Ab = A.clone()
    Ab[1, bad, bad] = -1.0
    L, W = chol.panel_factor(Ab)
    L0, W0 = chol.panel_factor(A)
    torch.cuda.synchronize()
    d = torch.diagonal(L[1])
    assert torch.isnan(d[bad:]).all() and torch.isfinite(d[:bad]).all()
    assert torch.isnan(W[1, bad:, :bad + 1]).all()
    assert torch.isfinite(torch.tril(W[1])[:bad]).all()
    assert not torch.triu(L, 1).any() and not torch.triu(W, 1).any()
    keep = torch.tensor([0, 2, 3], device=cuda)
    assert torch.equal(L[keep], L0[keep]) and torch.equal(W[keep], W0[keep])


def _spd(dev, P, N, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn(P, N, N, generator=gen, device=dev, dtype=torch.float64)
    K = X @ X.mT / N + torch.eye(N, device=dev, dtype=torch.float64)
    return K, torch.randn(P, N, generator=gen, device=dev,
                          dtype=torch.float64)


@pytest.mark.parametrize("N", [32, 256, 512, 1024])
def test_kinv_kernel_matches_plain(cuda, N):
    """kinv_beta_strips and linv_stats_wd on the card against the plain
    version in float64 on the same float32 factor: normwise 1e-4 for the
    lower K^-1 and beta, 1e-5 for ||L^-1||_F^2 (3xTF32 tile products and
    float32 FMA on grams of condition number <= 5); strictly-upper blocks
    exactly 0. N = 512 and 1024 (4 and 8 column strips) pair long strips
    with short ones in one block."""
    K, x = _spd(cuda, 8, N, seed=N)
    _, a, wd, L = chol.chol_solve_strips(torch.tril(K).float(), x.float())
    before = (kinv.strips_launches, kinv.stats_launches)
    Ki, beta, fro = kinv.kinv_beta_strips(a, wd, L)
    b2, f2 = kinv.linv_stats_wd(L, a, wd)
    torch.cuda.synchronize()
    assert (kinv.strips_launches, kinv.stats_launches) == (before[0] + 1,
                                                           before[1] + 1)
    Kr, br, fr = kinv.kinv_beta_plain(L.double(), a.double())

    def rel(u, v):
        return float(((u.double() - v).abs().flatten(1).amax(1)
                      / v.abs().flatten(1).amax(1)).max())
    assert rel(torch.tril(Ki), torch.tril(Kr)) <= 1e-4
    assert rel(beta, br) <= 1e-4
    assert float(((fro.double() - fr) / fr).abs().max()) <= 1e-5
    assert torch.equal(beta, b2) and torch.equal(fro, f2)
    blk = torch.arange(N, device=cuda) // min(N, chol.BLOCK)
    assert not (Ki[:, blk[None, :] > blk[:, None]] != 0).any()


@pytest.mark.parametrize("N", [32, 256])
def test_cov_tape_bwd_kernel_matches_plain(cuda, N):
    """Kernel 5 on 16 prior trees against its plain version in float64 on
    the same float32 K^-1, beta and g: per particle max|err| / max|ref|
    <= 1e-3 for the parameter and noise gradients (float32 tree values,
    double cotangent and sums); two launches bitwise equal."""
    cfg, nt, pt, noise, ts, mask = _prior(cuda, 16, N, seed=N + 1)
    xs = torch.sin(7 * ts) * mask
    Kc = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, cfg.depth_cap,
                      True, True)
    _, a, wd, L = chol.chol_solve_strips(Kc, xs.expand(16, N))
    Ki, beta, _ = kinv.kinv_beta_strips(a, wd, L)
    g = torch.linspace(-1.0, 2.0, 16, device=cuda)
    before = cov_vjp.launches
    pb, nb = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, Ki, beta, g,
                                  cfg.depth_cap)
    pb2, nb2 = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, Ki, beta, g,
                                    cfg.depth_cap)
    torch.cuda.synchronize()
    assert cov_vjp.launches == before + 2
    assert torch.equal(pb, pb2) and torch.equal(nb, nb2)
    pr, nr = cov_vjp.cov_tape_bwd_plain(
        nt, pt.double(), ts.double(), mask.double(), Ki.double(),
        beta.double(), g.double(), cfg.depth_cap)
    ok = torch.isfinite(pr.flatten(1)).all(1) & torch.isfinite(nr)
    assert int(ok.sum()) >= 8
    err = ((pb.double() - pr).abs().flatten(1).amax(1)
           / pr.abs().flatten(1).amax(1))
    assert float(err[ok].max()) <= 1e-3
    assert float(((nb.double() - nr).abs() / nr.abs())[ok].max()) <= 1e-3


def _scatter_mask(dev, N, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand(N, generator=gen, device=dev) < 0.75).float()


@pytest.mark.parametrize("N", [32, 200])
@pytest.mark.parametrize("masked", [True, False])
def test_cov_slot_kernel_matches_plain(cuda, N, masked):
    """Kernel 6 on 16 prior trees with a scattered mask, at a tile
    multiple and at a ragged N: normwise relative error <= 1e-5 per
    particle against its plain version (the same float32 formulas), and
    against the tape kernel's gram."""
    cfg, nt, pt, noise, ts, _ = _prior(cuda, 16, N, seed=N + 2)
    mask = _scatter_mask(cuda, N, N)
    before = cov.slot_launches
    K = cov.cov_matrix(nt, pt, noise, ts, mask, cfg.depth_cap, masked=masked)
    torch.cuda.synchronize()
    assert cov.slot_launches == before + 1
    Kp = cov.cov_matrix_plain(nt, pt, noise, ts, mask, cfg.depth_cap, masked)
    m = mask if masked else torch.ones_like(mask)
    Kt = cov.cov_tape(nt, pt, noise, ts, ts, m, m, cfg.depth_cap, gram=True)
    for ref in (Kp, Kt):
        err = ((K - ref).abs().amax((1, 2)) / ref.abs().amax((1, 2))).max()
        assert float(err) <= 1e-5


@pytest.mark.parametrize("N", [32, 200])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("tape", [True, False], ids=["tape", "slot"])
def test_cov_grads_kernels_match_plain(cuda, N, masked, tape):
    """Kernels 5b (unfused tape backward) and 7 (per-slot backward) on 16
    prior trees, a random non-symmetric cotangent and a scattered mask,
    against the plain version in float64 on the same float32 inputs: per
    particle max|err| / max|ref| <= 1e-3 for the parameter gradients and
    1e-5 for the noise gradient (float32 tree values, double adjoints and
    sums); two launches bitwise equal."""
    cfg, nt, pt, _, ts, _ = _prior(cuda, 16, N, seed=N + 3)
    mask = _scatter_mask(cuda, N, N + 1)
    gen = torch.Generator(device=cuda).manual_seed(N)
    kbar = torch.randn(16, N, N, generator=gen, device=cuda)
    fn = cov_vjp.cov_grads_tape if tape else cov_vjp.cov_grads
    name = "unfused_launches" if tape else "slot_launches"
    before = getattr(cov_vjp, name)
    pb, nb = fn(nt, pt, kbar, ts, mask, cfg.depth_cap, masked=masked)
    pb2, nb2 = fn(nt, pt, kbar, ts, mask, cfg.depth_cap, masked=masked)
    torch.cuda.synchronize()
    assert getattr(cov_vjp, name) == before + 2
    assert torch.equal(pb, pb2) and torch.equal(nb, nb2)
    pr, nr = cov_vjp.cov_grads_plain(nt, pt.double(), kbar.double(),
                                     ts.double(), mask.double(),
                                     cfg.depth_cap, masked)
    ok = torch.isfinite(pr.flatten(1)).all(1)
    assert int(ok.sum()) >= 8
    err = ((pb.double() - pr).abs().flatten(1).amax(1)
           / pr.abs().flatten(1).amax(1).clamp_min(1e-30))
    assert float(err[ok].max()) <= 1e-3
    assert float(((nb.double() - nr).abs() / nr.abs()).max()) <= 1e-5


def test_dense_route_matches_fused_route(cuda):
    """At the 32-point bucket model.lml under grad takes cov_matrix_diff +
    mvn_logpdf_masked_cvjp (kernel 5b launches, kernel 5 does not); its
    value is torch.equal to the value path's and its gradient agrees with
    LmlTapeFused's on the same inputs to 1e-3 of each particle's largest
    entry (two float32 routes to one gradient)."""
    cfg, _, _, _, ts, mask = _prior(cuda, 16, 32, seed=5)
    tab = TM.prior_tables(cfg, cuda, torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(6)
    nt, pz = TM.sample_tree(gen, 16, tab, torch.float32, cuda)
    nz = torch.randn(16, generator=gen, device=cuda)
    xs = torch.sin(7 * ts) * mask
    v0 = TM.lml(nt, pz, nz, ts, xs, mask, cfg, tab)
    pzg, nzg = pz.clone().requires_grad_(True), nz.clone().requires_grad_()
    before = (cov_vjp.unfused_launches, cov_vjp.launches)
    v = TM.lml(nt, pzg, nzg, ts, xs, mask, cfg, tab)
    gp, gn = torch.autograd.grad(v.sum(), (pzg, nzg))
    assert (cov_vjp.unfused_launches, cov_vjp.launches) == (before[0] + 1,
                                                            before[1])
    assert torch.equal(v.detach(), v0)
    pzf, nzf = pz.clone().requires_grad_(True), nz.clone().requires_grad_()
    vf = cov_vjp.LmlTapeFused.apply(
        TM.transform_params(nt, pzf, tab), TM.transform_noise(nzf, cfg), nt,
        ts, xs, mask, cfg.depth_cap)
    gpf, gnf = torch.autograd.grad(vf.sum(), (pzf, nzf))
    assert torch.equal(vf.detach(), v0)
    ok = torch.isfinite(v0) & torch.isfinite(gpf.flatten(1)).all(1)
    assert int(ok.sum()) >= 8
    a = torch.cat([gp.flatten(1), gn[:, None]], 1)[ok]
    b = torch.cat([gpf.flatten(1), gnf[:, None]], 1)[ok]
    assert float(((a - b).abs().amax(1) / b.abs().amax(1)).max()) <= 1e-3


def test_ragged_last_panel_matches_f64(cuda):
    """The blocked factorization at N = 200 (one full panel and one of 72
    columns) within 1e-4 (normwise) of the float64 factor."""
    K, x = _spd(cuda, 8, 200, seed=200)
    before = chol.launches
    L, a = chol.chol_solve(torch.tril(K).float(), x.float())
    torch.cuda.synchronize()
    assert chol.launches == before + 2
    Lr = torch.linalg.cholesky(K)
    ar = torch.linalg.solve_triangular(Lr, x[..., None], upper=False)[..., 0]
    assert float((L.double() - Lr).abs().max() / Lr.abs().max()) <= 1e-4
    assert float((a.double() - ar).abs().max() / ar.abs().max()) <= 1e-4


@pytest.mark.parametrize("N", [32, 256, 512, 1024])
def test_linv_entries_match_plain(cuda, N):
    """linv_beta (the kinv kernel's L^-1 output, given Wd or not) and the
    entries without Wd, kinv_beta and linv_stats, against the plain version in float64 on
    the same float32 factor: normwise 1e-4 for L^-1, the lower K^-1 and
    beta, 1e-5 for ||L^-1||_F^2; L^-1 exactly 0 above the diagonal;
    linv_beta's beta and fro bitwise linv_stats_wd's on the same Wd, and
    kinv_beta's linv_stats'. Each entry counts one launch."""
    K, x = _spd(cuda, 8, N, seed=N + 2)
    _, a, wd, L = chol.chol_solve_strips(torch.tril(K).float(), x.float())
    before = (kinv.linv_beta_launches, kinv.kinv_beta_launches,
              kinv.linv_stats_launches)
    V, beta, fro = kinv.linv_beta(L, a, wd)
    V2, beta2, fro2 = kinv.linv_beta(L, a)          # Wd by tri_inv_blocked
    Ki, beta_k, fro_k = kinv.kinv_beta(L, a)
    beta_s, fro_s = kinv.linv_stats(L, a)
    b2, f2 = kinv.linv_stats_wd(L, a, wd)
    torch.cuda.synchronize()
    assert (kinv.linv_beta_launches, kinv.kinv_beta_launches,
            kinv.linv_stats_launches) == (before[0] + 2, before[1] + 1,
                                          before[2] + 1)
    Vr, br, fr = kinv.linv_beta_plain(L.double(), a.double())
    Kr = kinv.kinv_beta_plain(L.double(), a.double())[0]

    def rel(u, v):
        return float(((u.double() - v).abs().flatten(1).amax(1)
                      / v.abs().flatten(1).amax(1)).max())
    assert not torch.triu(V, 1).any() and not torch.triu(V2, 1).any()
    assert rel(V, Vr) <= 1e-4 and rel(V2, Vr) <= 1e-4
    assert rel(torch.tril(Ki), torch.tril(Kr)) <= 1e-4
    for b, f in ((beta, fro), (beta2, fro2), (beta_k, fro_k),
                 (beta_s, fro_s)):
        assert rel(b, br) <= 1e-4
        assert float(((f.double() - fr) / fr).abs().max()) <= 1e-5
    assert torch.equal(beta, b2) and torch.equal(fro, f2)
    assert torch.equal(beta_k, beta_s) and torch.equal(fro_k, fro_s)
    blk = torch.arange(N, device=cuda) // min(N, chol.BLOCK)
    assert not (Ki[:, blk[None, :] > blk[:, None]] != 0).any()


@pytest.mark.parametrize("N", [32, 256])
def test_cov_tape_bwd_linv_kernel_matches_plain(cuda, N):
    """Kernel 5's in-tape L^-1 entry on 16 prior trees, V and beta from
    linv_beta, against its plain version in float64 on the same inputs:
    per particle max|err| / max|ref| <= 1e-3 for the parameter and noise
    gradients, as kernel 5; two launches bitwise equal. LmlTapeFused under
    INTAPE_LINV gives the value of the default backend exactly and its
    gradient within 1e-3."""
    cfg, nt, pt, noise, ts, mask = _prior(cuda, 16, N, seed=N + 3)
    xs = torch.sin(7 * ts) * mask
    Kc = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, cfg.depth_cap,
                      True, True)
    _, a, wd, L = chol.chol_solve_strips(Kc, xs.expand(16, N))
    V, beta, _ = kinv.linv_beta(L, a, wd)
    g = torch.linspace(-1.0, 2.0, 16, device=cuda)
    before = cov_vjp.linv_launches
    pb, nb = cov_vjp.cov_tape_bwd_linv(nt, pt, ts, mask, V, beta, g,
                                       cfg.depth_cap)
    pb2, nb2 = cov_vjp.cov_tape_bwd_linv(nt, pt, ts, mask, V, beta, g,
                                         cfg.depth_cap)
    torch.cuda.synchronize()
    assert cov_vjp.linv_launches == before + 2
    assert torch.equal(pb, pb2) and torch.equal(nb, nb2)
    pr, nr = cov_vjp.cov_tape_bwd_plain(
        nt, pt.double(), ts.double(), mask.double(),
        gp_math.kinv_from_linv(V.double()), beta.double(), g.double(),
        cfg.depth_cap)
    ok = torch.isfinite(pr.flatten(1)).all(1) & torch.isfinite(nr)
    assert int(ok.sum()) >= 8
    err = ((pb.double() - pr).abs().flatten(1).amax(1)
           / pr.abs().flatten(1).amax(1))
    assert float(err[ok].max()) <= 1e-3
    assert float(((nb.double() - nr).abs() / nr.abs())[ok].max()) <= 1e-3

    def fused(intape):
        old = cov_vjp.INTAPE_LINV
        cov_vjp.INTAPE_LINV = intape
        try:
            p = pt.clone().requires_grad_(True)
            n = noise.clone().requires_grad_(True)
            v = cov_vjp.LmlTapeFused.apply(p, n, nt, ts, xs, mask,
                                           cfg.depth_cap)
            gp, gn = torch.autograd.grad(v.sum(), (p, n))
        finally:
            cov_vjp.INTAPE_LINV = old
        return v.detach(), torch.cat([gp.flatten(1), gn[:, None]], 1)
    (v0, g0), (v1, g1) = fused(False), fused(True)
    assert torch.equal(v0, v1)
    fin = torch.isfinite(g0).all(1) & torch.isfinite(g1).all(1)
    assert int(fin.sum()) >= 8
    assert float(((g1 - g0).abs().amax(1)
                  / g0.abs().amax(1))[fin].max()) <= 1e-3


LEAF_CYCLE = (C.CONSTANT, C.LINEAR, C.SQUARED_EXPONENTIAL,
              C.GAMMA_EXPONENTIAL, C.PERIODIC, C.WHITE_NOISE)
OP_CYCLE = (C.PLUS, C.TIMES, C.CHANGEPOINT)


def _mixed_heaps(depth_cap, n_leaves):
    """[len(n_leaves), 2^D - 1] heaps: tree p expands leaves breadth-first
    until it has n_leaves[p] (a tape of 2 n - 1 positions), operators and
    leaves cycling through every type."""
    M = (1 << depth_cap) - 1
    nt = torch.zeros(len(n_leaves), M, dtype=torch.int64)
    for p, n in enumerate(n_leaves):
        leaves, ops = [0], []
        while len(leaves) < n:
            s = leaves.pop(0)
            ops.append(s)
            leaves += [2 * s + 1, 2 * s + 2]
        for k, s in enumerate(ops):
            nt[p, s] = OP_CYCLE[(k + p) % 3]
        for k, s in enumerate(sorted(leaves)):
            nt[p, s] = LEAF_CYCLE[(k + p) % 6]
    return nt


def _mixed(dev, N, n_act, seed):
    """16 trees with tapes of 1, 3, ..., 31 positions (the full depth-5
    heap last), their transformed parameters and noise, sorted times and
    the first n_act points active."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = C.GPConfig()
    tab = TM.prior_tables(cfg, dev, torch.float32)
    nt = _mixed_heaps(cfg.depth_cap, range(1, 17)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pz = 0.5 * torch.randn(16, nt.shape[1], 3, generator=gen, device=dev)
    noise = TM.transform_noise(torch.randn(16, generator=gen, device=dev),
                               cfg)
    ts = torch.rand(N, generator=gen, device=dev).sort().values
    mask = (torch.arange(N, device=dev) < n_act).float()
    return cfg, nt, TM.transform_params(nt, pz, tab), noise, ts, mask


def _rel_or_zero(got, ref):
    """Per-particle max|got - ref| / max|ref|, 0 where ref is all zero and
    got is exactly zero there (inf where it is not)."""
    num = (got.double() - ref).abs().flatten(1).amax(1)
    den = ref.abs().flatten(1).amax(1)
    return torch.where(den > 0, num / den.clamp_min(1e-300),
                       torch.where(num == 0, 0.0, float("inf")))


@pytest.mark.parametrize("N", [32, 256, 1024])
@pytest.mark.parametrize("last_rows", [0, 1, 31, 32])
def test_tape_bwd_mixed_tapes_match_plain(cuda, N, last_rows):
    """Kernel 5 and its in-tape entry 5c on 16 trees whose tapes run from
    1 to 31 positions, with 0, 1, 31 or all 32 rows of the last tile
    active: against the plain version in float64 on the same float32
    inputs, per particle <= 1e-3 for the parameter and the noise gradient
    (exactly 0 where the reference is); two runs bitwise equal; 5c bitwise
    kernel 5 on the same factor."""
    n_act = N - 32 + last_rows
    cfg, nt, pt, noise, ts, mask = _mixed(cuda, N, n_act, seed=N + last_rows)
    xs = torch.sin(7 * ts) * mask
    Kc = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, cfg.depth_cap,
                      True, True)
    _, a, wd, L = chol.chol_solve_strips(Kc, xs.expand(16, N))
    Ki, beta, _ = kinv.kinv_beta_strips(a, wd, L)
    V, beta_v, _ = kinv.linv_beta(L, a, wd)
    g = torch.linspace(-1.0, 2.0, 16, device=cuda)
    pb, nb = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, Ki, beta, g,
                                  cfg.depth_cap)
    pb2, nb2 = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, Ki, beta, g,
                                    cfg.depth_cap)
    pl, nl = cov_vjp.cov_tape_bwd_linv(nt, pt, ts, mask, V, beta_v, g,
                                       cfg.depth_cap)
    torch.cuda.synchronize()
    assert torch.equal(pb, pb2) and torch.equal(nb, nb2)
    assert torch.equal(pl, pb) and torch.equal(nl, nb)
    pr, nr = cov_vjp.cov_tape_bwd_plain(
        nt, pt.double(), ts.double(), mask.double(), Ki.double(),
        beta.double(), g.double(), cfg.depth_cap)
    ok = torch.isfinite(pr.flatten(1)).all(1) & torch.isfinite(nr)
    assert int(ok.sum()) >= 8
    assert float(_rel_or_zero(pb, pr)[ok].max()) <= 1e-3
    assert float(_rel_or_zero(nb[:, None], nr[:, None])[ok].max()) <= 1e-3


@pytest.mark.parametrize("N", [1, 31, 32, 33, 200])
def test_cov_grads_tape_any_n(cuda, N):
    """Kernel 5b (every tile, weight 1, clamped edge threads) at N below,
    at and above one tile, on 16 trees with tapes of 1 to 31 positions, a
    random non-symmetric cotangent and a scattered mask: against the plain
    version in float64, per particle <= 1e-3 (parameters) and 1e-5
    (noise); two runs bitwise equal."""
    cfg, nt, pt, _, ts, _ = _mixed(cuda, N, N, seed=N + 7)
    mask = _scatter_mask(cuda, N, N + 8)
    gen = torch.Generator(device=cuda).manual_seed(N + 9)
    kbar = torch.randn(16, N, N, generator=gen, device=cuda)
    pb, nb = cov_vjp.cov_grads_tape(nt, pt, kbar, ts, mask, cfg.depth_cap)
    pb2, nb2 = cov_vjp.cov_grads_tape(nt, pt, kbar, ts, mask, cfg.depth_cap)
    torch.cuda.synchronize()
    assert torch.equal(pb, pb2) and torch.equal(nb, nb2)
    pr, nr = cov_vjp.cov_grads_plain(nt, pt.double(), kbar.double(),
                                     ts.double(), mask.double(),
                                     cfg.depth_cap, True)
    ok = torch.isfinite(pr.flatten(1)).all(1)
    assert int(ok.sum()) >= 8
    assert float(_rel_or_zero(pb, pr)[ok].max()) <= 1e-3
    assert float(((nb.double() - nr).abs()
                  / nr.abs().clamp_min(1.0)).max()) <= 1e-5


@pytest.mark.parametrize("depth", [5, 8])
@pytest.mark.parametrize("N", [1, 33, 200])
def test_cov_kernel_bitwise_slot_kernel(cuda, depth, N):
    """Kernel 1's gram (full and lower_only) bitwise kernel 6's at ragged
    N with a scattered mask, on prior trees and, at depth cap 8, on right
    combs that fill the eight-deep value stack."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = C.GPConfig(max_depth=depth)
    tab = TM.prior_tables(cfg, cuda, torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(depth * N)
    nt, pz = TM.sample_tree(gen, 16, tab, torch.float32, cuda)
    if depth == 8:
        comb = [0]
        while len(comb) < 7:
            comb.append(2 * comb[-1] + 2)
        for p in range(4):
            nt[p] = 0
            for k, s in enumerate(comb):
                nt[p, s] = OP_CYCLE[(k + p) % 3]
                nt[p, 2 * s + 1] = LEAF_CYCLE[(k + p) % 6]
            nt[p, 2 * comb[-1] + 2] = LEAF_CYCLE[p % 6]
    pt = TM.transform_params(nt, pz, tab)
    noise = TM.transform_noise(torch.randn(16, generator=gen, device=cuda),
                               cfg)
    ts = torch.rand(N, generator=gen, device=cuda).sort().values
    mask = _scatter_mask(cuda, N, N + depth)
    K6 = cov.cov_matrix(nt, pt, noise, ts, mask, cfg.depth_cap, masked=True)
    K1 = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, cfg.depth_cap,
                      gram=True)
    K1l = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, cfg.depth_cap,
                       gram=True, lower_only=True)
    torch.cuda.synchronize()
    assert torch.equal(K1, K6)
    assert torch.equal(K1l, torch.tril(K6))


@pytest.mark.parametrize("N1,N2", [(37, 70), (70, 37), (64, 72), (5, 128)])
def test_cov_kernel_cross_block_bitwise(cuda, N1, N2):
    """Kernel 1 outside gram mode (the predict cross-covariance, N1 != N2,
    rows of 4k and of other widths): bitwise the off-diagonal block of
    kernel 6's gram on the joined time grid, 0 where a mask is 0."""
    cfg, nt, pt, noise, _, _ = _prior(cuda, 16, 8, seed=N1 + N2)
    gen = torch.Generator(device=cuda).manual_seed(N1 * N2)
    t_all = torch.rand(N1 + N2, generator=gen, device=cuda)
    m_row = _scatter_mask(cuda, N1, N1)
    m_col = _scatter_mask(cuda, N2, N2 + 1)
    K6 = cov.cov_matrix(nt, pt, noise, t_all,
                        torch.ones(N1 + N2, device=cuda), cfg.depth_cap,
                        masked=False)
    Kx = cov.cov_tape(nt, pt, noise, t_all[:N1], t_all[N1:], m_row, m_col,
                      cfg.depth_cap, gram=False)
    torch.cuda.synchronize()
    keep = (m_row[:, None] * m_col[None, :]) > 0
    want = torch.where(keep, K6[:, :N1, N1:], torch.zeros((), device=cuda))
    assert torch.equal(Kx, want)
