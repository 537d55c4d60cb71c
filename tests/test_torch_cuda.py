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


def _prior(dev, P, N, seed, depth=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = C.GPConfig() if depth is None else C.GPConfig(max_depth=depth)
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


@pytest.mark.parametrize("N", [32, 64, 128, 256, 512, 1024])
def test_kinv_kernel_matches_plain(cuda, N):
    """kinv_beta_strips and linv_stats_wd on the card against the plain
    version in float64 on the same float32 factor: normwise 1e-4 for the
    lower K^-1 and beta, 1e-5 for ||L^-1||_F^2 (3xTF32 tensor-core products
    and float32 FMA on grams of condition number <= 5); strictly-upper
    blocks exactly 0; two runs bitwise equal. N = 32, 64 and 128 are one
    strip (K^-1 one B x B product, B = N); N = 512 and 1024 (4 and 8
    column strips) pair long strips with short ones in one block."""
    K, x = _spd(cuda, 8, N, seed=N)
    _, a, wd, L = chol.chol_solve_strips(torch.tril(K).float(), x.float())
    before = (kinv.strips_launches, kinv.stats_launches)
    Ki, beta, fro = kinv.kinv_beta_strips(a, wd, L)
    Ki2, beta2, fro2 = kinv.kinv_beta_strips(a, wd, L)
    b2, f2 = kinv.linv_stats_wd(L, a, wd)
    torch.cuda.synchronize()
    assert (kinv.strips_launches, kinv.stats_launches) == (before[0] + 2,
                                                           before[1] + 1)
    assert (torch.equal(Ki, Ki2) and torch.equal(beta, beta2)
            and torch.equal(fro, fro2))
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


def _card_kernels(fn):
    """Names of the CUDA kernels one call of fn launched, in launch order,
    as torch.profiler records them (it may miss a launch, never add one)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.name for e in sorted(evs, key=lambda e: e.time_range.start)]


def _assert_own_launches(names, allowed):
    """The port's kernels among `names` (PyTorch's are in at::native; a
    copy, such as a wrapper's read of a deep batch's tape maxima, is none)
    are at most one launch of each of `allowed`, in that order, with no
    PyTorch kernel between the first and the last of them."""
    own = [k for k, n in enumerate(names)
           if "at::native" not in n and not n.startswith(("Memcpy",
                                                          "Memset"))]
    it = iter(allowed)
    assert all(any(a in names[k] for a in it) for k in own), names
    if own:
        assert all("at::native" not in n
                   for n in names[own[0]:own[-1] + 1]), names


@pytest.mark.parametrize("N", [32, 200])
@pytest.mark.parametrize("masked", [True, False])
def test_cov_slot_kernel_matches_plain(cuda, N, masked):
    """Kernel 6 on 16 prior trees with a scattered mask, at a tile
    multiple and at a ragged N: normwise relative error <= 1e-5 per
    particle against its plain version (the same float32 formulas), and
    against the tape kernel's gram. One launch of the kernel per call and
    no tape built by the wrapper."""
    cfg, nt, pt, noise, ts, _ = _prior(cuda, 16, N, seed=N + 2)
    mask = _scatter_mask(cuda, N, N)
    before = cov.slot_launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cov, "build_tape", None)
        K = cov.cov_matrix(nt, pt, noise, ts, mask, cfg.depth_cap,
                           masked=masked)
        names = _card_kernels(lambda: cov.cov_matrix(
            nt, pt, noise, ts, mask, cfg.depth_cap, masked=masked))
    torch.cuda.synchronize()
    assert cov.slot_launches == before + 2
    _assert_own_launches(names, ["cov_slot_kernel"])
    Kp = cov.cov_matrix_plain(nt, pt, noise, ts, mask, cfg.depth_cap, masked)
    m = mask if masked else torch.ones_like(mask)
    Kt = cov.cov_tape(nt, pt, noise, ts, ts, m, m, cfg.depth_cap, gram=True)
    for ref in (Kp, Kt):
        err = ((K - ref).abs().amax((1, 2)) / ref.abs().amax((1, 2))).max()
        assert float(err) <= 1e-5


@pytest.mark.parametrize("N", [32, 200])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("depth", [5, 8])
@pytest.mark.parametrize("tape", [True, False], ids=["tape", "slot"])
def test_cov_grads_kernels_match_plain(cuda, N, masked, depth, tape,
                                       monkeypatch):
    """Kernels 5b (unfused tape backward) and 7 (per-slot backward) on 16
    prior trees at depth cap 5 or 8, a random non-symmetric cotangent and
    a scattered mask, against the plain version in float64 on the same
    float32 inputs: per particle max|err| / max|ref| <= 1e-3 for the
    parameter gradients and 1e-5 for the noise gradient (float32 tree
    values, double adjoints and sums); two launches bitwise equal. Kernel
    7's wrapper builds no tape and launches at most three kernels per
    call (the heap-to-tape pass, 5b's body, the reduction), nothing of
    PyTorch's between them."""
    cfg, nt, pt, _, ts, _ = _prior(cuda, 16, N, seed=N + 3, depth=depth)
    mask = _scatter_mask(cuda, N, N + 1)
    gen = torch.Generator(device=cuda).manual_seed(N)
    kbar = torch.randn(16, N, N, generator=gen, device=cuda)
    fn = cov_vjp.cov_grads_tape if tape else cov_vjp.cov_grads
    name = "unfused_launches" if tape else "slot_launches"
    if not tape:
        monkeypatch.setattr(cov, "build_tape", None)
    before = getattr(cov_vjp, name)
    pb, nb = fn(nt, pt, kbar, ts, mask, cfg.depth_cap, masked=masked)
    pb2, nb2 = fn(nt, pt, kbar, ts, mask, cfg.depth_cap, masked=masked)
    torch.cuda.synchronize()
    assert getattr(cov_vjp, name) == before + 2
    if not tape:
        _assert_own_launches(
            _card_kernels(lambda: fn(nt, pt, kbar, ts, mask, cfg.depth_cap,
                                     masked=masked)),
            ["heap_tape_kernel", "cov_tape_bwd_kernel",
             "reduce_tiles_kernel"])
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


@pytest.mark.parametrize("N", [32, 64, 128, 256, 512, 1024])
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


def _prior_and_combs(dev, depth, N):
    """16 prior trees at depth cap `depth` (the first 4, at depth cap 8,
    replaced by right combs of 7 operators that fill the eight-deep value
    stack), their transformed parameters and noise, sorted times, and the
    generator they were drawn from."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = C.GPConfig(max_depth=depth)
    tab = TM.prior_tables(cfg, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(depth * N)
    nt, pz = TM.sample_tree(gen, 16, tab, torch.float32, dev)
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
    noise = TM.transform_noise(torch.randn(16, generator=gen, device=dev),
                               cfg)
    ts = torch.rand(N, generator=gen, device=dev).sort().values
    return cfg, nt, pt, noise, ts, gen


@pytest.mark.parametrize("depth", [5, 8])
@pytest.mark.parametrize("N", [1, 33, 200])
def test_cov_kernel_bitwise_slot_kernel(cuda, depth, N):
    """Kernel 1's gram (full and lower_only) bitwise kernel 6's at ragged
    N with a scattered mask, on prior trees and, at depth cap 8, on right
    combs that fill the eight-deep value stack."""
    cfg, nt, pt, noise, ts, _ = _prior_and_combs(cuda, depth, N)
    mask = _scatter_mask(cuda, N, N + depth)
    K6 = cov.cov_matrix(nt, pt, noise, ts, mask, cfg.depth_cap, masked=True)
    K1 = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, cfg.depth_cap,
                      gram=True)
    K1l = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, cfg.depth_cap,
                       gram=True, lower_only=True)
    torch.cuda.synchronize()
    assert torch.equal(K1, K6)
    assert torch.equal(K1l, torch.tril(K6))


@pytest.mark.parametrize("depth", [5, 8])
@pytest.mark.parametrize("N", [1, 33, 200, 1024])
@pytest.mark.parametrize("masked", [True, False])
def test_slot_bwd_bitwise_unfused_tape_bwd(cuda, depth, N, masked):
    """Kernel 7 (cov_grads: the heaps compacted into tapes on the card,
    then 5b's body) torch.equal to 5b (cov_grads_tape, on build_tape's
    tapes) on pbar and nbar, on a random non-symmetric cotangent with a
    scattered mask, masked or not, at N below, at and above one tile and
    at 1024, on prior trees and, at depth cap 8, on right combs (tapes of
    15 positions in a 255-slot heap)."""
    cfg, nt, pt, _, ts, gen = _prior_and_combs(cuda, depth, N)
    mask = _scatter_mask(cuda, N, N + depth + 1)
    kbar = torch.randn(16, N, N, generator=gen, device=cuda)
    pb7, nb7 = cov_vjp.cov_grads(nt, pt, kbar, ts, mask, cfg.depth_cap,
                                 masked=masked)
    pb5, nb5 = cov_vjp.cov_grads_tape(nt, pt, kbar, ts, mask, cfg.depth_cap,
                                      masked=masked)
    torch.cuda.synchronize()
    assert torch.equal(pb7, pb5) and torch.equal(nb7, nb5)
    if not masked or bool(mask.any()):   # else the cotangent is all 0
        assert bool((pb7 != 0).any())


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


def _encode(dev, kernels, depth):
    import numpy as np
    from autogp_tpu_torch import tree as TT
    cfg = C.GPConfig(max_depth=depth)
    enc = [TT.node_to_tensor(k, cfg) for k in kernels]
    nt = torch.as_tensor(np.stack([e[0] for e in enc]), device=dev)
    pz = torch.as_tensor(np.stack([e[1] for e in enc]), dtype=torch.float32,
                         device=dev)
    return nt, TM.transform_params(nt, pz,
                                   TM.prior_tables(cfg, dev, torch.float32))


def _rows_hold(rows):
    import chip_smoke
    assert not chip_smoke.gate_failures(rows), chip_smoke.rows_text(rows)


@pytest.mark.parametrize("depth", [9, 10, 12])
def test_deep_heap_kernels_match_plain(cuda, depth):
    """Kernels 1, 1 f64, 5, 5b, 5c, 6 and 7 on heaps of 511, 1023 and 4095
    slots (a right comb as tall as the cap, one a level shorter, prior
    trees of that cap) against their plain versions with chip_smoke's
    gates, the twins bitwise (6 = 1, 5c = 5, 7 = 5b), and kernels 1 and 6
    bitwise themselves on every taller stack instance
    (chip_smoke.deep_kernel_rows)."""
    import numpy as np

    import chip_smoke
    gen = torch.Generator(device=cuda).manual_seed(depth)
    _rows_hold(chip_smoke.deep_kernel_rows(np, torch, gen, depth))


def test_full_tree_kernels_match_plain(cuda):
    """The full tree of 9 levels (a 511-position tape) through every
    tape kernel (chip_smoke.full_tree_rows)."""
    import numpy as np

    import chip_smoke
    gen = torch.Generator(device=cuda).manual_seed(9)
    _rows_hold(chip_smoke.full_tree_rows(np, torch, gen))


def test_recoded_heaps_are_bitwise(cuda):
    """The same trees in heaps of depth caps 5 and 10 give kernel 1's gram
    and kernels 5, 5b and 7's gradients (slot for slot) bit for bit
    (chip_smoke.recode_rows)."""
    import numpy as np

    import chip_smoke
    gen = torch.Generator(device=cuda).manual_seed(10)
    _rows_hold(chip_smoke.recode_rows(np, torch, gen))


def test_overlong_tape_raises_without_launch(cuda):
    """A tape longer than an entry can stage raises before launch, naming
    the limit (ops/cov.py TAPE_LIMITS), the launch counter unmoved
    (chip_smoke.overlong_rows)."""
    import numpy as np

    import chip_smoke
    _rows_hold(chip_smoke.overlong_rows(np, torch))


def test_constant_zero_pad_transforms_to_zero(cuda):
    """A Constant(0) pad (predict_mvn_sum's components, extract_kernel)
    encodes as z = -inf; in float32 on the card its transform is exactly 0
    and nothing else of the heap turns non-finite."""
    import numpy as np
    from autogp_tpu_torch import kernels as GP
    with np.errstate(divide="ignore"):
        nt, pt = _encode(cuda, [GP.Constant(0.0) + GP.Periodic(1, 1, 1)], 2)
    assert bool(torch.isfinite(pt).all())
    assert float(pt[0, 1, 0]) == 0.0


def _small_model(dev, n, P, config, seed):
    import numpy as np
    import autogp_tpu_torch as A
    rng = np.random.default_rng(seed)
    ds = np.linspace(0, 4, n)
    y = np.sin(3 * ds) + 0.3 * ds + 0.1 * rng.standard_normal(n)
    A.seed(seed)
    return A.GPModel(ds, y, n_particles=P, config=config, device=dev)


def test_predict_mvn_sum_card_matches_cpu(cuda):
    """predict_mvn_sum on the card (kernel 1 on the components, float32)
    against a float64 CPU run on the same model carried by to_dict /
    from_dict: means and covariances within 1e-3 normwise per particle;
    kernel 1 launches once."""
    import numpy as np
    import autogp_tpu_torch as A
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = _small_model(cuda, 60, 8, A.GPConfig(), seed=3)
        A.fit_smc(m, schedule=[30, 60], n_mcmc=2, n_hmc=1)
    ref = A.from_dict(A.to_dict(m), device="cpu", dtype=torch.float64)
    ds_pred = np.linspace(4, 5, 9)
    before = cov.launches
    mix, idx = A.predict_mvn_sum(m, ds_pred, A.GP.Periodic)
    assert cov.launches == before + 1
    mix_ref, _ = A.predict_mvn_sum(ref, ds_pred, A.GP.Periodic)
    for a, b in zip(mix.components, mix_ref.components):
        assert np.abs(a.mean - b.mean).max() <= 1e-3 * np.abs(b.mean).max()
        assert np.abs(a.cov - b.cov).max() <= 1e-3 * np.abs(b.cov).max()


def test_fit_greedy_on_card_rescored_on_cpu(cuda):
    """A small fit_greedy on the card (fused gradient route at the
    64-point bucket: kernels 1, 2, 4, 5 launch): AIC non-increasing, and
    the final particle's LML re-scored in float64 on the CPU within
    1e-3."""
    import autogp_tpu_torch as A
    from autogp_tpu_torch.ops import chol
    cfg = A.GPConfig(max_depth=2, changepoints=False)
    m = _small_model(cuda, 40, 1, cfg, seed=5)
    counts = (cov.launches, chol.launches, kinv.strips_launches,
              cov_vjp.launches)
    aics = []
    A.fit_greedy(m, max_depth=2, callback_fn=lambda **kw:
                 aics.append(kw["aic"]))
    now = (cov.launches, chol.launches, kinv.strips_launches,
           cov_vjp.launches)
    assert all(b > a for a, b in zip(counts, now))
    assert len(aics) == 2 and aics[1] <= aics[0]
    ref = A.from_dict(A.to_dict(m), device="cpu", dtype=torch.float64)
    lml, lml_ref = float(m.particles.lml[0]), float(ref.particles.lml[0])
    assert abs(lml - lml_ref) <= 1e-3 * abs(lml_ref)


def _short_period_lanes(dev):
    """Three candidates of config 3's greedy search (the 144-point airline
    series on its 256-point bucket, depth cap 3) with their fitted noise:
    GE x (Periodic + GE) at the season's period, GE x (Periodic x
    Periodic) at a period of 0.0072 (its argument reaches 436 rad), and
    (GE x GE) + Periodic at 0.0010. Returns (nt, params, noise, ts, xs,
    mask)."""
    import numpy as np
    import autogp_tpu_torch as A
    import chip_smoke
    t, y = chip_smoke.airline_series(np)
    data = A.GPModel(t, y, n_particles=1, device=dev, dtype=torch.float32,
                     config=C.GPConfig(changepoints=False, max_depth=3)
                     )._dataset()
    GE, PER = C.GAMMA_EXPONENTIAL, C.PERIODIC
    nt = torch.tensor([[C.TIMES, GE, C.PLUS, 0, 0, PER, GE],
                       [C.TIMES, GE, C.TIMES, 0, 0, PER, PER],
                       [C.PLUS, C.TIMES, PER, GE, GE, 0, 0]], device=dev)
    pt = torch.zeros((3, 7, 3), device=dev)
    pt[0, 1] = torch.tensor([1.17327428, 1.99673164, 0.360891074])
    pt[0, 5] = torch.tensor([1.74146271, 0.0835936144, 0.238179117])
    pt[0, 6] = torch.tensor([0.0386895649, 0.648562431, 0.351748019])
    pt[1, 1] = torch.tensor([0.154668152, 1.99657381, 1.4347018])
    pt[1, 5] = torch.tensor([1.93175769, 109.416458, 0.949725211])
    pt[1, 6] = torch.tensor([1.64557528, 0.00723229954, 0.677288175])
    pt[2, 2] = torch.tensor([2.44747281, 0.00101107231, 0.216142237])
    pt[2, 3] = torch.tensor([2.42187834, 1.90847182, 0.0654922724])
    pt[2, 4] = torch.tensor([1.16635513, 1.99598432, 0.323143035])
    noise = torch.tensor([1.4278102e-4, 1.5061795e-4, 1.4743405e-4],
                         device=dev)
    return nt, pt, noise, data.ts, data.xs, data.mask


def test_tape_bwd_error_within_its_terms_size(cuda):
    """Kernel 5 on config 3's candidates with short periods and
    GammaExponentials of gamma ~2 (the terms near the diagonal, where the
    cotangent is largest, carry small exponents): each parameter's error
    against the plain version in float64 on the same inputs <= 1e-5 of
    the sum of its terms' magnitudes (chip_smoke.term_scale). The
    gradient cancels within that sum, so its error relative to the
    gradient is not the measure."""
    import chip_smoke
    D = 3
    nt, pt, noise, ts, xs, mask = _short_period_lanes(cuda)
    K = cov.cov_tape(nt, pt, noise, ts, ts, mask, mask, D, True, True)
    _, alpha, wd, L = chol.chol_solve_strips(K, (xs * mask).expand(3, -1))
    Ki, beta, _ = kinv.kinv_beta_strips(alpha, wd, L)
    g = torch.ones(3, device=cuda)
    pb, _ = cov_vjp.cov_tape_bwd(nt, pt, ts, mask, Ki, beta, g, D)
    pr, _ = cov_vjp.cov_tape_bwd_plain(nt, pt.double(), ts.double(),
                                       mask.double(), Ki.double(),
                                       beta.double(), g.double(), D)
    assert bool(torch.isfinite(pr).all())
    scale = chip_smoke.term_scale(torch, nt, pt, ts, mask, Ki, beta, D)
    err = (pb.double() - pr).abs().flatten(1)
    assert float(torch.where(scale > 0, err / scale, err).max()) <= 1e-5


def test_kernels_at_one_particle(cuda):
    """Kernels 1-5 with a batch of one, at config 2's shapes, against their
    plain versions with chip_smoke's gates (chip_smoke.
    kernels_at_one_particle): [1, 512, 512] (config2_sweeps) and
    [1, 256, 256] (experiment_hmc.run's defaults), and the launches that
    check makes."""
    import chip_smoke
    from autogp_tpu_torch.ops import kinv as KV
    before = (cov.launches, chol.launches, KV.stats_launches,
              KV.strips_launches, cov_vjp.launches)
    rows = chip_smoke.kernels_at_one_particle(
        torch, torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    assert not chip_smoke.gate_failures(rows), chip_smoke.rows_text(rows)
    after = (cov.launches, chol.launches, KV.stats_launches,
             KV.strips_launches, cov_vjp.launches)
    assert [b - a_ for a_, b in zip(before, after)] == [2, 14, 1, 3, 2]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_cov_kernel_small_heaps(cuda, depth):
    """Kernels 1 and 5 on 64 prior trees with heaps of one, three and 15
    slots (depth caps 1, 2 and 4, as the depth-annealed fit's rounds give
    them) at [64, 1024, 1024], 768 points active, against their plain
    versions with chip_smoke's gates (chip_smoke.small_heap_rows)."""
    import chip_smoke
    before = (cov.launches, cov_vjp.launches)
    rows = chip_smoke.small_heap_rows(
        torch, torch.Generator(device=cuda).manual_seed(depth), depth)
    torch.cuda.synchronize()
    assert rows[0][0] == f"M={(1 << depth) - 1} kernel 1"
    assert not chip_smoke.gate_failures(rows), chip_smoke.rows_text(rows)
    assert (cov.launches, cov_vjp.launches) == (before[0] + 1,
                                                before[1] + 1)


def test_depth_annealing_on_card_rescored_on_cpu(cuda):
    """A small run_smc_anneal_depth on the card (schedule [1, 2, 3], 40
    points on the 64 bucket: the fused route, kernels 1-5): valid trees,
    finite LMLs, and the heaviest particles' LMLs within 1e-3 of float64
    on the CPU."""
    import numpy as np
    from autogp_tpu_torch.inference import smc, smc_depth
    rng = np.random.default_rng(0)
    ts = np.linspace(0, 1, 40)
    xs = np.sin(6 * ts) + 0.1 * rng.standard_normal(40)
    before = (cov.launches, chol.launches, kinv.stats_launches,
              kinv.strips_launches, cov_vjp.launches)
    gen = torch.Generator(device=cuda).manual_seed(0)
    parts, cfg = smc_depth.run_smc_anneal_depth(
        gen, ts, xs, [1, 2, 3], n_particles=16, n_mcmc=2, n_hmc=2)
    after = (cov.launches, chol.launches, kinv.stats_launches,
             kinv.strips_launches, cov_vjp.launches)
    assert all(b > a for a, b in zip(before, after))
    assert parts.params.dtype == torch.float32
    smc.validate_particles(parts, cfg)
    live = parts.lml > smc.BAD_LML
    data = smc.make_dataset(ts, xs, dtype=torch.float64, device="cpu")
    ref = TM.lml(parts.node_type[live].cpu(),
                 parts.params[live].cpu().double(),
                 parts.noise_z[live].cpu().double(), data.ts, data.xs,
                 data.mask, cfg, TM.prior_tables(cfg, "cpu", torch.float64))
    rel = (parts.lml[live].cpu().double() - ref).abs() / ref.abs()
    assert float(rel.max()) <= 1e-3


def test_config2_sweeps_on_card_rescored_on_cpu(cuda):
    """config2_sweeps (BASELINE config 2, 20 sweeps at N = 500): every
    sweep runs, the final LML within 1e-3 of float64 on the CPU."""
    from autogp_tpu_torch.inference import smc
    from autogp_tpu_torch.scripts import experiment_hmc
    r = experiment_hmc.config2_sweeps(cuda)
    assert r["n_sweeps"] == 20 and r["ms"] > 0
    ts, xs, _, cfg = experiment_hmc.config2_problem()
    data = smc.make_dataset(ts, xs, dtype=torch.float64, device="cpu")
    ref = float(TM.lml(r["node_type"].cpu(), r["params_z"].cpu().double(),
                       r["noise_z"].cpu().double(), data.ts, data.xs,
                       data.mask, cfg,
                       TM.prior_tables(cfg, "cpu", torch.float64))[0])
    assert abs(float(r["lml"][0]) - ref) <= 1e-3 * abs(ref)


def test_kernel5_shard_given_the_whole_batch_is_bitwise(cuda):
    """Kernels 5, 5c, 5b and 7 on a 32-row shard of a [64, 1024, 1024]
    batch, on the other half and on every fifth row (a compacted HMC
    sweep's live lanes), each given part_batch = 64: every particle's
    gradient torch.equal to its row of the whole batch's
    (scripts/batch_bits.kernel5_shards)."""
    from autogp_tpu_torch.scripts import batch_bits
    res = batch_bits.kernel5_shards(cuda, N=1024)
    assert len(res) == 12
    assert all(n_bad == 0 for _, _, _, n_bad in res), res


@pytest.mark.parametrize("N1,N2,gram,lower_only", [
    (200, 200, True, False), (256, 256, True, True), (100, 37, False, False)])
def test_cov_kernel_f64_matches_plain(cuda, N1, N2, gram, lower_only):
    """Kernel 1's float64 entry (csrc/cov_tape_f64.cu) on 16 prior trees
    of depth cap 8 against its plain version in float64 on the same
    inputs: per-particle normwise <= 1e-12, gram and cross modes, masked
    rows, one launch counted."""
    f64 = torch.float64
    cfg = C.GPConfig(max_depth=8)
    tab = TM.prior_tables(cfg, cuda, f64)
    gen = torch.Generator(device=cuda).manual_seed(N1 + N2)
    nt, pz = TM.sample_tree(gen, 16, tab, f64, cuda)
    pt = TM.transform_params(nt, pz, tab)
    noise = TM.transform_noise(torch.randn(16, generator=gen, device=cuda,
                                           dtype=f64), cfg)
    t1 = torch.rand(N1, generator=gen, device=cuda, dtype=f64).sort().values
    t2 = t1 if gram else torch.rand(N2, generator=gen, device=cuda,
                                    dtype=f64)
    m1 = (torch.arange(N1, device=cuda) < 3 * N1 // 4).to(f64)
    m2 = m1 if gram else torch.ones(N2, device=cuda, dtype=f64)
    before = cov.f64_launches
    K = cov.cov_tape(nt, pt, noise, t1, t2, m1, m2, cfg.depth_cap, gram,
                     lower_only)
    torch.cuda.synchronize()
    assert cov.f64_launches == before + 1 and K.dtype == f64
    Kp = cov.cov_tape_plain(nt, pt, noise, t1, t2, m1, m2, cfg.depth_cap,
                            gram, lower_only)
    err = (K - Kp).abs().amax((1, 2)) / Kp.abs().amax((1, 2))
    assert float(err.max()) <= 1e-12


def test_decompose_fragment_lmls_match_f64_cpu(cuda):
    """decompose on the card: every fragment LML that float64 finds finite
    on the CPU (the model carried over by to_dict / from_dict) is finite
    and within 1e-3 (kernel 1's float64 entry and a float64 Cholesky)."""
    import numpy as np
    import autogp_tpu_torch as A
    t = np.arange(512, dtype=np.float64)
    y = np.sin(2 * np.pi * t / 52) + 0.02 * t
    A.seed(5)
    m = A.GPModel(t, y, n_particles=16)
    before = cov.f64_launches
    got = np.concatenate([s.particles.lml.double().cpu().numpy()
                          for s in A.decompose(m)])
    assert cov.f64_launches == before + 16
    ref = A.from_dict(A.to_dict(m), device="cpu", dtype=torch.float64)
    want = np.concatenate([s.particles.lml.numpy()
                           for s in A.decompose(ref)])
    fin = np.isfinite(want)
    assert np.isfinite(got[fin]).all()
    assert (np.abs(got[fin] - want[fin]) <= 1e-3 * np.abs(want[fin])).all()
