"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`; every test skips when torch.cuda.is_available() is False
(decided in a fixture, never at import). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m gpu
"""

import warnings

import pytest
import torch

from autogp_tpu_torch import config as C
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


def _spd(dev, P, N, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn(P, N, N, generator=gen, device=dev, dtype=torch.float64)
    K = X @ X.mT / N + torch.eye(N, device=dev, dtype=torch.float64)
    return K, torch.randn(P, N, generator=gen, device=dev,
                          dtype=torch.float64)


@pytest.mark.parametrize("N", [32, 256])
def test_kinv_kernel_matches_plain(cuda, N):
    """kinv_beta_strips and linv_stats_wd on the card against the plain
    version in float64 on the same float32 factor: normwise 1e-4 for the
    lower K^-1 and beta, 1e-5 for ||L^-1||_F^2 (float32 FMA on grams of
    condition number <= 5); strictly-upper blocks exactly 0."""
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
