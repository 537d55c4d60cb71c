"""The dense gradient route of the port, held to the JAX package on the CPU
in float64: the per-slot assembly `cov_matrix` (kernel 6's plain version)
against the Pallas kernel in interpret mode, `cov_matrix_diff` in both
forms (kernels 5b and 7's plain version) against the Pallas backward
kernels under jax.vjp, `mvn_logpdf_masked_cvjp` against the JAX rule,
`model.lml` on the route it takes at N = 32 and at an N that is not a
power of two, and the blocked Cholesky's ragged last panel.

Inputs are made with numpy from fixed seeds; trees cross packages as heap
arrays. Cotangents are random and not symmetric, and one mask is not a
prefix: `cov_matrix_diff` serves any cotangent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autogp_tpu import gp_math as JG
from autogp_tpu import model as JM
from autogp_tpu.ops import cov_pallas, cov_pallas_vjp
from autogp_tpu_torch import gp_math as TG
from autogp_tpu_torch import model as TM
from autogp_tpu_torch import tree as TT
from autogp_tpu_torch.ops import chol, cov, cov_vjp
from test_torch_grad import _cfg, _data, mixed_trees

F64 = torch.float64


@pytest.fixture(autouse=True)
def _torch_cpu_f64():
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


@pytest.fixture(autouse=True)
def _no_persistent_cache():
    """Interpret-mode pallas_call executables segfault the persistent
    compile cache (see tests/test_pallas.py); keep them out of it."""
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def _grid(N, seed, prefix=True):
    """(ts, mask): N sorted times; 3/4 of them active, as a prefix or
    scattered."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, 1, N))
    mask = np.zeros(N)
    if prefix:
        mask[:3 * N // 4] = 1.0
    else:
        mask[rng.permutation(N)[:3 * N // 4]] = 1.0
    return ts, mask


def _trees(depth, seed):
    cfg, _ = _cfg(depth)
    tab = TM.prior_tables(cfg, "cpu", F64)
    nt, pz = mixed_trees(seed, depth)
    ntt = torch.as_tensor(nt)
    pt = TM.transform_params(ntt, torch.as_tensor(pz), tab)
    noise = torch.as_tensor(np.linspace(0.05, 0.4, len(nt)))
    return ntt, pt, noise


@pytest.mark.parametrize("masked,depth", [(True, 5), (False, 3)])
def test_cov_matrix_matches_pallas(masked, depth):
    """cov.cov_matrix (plain on the CPU) against cov_matrix_batched(
    interpret=True) on the mixed batches with a scattered mask: rtol 1e-12
    of each particle's largest entry (float64, the same formulas)."""
    ntt, pt, noise = _trees(depth, seed=3)
    ts, mask = _grid(64, seed=3, prefix=False)
    K = cov.cov_matrix(ntt, pt, noise, torch.as_tensor(ts),
                       torch.as_tensor(mask), depth, masked=masked)
    Kj = np.asarray(cov_pallas.cov_matrix_batched(
        jnp.asarray(ntt.numpy()), jnp.asarray(pt.numpy()),
        jnp.asarray(noise.numpy()), jnp.asarray(ts), jnp.asarray(mask), depth,
        masked=masked, interpret=True))
    for i in range(len(Kj)):
        np.testing.assert_allclose(K[i].numpy(), Kj[i], rtol=0,
                                   atol=1e-12 * np.abs(Kj[i]).max())
    if masked:
        off = mask == 0
        np.testing.assert_array_equal(K[0].numpy()[off][:, off],
                                      np.eye(int(off.sum())))


@pytest.mark.parametrize("tape", [True, False], ids=["tape", "slot"])
@pytest.mark.parametrize("masked", [True, False])
def test_cov_matrix_diff_matches_pallas(tape, masked):
    """cov_matrix_diff's value and its (params_t, noise) gradients under a
    random non-symmetric cotangent and a scattered mask, against
    cov_pallas_vjp.cov_matrix_diff(interpret=True, tape=...) under jax.vjp:
    rtol 1e-9 of each particle's largest entry (autograd of the plain
    covariance against the hand-written guarded derivatives)."""
    depth = 5 if tape else 3   # the per-slot kernel unrolls all M slots
    ntt, pt, noise = _trees(depth, seed=5)
    ts, mask = _grid(32, seed=5, prefix=False)
    P = len(ntt)
    kbar = np.random.default_rng(6).standard_normal((P, 32, 32))
    ptg, nzg = pt.clone().requires_grad_(True), noise.clone().requires_grad_()
    K = cov_vjp.cov_matrix_diff(ntt, ptg, nzg, torch.as_tensor(ts),
                                torch.as_tensor(mask), depth, masked=masked,
                                tape=tape)
    pbar, nbar = torch.autograd.grad(K, (ptg, nzg),
                                     grad_outputs=torch.as_tensor(kbar))

    def one(n, p, z, kb):
        Kj, vjp = jax.vjp(
            lambda pp, zz: cov_pallas_vjp.cov_matrix_diff(
                n, pp, zz, jnp.asarray(ts), jnp.asarray(mask), depth,
                masked=masked, interpret=True, tape=tape), p, z)
        return (Kj,) + vjp(kb)
    Kj, jp, jn = jax.vmap(one)(jnp.asarray(ntt.numpy()),
                               jnp.asarray(pt.numpy()),
                               jnp.asarray(noise.numpy()), jnp.asarray(kbar))
    Kj, jp = np.asarray(Kj), np.asarray(jp)
    for i in range(P):
        np.testing.assert_allclose(K[i].detach().numpy(), Kj[i], rtol=0,
                                   atol=1e-12 * np.abs(Kj[i]).max())
        np.testing.assert_allclose(pbar[i].numpy(), jp[i], rtol=0,
                                   atol=1e-9 * np.abs(jp[i]).max())
    np.testing.assert_allclose(nbar.numpy(), np.asarray(jn), rtol=1e-9)


def test_cov_grads_forms_agree():
    """The two backward entries share one plain version on the CPU and
    one contract: same gradients from `cov_grads_tape` and `cov_grads`,
    zero at inactive parameter slots, and the noise gradient is the masked
    trace of the cotangent."""
    ntt, pt, _ = _trees(5, seed=8)
    ts, mask = _grid(40, seed=8)
    kbar = torch.as_tensor(
        np.random.default_rng(9).standard_normal((len(ntt), 40, 40)))
    tst, mt = torch.as_tensor(ts), torch.as_tensor(mask)
    a = cov_vjp.cov_grads_tape(ntt, pt, kbar, tst, mt, 5, masked=True)
    b = cov_vjp.cov_grads(ntt, pt, kbar, tst, mt, 5, masked=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (a[0].numpy()[TT.param_mask(ntt).numpy() == 0] == 0).all()
    np.testing.assert_allclose(
        a[1].numpy(),
        (torch.diagonal(kbar, dim1=1, dim2=2) * mt).sum(1).numpy(),
        rtol=1e-12)


@pytest.mark.parametrize("N", [32, 128])
@pytest.mark.parametrize("pregram", [True, False])
def test_mvn_logpdf_cvjp_matches_jax_rule(N, pregram):
    """mvn_logpdf_masked_cvjp's value and its (Kbar, xbar) against the
    JAX custom-VJP rule on SPD grams, at N = 32 (dense solves against the
    identity) and N = 128 (the blocked inverse): rtol 1e-9 of the largest
    entry; the value is bitwise `mvn_logpdf_masked`'s."""
    rng = np.random.default_rng(N)
    P = 3
    X = rng.standard_normal((P, N, N))
    K = X @ X.transpose(0, 2, 1) / N + np.eye(N)
    _, mask = _grid(N, seed=N)
    x = rng.standard_normal((P, N)) * mask
    g = np.array([1.0, -0.7, 2.5])
    if pregram:
        m2 = mask[:, None] * mask[None, :]
        K = np.where(m2 > 0, K, np.eye(N))
    Kt = torch.as_tensor(K).requires_grad_(True)
    xt = torch.as_tensor(x).requires_grad_(True)
    mt = torch.as_tensor(mask)
    v = TG.mvn_logpdf_masked_cvjp(Kt, xt, mt, pregram)
    Kbar, xbar = torch.autograd.grad(v, (Kt, xt),
                                     grad_outputs=torch.as_tensor(g))
    v0 = TG.mvn_logpdf_masked(
        TG.masked_gram(torch.as_tensor(K), mt), torch.as_tensor(x[0]), mt)
    assert torch.equal(v.detach()[0], v0[0])

    def one(Kj, xj, gj):
        vj, vjp = jax.vjp(lambda a, b: JG.mvn_logpdf_masked_cvjp(
            a, b, jnp.asarray(mask), pregram), Kj, xj)
        return (vj,) + vjp(gj)
    vj, Kbj, xbj = jax.vmap(one)(jnp.asarray(K), jnp.asarray(x),
                                 jnp.asarray(g))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(vj),
                               rtol=1e-10)
    Kbj = np.asarray(Kbj)
    np.testing.assert_allclose(Kbar.numpy(), Kbj, rtol=0,
                               atol=1e-9 * np.abs(Kbj).max())
    np.testing.assert_allclose(xbar.numpy(), np.asarray(xbj), rtol=0,
                               atol=1e-9 * np.abs(np.asarray(xbj)).max())
    # A shared x [N] gets the cotangents of all particles, summed.
    xs = torch.as_tensor(x[0]).requires_grad_(True)
    vs = TG.mvn_logpdf_masked_cvjp(torch.as_tensor(K), xs, mt, pregram)
    (xsb,) = torch.autograd.grad(vs.sum(), xs)
    assert xsb.shape == (N,)


@pytest.mark.parametrize("N", [32, 200])
def test_lml_dense_route_matches_jax_x64(N, monkeypatch):
    """model.lml under grad at N = 32 and N = 200 takes cov_matrix_diff +
    mvn_logpdf_masked_cvjp (never LmlTapeFused); its value is bitwise the
    value path's and value and z-space gradient match jax.grad of the JAX
    package's XLA LML (pallas=False) in x64: rtol 1e-8 of each particle's
    largest entry (a blocked factor with a ragged last panel and the
    closed-form cotangent against autodiff through a dense one)."""
    def no_fused(*a, **k):
        raise AssertionError("LmlTapeFused on a bucket it must not take")
    monkeypatch.setattr(cov_vjp.LmlTapeFused, "apply", no_fused)
    cfg, jcfg = _cfg(depth=3)
    tab, jtab = TM.prior_tables(cfg, "cpu", F64), JM.prior_tables(jcfg)
    nt, pz = mixed_trees(N, depth=3)
    ts, xs, mask = _data(N, seed=N)
    ntt, pzt = torch.as_tensor(nt), torch.as_tensor(pz)
    nz = torch.as_tensor(np.linspace(-2.0, 0.5, len(nt)))
    tst, xst, mt = map(torch.as_tensor, (ts, xs, mask))
    v0 = TM.lml(ntt, pzt, nz, tst, xst, mt, cfg, tab)
    pzg, nzg = pzt.clone().requires_grad_(True), nz.clone().requires_grad_()
    v = TM.lml(ntt, pzg, nzg, tst, xst, mt, cfg, tab)
    assert torch.equal(v.detach(), v0)
    gp, gn = torch.autograd.grad(v.sum(), (pzg, nzg))
    vg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda n, p, z: JM.lml(n, p, z, jnp.asarray(ts), jnp.asarray(xs),
                               jnp.asarray(mask), jcfg, jtab, pallas=False),
        argnums=(1, 2))))
    vj, (gpj, gnj) = vg(jnp.asarray(nt), jnp.asarray(pz), jnp.asarray(nz))
    np.testing.assert_allclose(v0.numpy(), np.asarray(vj), rtol=1e-10)
    gpj = np.asarray(gpj)
    for i in range(len(nt)):
        np.testing.assert_allclose(gp[i].numpy(), gpj[i], rtol=0,
                                   atol=1e-8 * np.abs(gpj[i]).max())
    np.testing.assert_allclose(gn.numpy(), np.asarray(gnj), rtol=1e-8)
    # The noise-HMC fallback at these buckets is autograd of the same lml.
    vn, gnn = TM.lml_value_and_noise_grad(ntt, pzt, nz, tst, xst, mt, cfg,
                                          tab)
    assert torch.equal(vn, v0)
    np.testing.assert_allclose(gnn.numpy(), np.asarray(gnj), rtol=1e-8)


def test_lml_fused_route_kept_for_power_of_two_buckets(monkeypatch):
    """At N = 64 (a power of two >= 64) model.lml under grad still takes
    LmlTapeFused, as autogp_tpu/model.py:280-286 does."""
    def no_dense(*a, **k):
        raise AssertionError("cov_matrix_diff on a fused bucket")
    monkeypatch.setattr(cov_vjp, "cov_matrix_diff", no_dense)
    cfg, _ = _cfg(depth=3)
    tab = TM.prior_tables(cfg, "cpu", F64)
    nt, pz = mixed_trees(1, depth=3)
    ts, xs, mask = map(torch.as_tensor, _data(64, seed=1))
    pzg = torch.as_tensor(pz).requires_grad_(True)
    v = TM.lml(torch.as_tensor(nt), pzg, torch.zeros(len(nt)), ts, xs, mask,
               cfg, tab)
    (g,) = torch.autograd.grad(v.sum(), pzg)
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("N", [200, 129, 384, 40])
def test_ragged_last_panel_matches_dense_cholesky(N):
    """The blocked factorization with a last panel of N - 128 (nb - 1) columns
    (N = 200, 129), with full panels only (384) and with one narrow panel
    (40), against torch.linalg.cholesky and a triangular solve: rtol 1e-11
    of the largest entry (float64; the same factor by another order of
    operations). Only the lower triangle is read."""
    rng = np.random.default_rng(N)
    P = 3
    X = rng.standard_normal((P, N, N))
    K = torch.as_tensor(X @ X.transpose(0, 2, 1) / N + np.eye(N))
    x = torch.as_tensor(rng.standard_normal((P, N)))
    Kl = torch.tril(K) + torch.triu(torch.full_like(K, 7.0), 1)
    L, alpha = chol.chol_solve(Kl, x)
    d, alpha2 = chol.chol_solve_diag(Kl, x)
    Lr = torch.linalg.cholesky(K)
    ar = torch.linalg.solve_triangular(Lr, x[..., None], upper=False)[..., 0]
    np.testing.assert_allclose(L.numpy(), Lr.numpy(), rtol=0,
                               atol=1e-11 * float(Lr.abs().max()))
    np.testing.assert_allclose(alpha.numpy(), ar.numpy(), rtol=0,
                               atol=1e-11 * float(ar.abs().max()))
    assert torch.equal(alpha, alpha2)
    assert torch.equal(d, torch.diagonal(L, dim1=1, dim2=2))
    if N % min(N, chol.BLOCK):
        with pytest.raises(ValueError, match="Wd"):
            chol.chol_solve_strips(Kl, x)
