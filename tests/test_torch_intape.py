"""The in-tape L^-1 backend of the LML gradient, held to the JAX package on
the CPU in float64: `gp_math.diag_blocks` / `tri_inv_blocked`, the kinv
kernel's L^-1 output and its entries without Wd (`kinv.linv_beta`,
`kinv_beta`, `linv_stats`), the tape backward's in-tape mode
(`cov_vjp.cov_tape_bwd_linv`) and the A/B script over both backends.

On a CPU tensor the port runs the plain versions; the JAX side runs the
Pallas kernels in interpret mode (the kinv kernel with fast=False: the
bf16x3 split would round float64 inputs through bf16) and its XLA
fallbacks. `LmlTapeFused` with `INTAPE_LINV` on against the JAX package's
`lml_tape_fused` is a case of tests/test_torch_fused.py. The CUDA kernels
are held to their plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py). Inputs are made with numpy from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autogp_tpu import gp_math as JG
from autogp_tpu.ops import cov_pallas_vjp, kinv_pallas
from autogp_tpu_torch import gp_math as TG
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv
from autogp_tpu_torch.scripts import bench_grad_ab
from test_torch_grad import _cfg, _data, mixed_trees
from test_torch_kinv import _spd

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


@pytest.mark.parametrize("shape", [(2, 256, 256), (2, 2, 128, 128)],
                         ids=["matrix", "diag-blocks"])
def test_tri_inv_blocked_matches_jax(shape):
    """tri_inv_blocked against the JAX function on lower factors of
    well-conditioned grams (a batch of matrices, and the [P, nb, B, B]
    diagonal blocks the kinv entries invert): within 1e-10 of the largest
    entry, exact zeros above the diagonal; diag_blocks is bitwise
    JAX's _diag_blocks."""
    *batch, n, _ = shape
    K, _ = _spd(int(np.prod(batch)), n, seed=n + len(shape))
    L = np.linalg.cholesky(K).reshape(shape)
    got = TG.tri_inv_blocked(torch.tensor(L)).numpy()
    want = np.asarray(JG.tri_inv_blocked(jnp.asarray(L)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    assert (np.triu(got, 1) == 0).all()
    Lm = L.reshape(-1, n, n)
    np.testing.assert_array_equal(
        TG.diag_blocks(torch.tensor(Lm), 64).numpy(),
        np.asarray(JG._diag_blocks(jnp.asarray(Lm), 64)))


@pytest.mark.parametrize("entry", ["linv_beta", "kinv_beta", "linv_stats"])
def test_wd_free_entries_match_pallas_interpret_and_xla(entry):
    """The three entries against kinv_pallas._launch(interpret=True,
    fast=False) without wd (want_v=True for linv_beta) and against the XLA
    fallbacks _linv_one / _chain_one / _stats_one, at P=2, N=256: rtol
    1e-10 (float64, the same algebra in other summation orders, on grams
    of condition number ~5). L^-1's strict upper is exactly 0, and
    linv_beta's beta and fro are linv_stats_wd's."""
    P, N = 2, 256
    K, x = _spd(P, N, seed=11)
    _, a, wd, L = chol.chol_solve_strips(torch.tensor(K), torch.tensor(x))
    Lj, aj = jnp.asarray(L.numpy()), jnp.asarray(a.numpy())
    launch = dict(linv_beta=dict(want_kinv=False, want_v=True),
                  kinv_beta=dict(want_kinv=True),
                  linv_stats=dict(want_kinv=False))[entry]
    xla = dict(linv_beta=kinv_pallas._linv_one,
               kinv_beta=kinv_pallas._chain_one,
               linv_stats=kinv_pallas._stats_one)[entry]
    refs = (kinv_pallas._launch(Lj, aj, interpret=True, fast=False,
                                **launch),
            jax.vmap(xla)(Lj, aj))
    got = getattr(kinv, entry)(L, a)
    for ref in refs:
        if entry != "linv_stats":
            gm, rm = got[0].numpy(), np.asarray(ref[0])
            if entry == "kinv_beta":        # lower-only: the lower triangle
                gm, rm = np.tril(gm), np.tril(rm)
            np.testing.assert_allclose(gm, rm, rtol=1e-10, atol=1e-13)
        for gs, rs in zip(got[-2:], ref[-2:]):     # beta, fro
            np.testing.assert_allclose(gs.numpy(), np.asarray(rs),
                                       rtol=1e-10, atol=1e-13)
    if entry == "linv_beta":
        V = got[0].numpy()
        assert (np.triu(V, 1) == 0).all()
        b2, f2 = kinv.linv_stats_wd(L, a, wd)
        assert torch.equal(got[1], b2) and torch.equal(got[2], f2)


def test_tape_bwd_linv_plain_matches_pallas():
    """cov_tape_bwd_linv (plain on the CPU: kernel 5's plain version on
    kinv_from_linv(V)) against _cov_grads_tape(beta=, gscale=, sym=True,
    linv=True, interpret=True), which forms each K^-1 tile from two
    column strips of V, per particle on depth-3 trees at N=128: rtol 1e-9
    of each particle's largest entry (float64; autograd of the covariance
    against the hand-written derivatives)."""
    N, depth = 128, 3
    cfg, _ = _cfg(depth)
    tab = TM.prior_tables(cfg, "cpu", F64)
    nt, pz = mixed_trees(5, depth)
    ts, _, mask = _data(N, seed=5)
    ntt = torch.as_tensor(nt)
    pt = TM.transform_params(ntt, torch.as_tensor(pz), tab)
    noise = torch.full((len(nt),), 0.2)
    tst, mt = torch.as_tensor(ts), torch.as_tensor(mask)
    Kg = cov.cov_tape(ntt, pt, noise, tst, tst, mt, mt, depth, True, True)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(N)) * mt
    _, a, wd, L = chol.chol_solve_strips(Kg, x.expand(len(nt), N))
    V, beta, _ = kinv.linv_beta(L, a, wd)
    g = torch.as_tensor(np.linspace(-0.5, 1.5, len(nt)))
    pbar, nbar = cov_vjp.cov_tape_bwd_linv(ntt, pt, tst, mt, V, beta, g,
                                           depth)

    def one(n, p, v, b, gg):
        return cov_pallas_vjp._cov_grads_tape(
            n, p, v, jnp.asarray(ts), jnp.asarray(mask), depth, masked=True,
            interpret=True, beta=b, gscale=gg, sym=True, linv=True)
    jp, jn = jax.vmap(one)(*(jnp.asarray(t.numpy())
                             for t in (ntt, pt, V, beta, g)))
    jp = np.asarray(jp)
    for i in range(len(nt)):
        np.testing.assert_allclose(pbar[i].numpy(), jp[i], rtol=0,
                                   atol=1e-9 * np.abs(jp[i]).max())
    np.testing.assert_allclose(nbar.numpy(), np.asarray(jn), rtol=1e-9)


def test_bench_grad_ab_backends_agree_on_cpu():
    """The A/B script's two backends on the CPU (plain versions): one
    forward, so the values agree exactly, and the same K^-1 from L^-1, so
    the gradients do too; no time is measured off the card."""
    r = bench_grad_ab.run(N=64, P=4, reps=1, device="cpu")
    assert r["ms"] == {False: None, True: None}
    assert r["n_finite"] == 4
    assert r["value_max_abs_diff"] == 0.0
    assert r["param_grad_rel"] == 0.0 and r["noise_grad_rel"] == 0.0
    assert cov_vjp.INTAPE_LINV is False
