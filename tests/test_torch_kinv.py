"""Kernels 3-4 (autogp_tpu_torch.ops.kinv) and the factor contract they
consume (ops/chol.py's strips entry), held to the JAX package on
the CPU in float64.

On a CPU tensor the port runs the plain versions; the JAX side runs the
Pallas kinv kernel in interpret mode with fast=False (the bf16x3 `dot3`
split would round float64 inputs through bf16, tests/test_pallas.py:
269-292) and its XLA chain `_chain_one`, and the Pallas Cholesky driver in
interpret mode, as tests/test_chol_variants.py does. The CUDA kernel is
held to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py). Inputs are made with numpy from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autogp_tpu.ops import chol_pallas, kinv_pallas
from autogp_tpu_torch import gp_math as TG
from autogp_tpu_torch.ops import chol, kinv

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


def _spd(P, N, seed):
    """Well-conditioned SPD batches (eigenvalues in [N, ~5N]) and RHS."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((P, N, N))
    return A @ np.swapaxes(A, 1, 2) + N * np.eye(N), \
        rng.standard_normal((P, N))


def _upper_blocks(N):
    B = min(N, chol.BLOCK)
    blk = np.arange(N) // B
    return blk[None, :] > blk[:, None]


@pytest.mark.parametrize("want_kinv", [True, False],
                         ids=["kinv_beta_strips", "linv_stats_wd"])
def test_kinv_matches_pallas_interpret_and_chain(want_kinv):
    """Both entries against kinv_pallas._launch(interpret=True,
    fast=False) and the XLA chain, P=2, N=256, on the same float64 factor
    and Wd: rtol 1e-10 -- the same algebra (block substitution vs a
    triangular solve, different summation orders) on grams of condition
    number ~5, where float64 rounding stays near 1e-14."""
    P, N = 2, 256
    K, x = _spd(P, N, seed=3)
    d, a, wd, L = chol.chol_solve_strips(torch.tensor(K), torch.tensor(x))
    Lj, aj, wdj = jnp.asarray(L.numpy()), jnp.asarray(a.numpy()), \
        jnp.asarray(wd.numpy())
    jk = kinv_pallas._launch(Lj, aj, want_kinv=want_kinv, interpret=True,
                             fast=False, wd=wdj)
    kc, bc, fc = jax.vmap(kinv_pallas._chain_one)(Lj, aj)
    if want_kinv:
        Ki, beta, fro = kinv.kinv_beta_strips(a, wd, L)
        kf = np.asarray(jk[0])
        for ref in (kf, np.asarray(kc)):
            np.testing.assert_allclose(np.tril(Ki.numpy()), np.tril(ref),
                                       rtol=1e-10, atol=1e-13)
        jb, jf = jk[1], jk[2]
    else:
        beta, fro = kinv.linv_stats_wd(L, a, wd)
        jb, jf = jk
    for rb, rf in ((jb, jf), (bc, fc)):
        np.testing.assert_allclose(beta.numpy(), np.asarray(rb), rtol=1e-10,
                                   atol=1e-13)
        np.testing.assert_allclose(fro.numpy(), np.asarray(rf), rtol=1e-10)


@pytest.mark.parametrize("N", [64, 256])
def test_kinv_lower_only_contract(N):
    """Strictly-upper B x B blocks of K^-1 are exactly 0; on and below the
    diagonal blocks it is K^-1 (rtol 1e-10, float64); one block (N <= 128)
    gives the dense K^-1; the entry is gp_math.kinv_from_linv of the
    plain L^-1."""
    K, x = _spd(2, N, seed=N)
    _, a, wd, L = chol.chol_solve_strips(torch.tensor(K), torch.tensor(x))
    Ki = kinv.kinv_beta_strips(a, wd, L)[0].numpy()
    up = _upper_blocks(N)
    assert (Ki[:, up] == 0).all()
    ref = np.linalg.inv(K)
    np.testing.assert_allclose(np.where(up, 0.0, Ki),
                               np.where(up, 0.0, ref), rtol=1e-10,
                               atol=1e-14)
    plain = TG.kinv_from_linv(kinv.linv_plain(L)).numpy()
    np.testing.assert_array_equal(plain, Ki)


def test_wd_and_strips_match_jax_driver():
    """chol_solve_strips against cholesky_solve_strips_batched and
    cholesky_solve_wd_batched (interpret=True) at P=2, N=256: L (the JAX
    strips reassembled, and the wd entry's L), alpha, Wd and diag within
    1e-10 (float64, the same one-level blocked algorithm); diag and alpha
    bitwise those of chol_solve_diag (one driver)."""
    P, N = 2, 256
    K, x = _spd(P, N, seed=7)
    Kt, xt = torch.tensor(K), torch.tensor(x)
    jd, ja, jwd, *strips = chol_pallas.cholesky_solve_strips_batched(
        jnp.asarray(K), jnp.asarray(x), interpret=True)
    jL = chol_pallas.strips_to_l(tuple(strips))
    wL, wa, wwd = chol_pallas.cholesky_solve_wd_batched(
        jnp.asarray(K), jnp.asarray(x), interpret=True)
    d, a, wd, L = chol.chol_solve_strips(Kt, xt)
    for got, want in ((L, jL), (a, ja), (wd, jwd), (d, jd), (L, wL),
                      (a, wa), (wd, wwd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-12)
    dv, av = chol.chol_solve_diag(Kt, xt)
    assert torch.equal(d, dv) and torch.equal(a, av)
