"""The precision of the kinv kernel's tile products (csrc/kinv.cu), on the
CPU: its block substitution and its K^-1 product run in emulated 3xTF32
arithmetic.

`linv_kernel` forms L^-1 on the tensor cores: every operand x of a tile
product is split into hi = tf32(x) (round to nearest, 10 mantissa bits) and
lo = tf32(x - hi), and the product takes lo*hi' + hi*lo' + hi*hi' with
float32 sums. Here the same split runs in float32 on the CPU (the TF32
rounding done on the bit pattern), the products as float32 matmuls, in the
kernel's order: X[j, j] = Wd[j], X[k, j] = -Wd[k] (sum_{j<=m<k} L[k, m]
X[m, j]), B = 128. On grams of prior trees at N = 256 (numpy seed) the
result is held to the float64 plain version on the same float32 factor
with the gates of chip_smoke.py phase 5 (normwise 1e-4 for L^-1 and beta,
1e-5 for ||L^-1||_F^2) on the grams of condition number < 1e5; plain
1xTF32 (hi*hi' alone) misses them.

K^-1 = X^T X (kinv_lower_kernel, and kernel 5c's in-tape tiles, which
form the same elements) is emulated the same way, block (bi, bj <= bi)
contracting the rows >= B bi of the 3xTF32 X, and held at normwise 1e-4
on the lower triangle to the float64 plain version on the same float32
factor (phase 5's K^-1 gate) and to the JAX package's kinv_beta_strips
kernel run in interpret mode in float32, at HIGHEST precision (fast=False)
and at the reference's own bf16x3 (fast=True); a 1xTF32 product misses
the gate.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autogp_tpu.ops import kinv_pallas
from autogp_tpu_torch import config as C
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.ops import cov, kinv

N, B, P, DEPTH = 256, 128, 12, 5


def tf32(x):
    """Round float32 to TF32, to nearest with ties away from zero, as
    cvt.rna.tf32.f32 does: the low 13 mantissa bits are cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tc_matmul(a, b, passes):
    """a @ b from TF32 parts: passes=3 is the kernel's 3xTF32, passes=1
    plain TF32."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def linv_blocked(L, wd, passes):
    """The kernel's block substitution: X = L^-1 [P, N, N], float32."""
    nb = L.shape[-1] // B
    X = torch.zeros_like(L)
    for j in range(nb):
        c = slice(j * B, (j + 1) * B)
        X[:, c, c] = wd[:, j]
        for k in range(j + 1, nb):
            r = slice(k * B, (k + 1) * B)
            S = tc_matmul(L[:, r, j * B:k * B], X[:, j * B:k * B, c], passes)
            X[:, r, c] = -tc_matmul(wd[:, k], S, passes)
    return X


def kinv_blocked(X, passes):
    """The kernel's K^-1 product from X = L^-1: block (bi, bj <= bi) =
    sum_{r >= B bi} X[r, bi]^T X[r, bj], strictly-upper blocks 0; float32."""
    K = torch.zeros_like(X)
    for bi in range(X.shape[-1] // B):
        R = X[:, bi * B:, :]
        for bj in range(bi + 1):
            K[:, bi * B:(bi + 1) * B, bj * B:(bj + 1) * B] = tc_matmul(
                R[..., bi * B:(bi + 1) * B].mT, R[..., bj * B:(bj + 1) * B],
                passes)
    return K


def lower_normwise(a, b):
    """Max over particles of max|tril(a - b)| / max|tril(b)|."""
    a, b = torch.tril(a).double(), torch.tril(b).double()
    return float(((a - b).abs().flatten(1).amax(1)
                  / b.abs().flatten(1).amax(1)).max())


def prior_grams():
    """Float64 grams [P, N, N] (noise included) of random prior-shaped
    trees (depth <= 5, ChangePoints allowed) on N sorted points, and their
    condition numbers."""
    rng = np.random.default_rng(20261017)
    M = (1 << DEPTH) - 1
    nt = np.zeros((P, M), np.int64)
    pz = np.zeros((P, M, C.MAX_PARAMS))

    def grow(p, idx, depth):
        if depth < DEPTH - 1 and rng.uniform() < 0.45:
            t = int(rng.choice(C.OP_CODES))
            grow(p, 2 * idx + 1, depth + 1)
            grow(p, 2 * idx + 2, depth + 1)
        else:
            t = int(rng.choice(C.LEAF_CODES))
        nt[p, idx] = t
        pz[p, idx, :C.PARAM_ARITY[t]] = rng.standard_normal(
            C.PARAM_ARITY[t])

    for p in range(P):
        grow(p, 0, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = C.GPConfig()
    tab = TM.prior_tables(cfg, "cpu", torch.float64)
    ntt = torch.as_tensor(nt)
    pt = TM.transform_params(ntt, torch.as_tensor(pz), tab)
    noise = TM.transform_noise(torch.as_tensor(rng.standard_normal(P) - 2.0),
                               cfg)
    ts = torch.as_tensor(np.sort(rng.uniform(0.0, 1.0, N)))
    mask = torch.ones(N, dtype=torch.float64)
    K = cov.cov_tape_plain(ntt, pt, noise, ts, ts, mask, mask, DEPTH, True,
                           False)
    return K, torch.linalg.cond(K), rng.standard_normal((P, N))


@pytest.fixture(scope="module")
def case():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    K, cond, x = prior_grams()
    L, info = torch.linalg.cholesky_ex(K.float())
    ok = (info == 0) & (cond < 1e5)
    L, cond = L[ok], cond[ok]
    alpha = torch.linalg.solve_triangular(
        L, torch.as_tensor(x, dtype=torch.float32)[ok][..., None],
        upper=False)[..., 0]
    eye = torch.eye(B, dtype=torch.float32)
    wd = torch.stack([torch.linalg.solve_triangular(
        L[:, s:s + B, s:s + B], eye.expand(len(L), B, B), upper=False)
        for s in range(0, N, B)], dim=1)
    ref = kinv.linv_beta_plain(L.double(), alpha.double())
    yield L, alpha, wd, cond, ref
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_persistent_cache():
    """Interpret-mode pallas_call executables segfault the persistent
    compile cache (see tests/test_pallas.py); keep them out of it."""
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def _errors(L, alpha, wd, ref, passes):
    X = linv_blocked(L, wd, passes)
    beta = (X.mT @ alpha[..., None])[..., 0]
    fro = (X.double() ** 2).sum((-2, -1))
    Vr, br, fr = ref

    def normwise(a, b):
        return float(((a.double() - b).abs().flatten(1).amax(1)
                      / b.abs().flatten(1).amax(1)).max())
    return (normwise(X, Vr), normwise(beta, br),
            float(((fro - fr) / fr).abs().max()))


def test_prior_grams_are_real(case):
    """At least 8 of the 12 grams factor in float32 with condition < 1e5,
    spread over decades (the numbers are in the assertion message)."""
    cond = case[3]
    assert len(cond) >= 8, cond
    assert float(cond.max()) / float(cond.min()) > 10, cond.tolist()


def test_tf32x3_meets_the_kinv_gates(case):
    """3xTF32 L^-1, beta and ||L^-1||_F^2 within phase 5's gates of the
    float64 plain version on the same float32 factor."""
    L, alpha, wd, cond, ref = case
    e = _errors(L, alpha, wd, ref, passes=3)
    msg = f"errors {e}, conditions {sorted(cond.tolist())}"
    assert e[0] <= 1e-4 and e[1] <= 1e-4 and e[2] <= 1e-5, msg


def test_tf32x1_misses_the_kinv_gates(case):
    """Plain TF32 (one hi*hi' product) misses at least one of them: why
    the kernel pays for three tensor-core products per FP32 product."""
    L, alpha, wd, cond, ref = case
    e = _errors(L, alpha, wd, ref, passes=1)
    assert e[0] > 1e-4 or e[1] > 1e-4 or e[2] > 1e-5, e


def test_kinv_product_tf32x3_meets_the_gate(case):
    """The 3xTF32 K^-1 product of the 3xTF32 L^-1 within phase 5's K^-1
    gate (normwise 1e-4, lower triangle) of the float64 plain version on
    the same float32 factor."""
    L, alpha, wd, cond, _ = case
    ref = kinv.kinv_beta_plain(L.double(), alpha.double())[0]
    e = lower_normwise(kinv_blocked(linv_blocked(L, wd, 3), 3), ref)
    assert e <= 1e-4, f"error {e}, conditions {sorted(cond.tolist())}"


@pytest.mark.parametrize("fast", [False, True], ids=["highest", "bf16x3"])
def test_kinv_product_tf32x3_matches_pallas_interpret(case, fast):
    """The same K^-1 against autogp_tpu's kinv_beta_strips kernel
    (_launch_strips, interpret=True) on the same float32 strips, Wd and
    alpha: normwise 1e-4 on the lower triangle, with the reference's
    contractions at HIGHEST (fast=False, as tests/test_torch_kinv.py runs
    it) and at its own gradient precision, bf16x3 (fast=True)."""
    L, alpha, wd, cond, _ = case
    strips = tuple(jnp.asarray(L[:, k * B:, k * B:(k + 1) * B].numpy())
                   for k in range(N // B))
    kj = kinv_pallas._launch_strips(jnp.asarray(alpha.numpy()),
                                    jnp.asarray(wd.numpy()), strips,
                                    interpret=True, fast=fast)[0]
    kj = torch.as_tensor(np.array(kj))
    assert kj.dtype == torch.float32
    e = lower_normwise(kinv_blocked(linv_blocked(L, wd, 3), 3), kj)
    assert e <= 1e-4, f"error {e}, conditions {sorted(cond.tolist())}"


def test_kinv_product_tf32x1_misses_the_gate(case):
    """A plain TF32 K^-1 product (hi*hi' alone), even of the 3xTF32 L^-1,
    misses the 1e-4 gate: why both K^-1 kernels pay for three products."""
    L, alpha, wd, _, _ = case
    ref = kinv.kinv_beta_plain(L.double(), alpha.double())[0]
    e = lower_normwise(kinv_blocked(linv_blocked(L, wd, 3), 1), ref)
    assert e > 1e-4, e
