"""The LML gradient path of the port, held to the JAX package on the CPU in
float64: kernel 5's plain version (autogp_tpu_torch.ops.cov_vjp) against
the Pallas tape backward in interpret mode, `LmlTapeFused` (through
model.lml) against jax.grad of the XLA LML, and the analytic noise
gradient against autograd and the JAX function. `LmlTapeFused` against
`lml_tape_fused(interpret=True)` is in tests/test_torch_fused.py.

The depth-5 batch mixes tape lengths <= 19 and 21-31 (tapes are odd):
the JAX package dispatched its backward on that boundary (TAPE_CAP = 19);
the port has one route for every length. The comparison with XLA autodiff
uses depth-3 trees: XLA takes minutes to compile the depth-5 gradient on
the CPU. Inputs are made with numpy from fixed seeds; trees cross packages
as heap arrays.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autogp_tpu import config as JC
from autogp_tpu import model as JM
from autogp_tpu.ops import cov_pallas_vjp
from autogp_tpu_torch import config as C
from autogp_tpu_torch import kernels as K
from autogp_tpu_torch import model as TM
from autogp_tpu_torch import tree as TT
from autogp_tpu_torch.ops import chol, cov, cov_vjp, kinv

F64 = torch.float64
LEAVES = (C.CONSTANT, C.LINEAR, C.SQUARED_EXPONENTIAL, C.GAMMA_EXPONENTIAL,
          C.PERIODIC, C.WHITE_NOISE)


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


def _cfg(depth=5):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (C.GPConfig(static_max_depth=depth),
                JC.GPConfig(static_max_depth=depth))


def _full(d):
    return None if d == 1 else (_full(d - 1), _full(d - 1))


# Tree shapes (None = leaf, (l, r) = operator), their tape lengths and
# whether the root is a ChangePoint.
SHAPES = {5: [(_full(5), 31, False), ((_full(4), _full(2)), 19, False),
              ((_full(4), _full(3)), 23, True), ((_full(3), None), 9, False)],
          3: [(_full(3), 7, False), ((_full(2), None), 5, True),
              (None, 1, False)]}


def mixed_trees(seed, depth=5):
    """Heaps of SHAPES[depth] with random leaf types, Plus/Times (or a
    ChangePoint root) operators and N(0, 1) whitened params."""
    rng = np.random.default_rng(seed)
    shapes = SHAPES[depth]
    M = (1 << depth) - 1
    nt = np.zeros((len(shapes), M), np.int64)
    pz = np.zeros((len(shapes), M, C.MAX_PARAMS))

    def rec(i, idx, shape, cp_root):
        if shape is None:
            t = int(rng.choice(LEAVES))
        else:
            t = C.CHANGEPOINT if cp_root else int(rng.choice([C.PLUS,
                                                              C.TIMES]))
            rec(i, 2 * idx + 1, shape[0], False)
            rec(i, 2 * idx + 2, shape[1], False)
        nt[i, idx] = t
        pz[i, idx, :C.PARAM_ARITY[t]] = rng.standard_normal(C.PARAM_ARITY[t])

    for i, (shape, _, cp_root) in enumerate(shapes):
        rec(i, 0, shape, cp_root)
    return nt, pz


def _data(N, seed):
    rng = np.random.default_rng(seed)
    n = 3 * N // 4
    ts, xs, mask = np.zeros(N), np.zeros(N), np.zeros(N)
    ts[:n] = np.sort(rng.uniform(0, 1, n))
    xs[:n] = np.sin(6 * ts[:n]) + 0.1 * rng.standard_normal(n)
    mask[:n] = 1.0
    return ts, xs, mask


@pytest.mark.parametrize("depth", [3, 5])
def test_mixed_batch_tape_lengths(depth):
    nt, _ = mixed_trees(0, depth)
    tlen = cov.build_tape(torch.as_tensor(nt), depth)[4].numpy()
    np.testing.assert_array_equal(tlen, [n for _, n, _ in SHAPES[depth]])


@pytest.mark.parametrize("N", [64, 128])
def test_tape_bwd_plain_matches_pallas(N):
    """cov_tape_bwd (plain on the CPU) against _cov_grads_tape(beta=,
    gscale=, sym=True, interpret=True) on the mixed batch: rtol 1e-9 of
    each particle's largest entry. Both are float64; the port's plain
    version is autograd of the covariance, the JAX kernel the guarded
    hand-written derivatives summed over the lower triangle, which agree
    to rounding (the clamps at 1e-38 / 1e-30 bind only where a value has
    underflowed and its terms vanish)."""
    cfg, _ = _cfg()
    tab = TM.prior_tables(cfg, "cpu", F64)
    nt, pz = mixed_trees(N)
    ts, _, mask = _data(N, seed=N)
    ntt = torch.as_tensor(nt)
    pt = TM.transform_params(ntt, torch.as_tensor(pz), tab)
    noise = torch.full((len(nt),), 0.3)
    tst, mt = torch.as_tensor(ts), torch.as_tensor(mask)
    Kg = cov.cov_tape(ntt, pt, noise, tst, tst, mt, mt, 5, True, True)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(N)) * mt
    _, a, wd, L = chol.chol_solve_strips(Kg, x.expand(len(nt), N))
    Ki, beta, _ = kinv.kinv_beta_strips(a, wd, L)
    g = torch.as_tensor(np.linspace(-1.5, 2.0, len(nt)))
    pbar, nbar = cov_vjp.cov_tape_bwd(ntt, pt, tst, mt, Ki, beta, g, 5)
    # The JAX package's batched entry: its vmap rule launches
    # _cov_grads_tape(beta=, gscale=, sym=True) once per particle.
    grads = jax.vmap(cov_pallas_vjp._tape_grads_sym_fn(5, True),
                     in_axes=(0, 0, 0, 0, 0, None, None))
    jp, jn = grads(*(jnp.asarray(a.numpy()) for a in (ntt, pt, Ki, beta, g)),
                   jnp.asarray(ts), jnp.asarray(mask))
    jp = np.asarray(jp)
    for i in range(len(nt)):
        np.testing.assert_allclose(pbar[i].numpy(), jp[i], rtol=0,
                                   atol=1e-9 * np.abs(jp[i]).max())
    np.testing.assert_allclose(nbar.numpy(), np.asarray(jn), rtol=1e-9)


def test_lml_grad_matches_jax_x64():
    """model.lml under grad (LmlTapeFused) against jax.grad of the JAX
    package's XLA LML (pallas=False) in x64 at N=256, depth 3, in z-space: rtol
    1e-8 of each particle's largest entry (float64; a blocked factor and
    closed-form cotangent against autodiff through a dense one). The
    value under grad is bitwise the value-only route's, and inactive
    parameter slots get exactly zero gradient."""
    cfg, jcfg = _cfg(depth=3)
    tab, jtab = TM.prior_tables(cfg, "cpu", F64), JM.prior_tables(jcfg)
    nt, pz = mixed_trees(11, depth=3)
    ts, xs, mask = _data(256, seed=11)
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
    pmask = TT.param_mask(ntt).numpy()
    assert (gp.numpy()[pmask == 0] == 0).all()


def test_noise_grad_analytic_matches_autograd():
    """Port of tests/test_gp_math.py:233: the closed-form noise gradient
    (N=128, a power of two >= 64) against autograd of model.lml in
    noise_z, rtol 1e-8 (value 1e-10); from a K0 assembled once it is the
    same to 1e-12."""
    cfg, _ = _cfg()
    tab = TM.prior_tables(cfg, "cpu", F64)
    node = K.Linear(0.3, 1.1, 0.9) + K.Periodic(0.7, 0.4, 1.3)
    nt, pz = TT.node_to_tensor(node, cfg)
    nt, pz = torch.as_tensor(nt)[None], torch.as_tensor(pz)[None]
    n, pad = 100, 128
    ts, xs, mask = np.zeros(pad), np.zeros(pad), np.zeros(pad)
    ts[:n] = np.linspace(0, 1, n)
    xs[:n] = np.sin(np.linspace(0, 9, n))
    mask[:n] = 1.0
    ts, xs, mask = map(torch.as_tensor, (ts, xs, mask))
    nz = torch.tensor([0.37])
    val_a, g_a = TM.lml_value_and_noise_grad(nt, pz, nz, ts, xs, mask, cfg,
                                             tab)
    nzg = nz.clone().requires_grad_(True)
    val_b = TM.lml(nt, pz, nzg, ts, xs, mask, cfg, tab)
    (g_b,) = torch.autograd.grad(val_b.sum(), nzg)
    np.testing.assert_allclose(val_a.numpy(), val_b.detach().numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(g_a.numpy(), g_b.numpy(), rtol=1e-8)
    K0 = TM.assemble_K0(nt, pz, ts, mask, cfg, tab)
    val_c, g_c = TM.lml_value_and_noise_grad_from_K0(K0, nz, xs, mask, cfg)
    np.testing.assert_allclose(val_c.numpy(), val_a.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g_c.numpy(), g_a.numpy(), rtol=1e-12)


@pytest.mark.parametrize("N", [64, 128])
def test_noise_grad_from_K0_matches_jax(N):
    """lml_value_and_noise_grad_from_K0 against the JAX function on the
    mixed batch, each package on its own assemble_K0 (the port's is
    lower-only, the JAX plain one symmetric; both factor the lower
    triangle): rtol 1e-9 (float64, the same factor and statistics)."""
    cfg, jcfg = _cfg()
    tab, jtab = TM.prior_tables(cfg, "cpu", F64), JM.prior_tables(jcfg)
    nt, pz = mixed_trees(N + 1)
    ts, xs, mask = _data(N, seed=N + 1)
    nz = np.linspace(-3.0, 0.0, len(nt))
    tst, xst, mt = map(torch.as_tensor, (ts, xs, mask))
    K0 = TM.assemble_K0(torch.as_tensor(nt), torch.as_tensor(pz), tst, mt,
                        cfg, tab)
    val, g = TM.lml_value_and_noise_grad_from_K0(K0, torch.as_tensor(nz),
                                                 xst, mt, cfg)

    def one(n, p, z):
        K0j = JM.assemble_K0(n, p, jnp.asarray(ts), jnp.asarray(mask), jcfg,
                             jtab, pallas=False)
        return JM.lml_value_and_noise_grad_from_K0(
            K0j, z, jnp.asarray(xs), jnp.asarray(mask), jcfg)
    vj, gj = jax.jit(jax.vmap(one))(jnp.asarray(nt), jnp.asarray(pz),
                                    jnp.asarray(nz))
    np.testing.assert_allclose(val.numpy(), np.asarray(vj), rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-9)
