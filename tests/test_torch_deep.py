"""Heaps deeper than 8 levels on the CPU in float64: the port at depth caps
9 and 10 held to the JAX package.

The port's kernels are sized by a tree's tape, not by its heap, and its
plain evaluator skips the subtrees a batch leaves empty, so a 1023-slot
heap costs what its active slots do. The JAX package's XLA evaluator
visits every slot of the heap: on one CPU core its LML gradient at depth
cap 9 took 215 s op by op and over 600 s to compile, at cap 3 about 6 s. So the JAX side runs each tree in the depth-3 heap that holds it (a
tree's LML does not depend on the heap it is stored in; slot s keeps its
index at any depth), once per bucket for the whole file, and the port runs
the same trees re-encoded at caps 9 and 10. The deepest trees, a comb as
tall as the cap, are held to the JAX package's numpy evaluator
(autogp_tpu.kernels, JAX-free). Inputs are made with numpy from fixed
seeds; trees cross packages as heap arrays.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autogp_tpu import config as JC
from autogp_tpu import kernels as JK
from autogp_tpu import model as JM
from autogp_tpu.inference import greedy as JG
from autogp_tpu_torch import config as C
from autogp_tpu_torch import kernels as K
from autogp_tpu_torch import model as TM
from autogp_tpu_torch import tree as TT
from autogp_tpu_torch.inference import greedy as TG
from autogp_tpu_torch.ops import cov
from chip_smoke import comb_heap, full_heap

F64 = torch.float64
JAX_DEPTH = 3


@pytest.fixture(autouse=True)
def _torch_cpu_f64():
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _cfg(depth, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (C.GPConfig(static_max_depth=depth, **kw),
                JC.GPConfig(static_max_depth=depth, **kw))


def _pad(a, depth):
    """A heap's slot array [P, M, ...] in the heap of `depth` levels."""
    pad = (1 << depth) - 1 - a.shape[1]
    return np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))


def _trees():
    """Two depth-3 trees (a full tree of Plus / Times over four leaves, a
    ChangePoint over a Plus and a leaf) with N(0, 1) whitened params."""
    rng = np.random.default_rng(3)
    nt = np.zeros((2, 7), np.int64)
    nt[0] = [C.TIMES, C.PLUS, C.PLUS, C.LINEAR, C.PERIODIC,
             C.GAMMA_EXPONENTIAL, C.SQUARED_EXPONENTIAL]
    nt[1, :5] = [C.CHANGEPOINT, C.PLUS, C.PERIODIC, C.LINEAR, C.WHITE_NOISE]
    pz = np.zeros((2, 7, C.MAX_PARAMS))
    for i in range(2):
        for s in range(7):
            k = C.PARAM_ARITY[nt[i, s]]
            pz[i, s, :k] = rng.standard_normal(k)
    return nt, pz


def _data(N):
    """32 points: the whole 32-point bucket, or the first half of the
    64-point one."""
    rng = np.random.default_rng(N)
    ts, xs, mask = np.zeros(N), np.zeros(N), np.zeros(N)
    ts[:32] = np.sort(rng.uniform(0, 1, 32))
    xs[:32] = np.sin(6 * ts[:32]) + 0.1 * rng.standard_normal(32)
    mask[:32] = 1.0
    return ts, xs, mask


NZ = np.array([-1.3, 0.2])


@pytest.fixture(scope="module")
def jax_lml():
    """{N: (value [2], d/d params_z [2, 7, 3], d/d noise_z [2])}: jax.grad
    of the JAX package's LML (XLA, x64) on the depth-3 heaps, at the
    32-point bucket (the port's dense route) and the 64-point one (its
    fused route)."""
    _, jcfg = _cfg(JAX_DEPTH)
    jtab = JM.prior_tables(jcfg)
    nt, pz = _trees()
    out = {}
    for N in (32, 64):
        ts, xs, mask = _data(N)
        vg = jax.jit(jax.vmap(jax.value_and_grad(
            lambda n, p, z: JM.lml(n, p, z, jnp.asarray(ts), jnp.asarray(xs),
                                   jnp.asarray(mask), jcfg, jtab,
                                   pallas=False), argnums=(1, 2))))
        v, (gp, gn) = vg(jnp.asarray(nt, jnp.int32), jnp.asarray(pz),
                         jnp.asarray(NZ))
        out[N] = tuple(np.asarray(a) for a in (v, gp, gn))
    return out


def _port_lml(nt, pz, depth, N):
    """(value, d/d params_z, d/d noise_z) of the port's model.lml under
    autograd on heaps of `depth` levels, noise_z NZ, or a ramp for more
    than two trees."""
    cfg, _ = _cfg(depth)
    tab = TM.prior_tables(cfg, "cpu", F64)
    ts, xs, mask = map(torch.as_tensor, _data(N))
    pzg = torch.as_tensor(pz).clone().requires_grad_(True)
    nz = NZ if len(nt) == 2 else np.linspace(-1.5, 0.5, len(nt))
    nzg = torch.as_tensor(nz).requires_grad_(True)
    v = TM.lml(torch.as_tensor(nt), pzg, nzg, ts, xs, mask, cfg, tab)
    gp, gn = torch.autograd.grad(v.sum(), (pzg, nzg))
    return v.detach().numpy(), gp.numpy(), gn.numpy()


@pytest.mark.parametrize("N", [32, 64], ids=["dense", "fused"])
@pytest.mark.parametrize("depth", [9, 10])
def test_lml_and_grad_match_jax(jax_lml, depth, N):
    """model.lml and its gradient (the dense route's plain versions at the
    32-point bucket, the fused route's at 64) on heaps of depth caps 9 and
    10 against jax.grad of the JAX package's LML on the same trees: rtol
    1e-10 (value, noise gradient) and 1e-10 of each particle's largest
    parameter gradient; every other slot's gradient exactly 0."""
    nt, pz = _trees()
    v, gp, gn = _port_lml(_pad(nt, depth), _pad(pz, depth), depth, N)
    jv, jgp, jgn = jax_lml[N]
    np.testing.assert_allclose(v, jv, rtol=1e-10)
    np.testing.assert_allclose(gn, jgn, rtol=1e-10)
    for i in range(2):
        np.testing.assert_allclose(gp[i, :7], jgp[i], rtol=0,
                                   atol=1e-10 * np.abs(jgp[i]).max())
    assert (gp[:, 7:] == 0).all()


@pytest.mark.parametrize("N", [32, 64], ids=["dense", "fused"])
def test_recoded_heaps_give_equal_lml_and_grad(N):
    """Prior trees of depth cap 5 and the same trees re-encoded at cap 10
    (the same slots, the rest empty): the same LMLs and, slot for slot, the
    same gradients, bit for bit (the plain evaluator runs the same slots);
    the deeper heap's other slots get exactly 0."""
    cfg, _ = _cfg(5)
    tab = TM.prior_tables(cfg, "cpu", F64)
    gen = torch.Generator().manual_seed(5)
    nt, pz = TM.sample_tree(gen, 6, tab, F64, "cpu")
    nt, pz = nt.numpy(), pz.numpy()
    v5, g5, n5 = _port_lml(nt, pz, 5, N)
    v10, g10, n10 = _port_lml(_pad(nt, 10), _pad(pz, 10), 10, N)
    np.testing.assert_array_equal(v10, v5)
    np.testing.assert_array_equal(n10, n5)
    np.testing.assert_array_equal(g10[:, :31], g5)
    assert (g10[:, 31:] == 0).all()


def _stack_height(nt, s=0):
    """The most values the post-order evaluation of slot s's subtree holds
    at once (host recursion)."""
    if 2 * s + 1 >= len(nt) or nt[s] < C.PLUS or nt[s] > C.CHANGEPOINT:
        return 1
    return max(_stack_height(nt, 2 * s + 1), 1 + _stack_height(nt, 2 * s + 2))


@pytest.mark.parametrize("depth", [9, 10])
def test_tape_height_and_length_match_a_host_count(depth):
    """build_tape's length and height against a host count on a comb as
    tall as the cap, one a level shorter, the full tree of 9 levels and
    prior trees of the cap; tape_maxima and heap_maxima give the batch's
    longest tape, tallest stack and most gradient terms."""
    cfg, _ = _cfg(depth)
    tab = TM.prior_tables(cfg, "cpu", F64)
    gen = torch.Generator().manual_seed(depth)
    prior, _ = TM.sample_tree(gen, 5, tab, F64, "cpu")
    heaps = np.concatenate([np.stack([
        comb_heap(np, depth, depth), comb_heap(np, depth, depth - 1),
        _pad(full_heap(np, 9)[None], depth)[0]]), prior.numpy()])
    tape = cov.tape(torch.as_tensor(heaps), depth)
    length = [int((h > 0).sum()) for h in heaps]
    height = [_stack_height(h) for h in heaps]
    terms = [sum(C.PARAM_ARITY[t] for t in h) + 1 for h in heaps]
    assert tape.length.tolist() == length
    assert tape.height.tolist() == height
    assert height[:3] == [depth, depth - 1, 9] and length[2] == 511
    assert (tape.max_len, tape.max_height, tape.max_terms) == (
        max(length), max(height), max(terms))
    assert cov.heap_maxima(torch.as_tensor(heaps), depth) == (
        max(length), max(height), max(terms))


LEAF_NODES = {
    C.LINEAR: lambda g: g.Linear(0.3, 0.8, 1.2),
    C.SQUARED_EXPONENTIAL: lambda g: g.SquaredExponential(0.4, 1.1),
    C.GAMMA_EXPONENTIAL: lambda g: g.GammaExponential(0.5, 1.3, 0.9),
    C.PERIODIC: lambda g: g.Periodic(0.6, 0.27, 1.05),
    C.WHITE_NOISE: lambda g: g.WhiteNoise(0.2),
    C.CONSTANT: lambda g: g.Constant(0.7),
}


def _comb_node(g, nt, s=0):
    """The kernel of heap nt's subtree at s, in module g's classes."""
    t = int(nt[s])
    if t in LEAF_NODES:
        return LEAF_NODES[t](g)
    left, right = _comb_node(g, nt, 2 * s + 1), _comb_node(g, nt, 2 * s + 2)
    if t == C.PLUS:
        return g.Plus(left, right)
    if t == C.TIMES:
        return g.Times(left, right)
    return g.ChangePoint(left, right, 0.45, 1e-3)


def test_comb_cov_plain_matches_numpy_oracle():
    """cov_tape_plain on a right comb of 10 levels in its 1023-slot heap
    (Plus, Times and ChangePoint over every leaf type) against the JAX
    package's numpy evaluator of the same kernel: rtol 1e-12."""
    depth = 10
    cfg, _ = _cfg(depth)
    nt_spec = comb_heap(np, depth, depth)
    node = _comb_node(K, nt_spec)
    nt, pz = TT.node_to_tensor(node, cfg)
    np.testing.assert_array_equal(nt, nt_spec)
    tab = TM.prior_tables(cfg, "cpu", F64)
    ntt = torch.as_tensor(nt)[None]
    pt = TM.transform_params(ntt, torch.as_tensor(pz)[None], tab)
    ts = np.sort(np.random.default_rng(7).uniform(0, 1, 40))
    tt, ones = torch.as_tensor(ts), torch.ones(40)
    got = cov.cov_tape_plain(ntt, pt, torch.tensor([0.1]), tt, tt, ones,
                             ones, depth, True, False)[0].numpy()
    want = JK.compute_cov_matrix(_comb_node(JK, nt_spec), 0.1, ts)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_enumerate_next_structures_at_max_depth_10():
    """Greedy's candidates under GPConfig(changepoints=False,
    max_depth=10), from a leaf, a sum and a Times/Plus comb 9 levels deep
    (whose leaves at level 9 may grow once more, those at 10 not): the
    same candidates, in the same order, with the same leaf parameters as
    the JAX package's from the same numpy default_rng."""
    jc, tc = (JC.GPConfig(changepoints=False, max_depth=10),
              C.GPConfig(changepoints=False, max_depth=10))
    M = tc.max_nodes
    comb = comb_heap(np, 10, 9)
    comb[comb == C.CHANGEPOINT] = C.PLUS
    comb[comb == C.CONSTANT] = C.LINEAR
    for nt in (np.eye(1, M, 0, np.int64)[0] * C.PERIODIC,
               np.array([C.PLUS, C.LINEAR, C.PERIODIC] + [0] * (M - 3)),
               comb):
        pz = np.random.default_rng(1).standard_normal((M, 3)) * (nt > 0)[:,
                                                                         None]
        a = JG.enumerate_next_structures(nt.astype(np.int32), pz, jc,
                                         np.random.default_rng(4))
        b = TG.enumerate_next_structures(nt, pz, tc, np.random.default_rng(4))
        assert len(a) == len(b) > 0
        for (na, pa), (nb, pb) in zip(a, b):
            np.testing.assert_array_equal(na, nb)
            assert pa.tobytes() == pb.tobytes()
