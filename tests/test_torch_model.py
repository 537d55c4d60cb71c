"""Parity of autogp_tpu_torch.model with autogp_tpu.model (CPU, float64).

Deterministic functions are held to the JAX package by value on the same
inputs (made with numpy from fixed seeds); the tree sampler, which cannot
replay JAX's threefry streams, is held to the prior by distribution.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autogp_tpu import config as C
from autogp_tpu import model as JM
from autogp_tpu import api as JA
from autogp_tpu import tree as JT
from autogp_tpu_torch import api as TA
from autogp_tpu_torch import model as TM
from autogp_tpu_torch import tree as TT

F64 = torch.float64
GOLDEN = json.load(open(os.path.join(os.path.dirname(__file__), "golden",
                                     "golden.json")))
_CODE = {"CONST": C.CONSTANT, "LIN": C.LINEAR, "SE": C.SQUARED_EXPONENTIAL,
         "GE": C.GAMMA_EXPONENTIAL, "PER": C.PERIODIC, "+": C.PLUS,
         "*": C.TIMES, "CP": C.CHANGEPOINT}


@pytest.fixture(autouse=True)
def _torch_cpu_f64():
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _cfg(**kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return C.GPConfig(**kw)


def _heap(spec, Mn):
    nt = np.zeros(Mn, np.int64)
    pz = np.zeros((Mn, C.MAX_PARAMS))

    def rec(s, idx):
        nt[idx] = _CODE[s[0]]
        if s[0] == "CP":
            pz[idx, 0] = s[1]
            rec(s[2], 2 * idx + 1)
            rec(s[3], 2 * idx + 2)
        elif s[0] in ("+", "*"):
            rec(s[1], 2 * idx + 1)
            rec(s[2], 2 * idx + 2)
        else:
            pz[idx, :len(s[1])] = s[1]

    rec(spec, 0)
    return nt, pz


def assert_trees_close(a: dict, b: dict, rtol: float):
    """Two kernel trees in the to_dict form: same node types and fields,
    parameters within `rtol`."""
    assert a["type"] == b["type"] and a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, dict):
            assert_trees_close(v, b[k], rtol)
        elif k != "type":
            np.testing.assert_allclose(v, b[k], rtol=rtol)


def _jax_prior_trees(cfg, n, seed):
    tab = JM.prior_tables(cfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    nt, pz = jax.jit(jax.vmap(
        lambda k: JM.sample_tree(k, tab, dtype=jnp.float64)))(keys)
    return np.array(nt, np.int64), np.array(pz)


@pytest.mark.parametrize("name", ["T1", "T2", "T3"])
def test_lml_golden(name):
    """Golden LML (independent mpmath transcription of the reference) at
    1e-9, as tests/test_golden.py holds the JAX package."""
    cfg = _cfg(max_depth=GOLDEN["max_depth"])
    tab = TM.prior_tables(cfg, "cpu", F64)
    nt, pz = _heap(GOLDEN["trees"][name], cfg.max_nodes)
    d = GOLDEN["data"]
    ts = torch.as_tensor(d["ts"], dtype=F64)
    xs = torch.as_tensor(d["xs"], dtype=F64)
    case = GOLDEN["lml"][name]
    got = TM.lml(torch.as_tensor(nt)[None], torch.as_tensor(pz)[None],
                 torch.tensor([case["noise_z"]]), ts, xs,
                 torch.ones_like(ts), cfg, tab)
    np.testing.assert_allclose(float(got[0]), case["value"], rtol=1e-9)


@pytest.mark.parametrize("name", ["T1", "T2", "T3"])
def test_tree_prior_golden(name):
    cfg = _cfg(max_depth=GOLDEN["max_depth"])
    tab = TM.prior_tables(cfg, "cpu", F64)
    nt, pz = _heap(GOLDEN["trees"][name], cfg.max_nodes)
    got = TM.tree_prior_logpdf(torch.as_tensor(nt)[None],
                               torch.as_tensor(pz)[None], tab)
    np.testing.assert_allclose(float(got[0]), GOLDEN["tree_prior"][name],
                               rtol=1e-9)


def test_batched_lml_matches_jax():
    """16 prior trees at N=64 (a masked bucket of 50): tolerance 1e-9
    relative, float64 on both sides; the port factors a lower-only gram
    by blocks, JAX the symmetrized gram by LAPACK."""
    cfg = _cfg(static_max_depth=4)
    jtab = JM.prior_tables(cfg)
    tab = TM.prior_tables(cfg, "cpu", F64)
    nt, pz = _jax_prior_trees(cfg, 16, seed=7)
    rng = np.random.default_rng(7)
    nz = rng.standard_normal(16)
    N, n = 64, 50
    ts, xs, mask = np.zeros(N), np.zeros(N), np.zeros(N)
    ts[:n] = np.sort(rng.uniform(0, 1, n))
    xs[:n] = np.sin(8 * ts[:n]) + 0.1 * rng.standard_normal(n)
    mask[:n] = 1.0
    want = np.asarray(jax.jit(jax.vmap(lambda a, b, c: JM.lml(
        a, b, c, jnp.asarray(ts), jnp.asarray(xs), jnp.asarray(mask), cfg,
        jtab, pallas=False)))(jnp.asarray(nt, jnp.int32), jnp.asarray(pz),
                              jnp.asarray(nz)))
    got = TM.lml(torch.as_tensor(nt), torch.as_tensor(pz),
                 torch.as_tensor(nz), torch.as_tensor(ts),
                 torch.as_tensor(xs), torch.as_tensor(mask), cfg, tab)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)
    # joint_score = tree prior + noise prior + LML, same tolerance.
    want_js = np.asarray(jax.jit(jax.vmap(lambda a, b, c: JM.joint_score(
        a, b, c, jnp.asarray(ts), jnp.asarray(xs), jnp.asarray(mask), cfg,
        jtab)))(jnp.asarray(nt, jnp.int32), jnp.asarray(pz),
                jnp.asarray(nz)))
    got_js = TM.joint_score(torch.as_tensor(nt), torch.as_tensor(pz),
                            torch.as_tensor(nz), torch.as_tensor(ts),
                            torch.as_tensor(xs), torch.as_tensor(mask), cfg,
                            tab)
    np.testing.assert_allclose(got_js.numpy(), want_js, rtol=1e-9)


def test_prior_logpdf_and_transforms_match_jax():
    """tree_prior_logpdf (whole tree and gated subtrees) and
    transform_params/transform_noise at 1e-12: same formulas in float64."""
    cfg = _cfg(static_max_depth=5)
    jtab = JM.prior_tables(cfg)
    tab = TM.prior_tables(cfg, "cpu", F64)
    nt, pz = _jax_prior_trees(cfg, 32, seed=3)
    rng = np.random.default_rng(3)
    roots = np.array([rng.choice(np.flatnonzero(r > 0)) for r in nt])
    gates = rng.uniform(size=32) < 0.5
    tnt, tpz = torch.as_tensor(nt), torch.as_tensor(pz)
    for root, gate in ((0, None), (roots, gates)):
        if gate is None:
            want = jax.jit(jax.vmap(lambda a, b: JM.tree_prior_logpdf(
                a, b, jtab)))(nt, pz)
            got = TM.tree_prior_logpdf(tnt, tpz, tab)
        else:
            want = jax.jit(jax.vmap(lambda a, b, r, g: JM.tree_prior_logpdf(
                a, b, jtab, root_idx=r, root_cp_allowed=g)))(
                nt, pz, root, gate)
            got = TM.tree_prior_logpdf(tnt, tpz, tab,
                                       root_idx=torch.as_tensor(root),
                                       root_cp_allowed=torch.as_tensor(gate))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12)
    want_t = np.asarray(jax.jit(jax.vmap(lambda a, b: JM.transform_params(
        a, b, jtab.ttable)))(jnp.asarray(nt, jnp.int32), jnp.asarray(pz)))
    np.testing.assert_allclose(TM.transform_params(tnt, tpz, tab).numpy(),
                               want_t, rtol=1e-12)
    z = rng.standard_normal(8)
    np.testing.assert_allclose(
        TM.transform_noise(torch.as_tensor(z), cfg).numpy(),
        np.asarray(JM.transform_noise(jnp.asarray(z), cfg)), rtol=1e-12)


def test_tree_codec_matches_jax():
    """node_to_tensor / tensor_to_node, tree_depth and param_mask agree
    with the JAX package."""
    cfg = _cfg(static_max_depth=4)
    nt, pz = _jax_prior_trees(cfg, 3, seed=11)
    tnt = torch.as_tensor(nt)
    for i in range(3):
        assert int(TT.tree_depth(tnt)[i]) == int(JT.tree_depth(nt[i]))
        np.testing.assert_array_equal(TT.param_mask(tnt)[i].numpy(),
                                      np.asarray(JT.param_mask(nt[i])))
    # The two packages' Node classes differ: trees cross as dicts.
    for i in range(3):
        node = TT.tensor_to_node(nt[i], pz[i], cfg)
        jnode = JT.tensor_to_node(nt[i], pz[i], cfg)
        assert_trees_close(TA._kernel_to_dict(node),
                           JA._kernel_to_dict(jnode), rtol=1e-12)
        nt2, pz2 = TT.node_to_tensor(node, cfg)
        jnt, jpz = JT.node_to_tensor(jnode, cfg)
        np.testing.assert_array_equal(nt2, jnt)
        np.testing.assert_allclose(pz2, jpz, rtol=1e-12, atol=1e-12)


def test_sample_tree_matches_prior_distribution():
    """Root-type and size frequencies of the port's sampler against the
    prior: the root distribution is exactly the ChangePoint row of the
    node table; P(size == 1) is the row's leaf mass; the mean size is held
    to the JAX sampler's. Bounds are ~4.5 Monte Carlo standard errors."""
    cfg = _cfg(max_depth=3)
    tab = TM.prior_tables(cfg, "cpu", F64)
    gen = torch.Generator().manual_seed(0)
    n = 4000
    nt, _ = TM.sample_tree(gen, n, tab, F64, "cpu")
    root = nt[:, 0].numpy()
    freq = np.bincount(root, minlength=10)[1:9] / n
    want = cfg.node_dist_table()[2]
    se = np.sqrt(want * (1 - want) / n)
    assert (np.abs(freq - want) <= 4.5 * se + 1e-12).all(), (freq, want)
    sizes = TT.subtree_sizes(nt)[:, 0].numpy()
    p_leaf = want[:5].sum()
    assert abs((sizes == 1).mean() - p_leaf) < 4.5 * np.sqrt(
        p_leaf * (1 - p_leaf) / n)
    jnt, _ = _jax_prior_trees(cfg, n, seed=1)
    jsizes = np.asarray(jax.jit(jax.vmap(JT.subtree_sizes))(
        jnp.asarray(jnt)))[:, 0]
    se_mean = np.sqrt(sizes.var() / n + jsizes.var() / n)
    assert abs(sizes.mean() - jsizes.mean()) < 4.5 * se_mean
    # Every sampled heap is structurally valid.
    from autogp_tpu_torch.inference import check
    assert check.trace_structurally_valid(nt).all()
