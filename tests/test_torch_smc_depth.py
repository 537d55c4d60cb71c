"""Parity of the port's depth-annealed SMC with autogp_tpu.inference.
smc_depth (CPU, float64).

The extension weight is deterministic given its draws: the JAX package's
attach_extend_step runs under one jax.vmap with per-particle keys, its
draws are taken again by the JAX package's own samplers on the same split
keys, and the port's `extend_weight` scores those draws and JAX's new
trees. The driver is held by the reference's smoke test and its prior
oracle (tests/test_inference.py:245, :301)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autogp_tpu import config as JC
from autogp_tpu import model as JM
from autogp_tpu import tree as JT
from autogp_tpu.inference import moves as JMV
from autogp_tpu.inference import moves_da as JDA
from autogp_tpu.inference import smc as JSMC
from autogp_tpu.inference import smc_depth as JSD
from autogp_tpu_torch import config as C
from autogp_tpu_torch import model as TM
from autogp_tpu_torch import tree as TT
from autogp_tpu_torch.inference import moves as TMV
from autogp_tpu_torch.inference import smc
from autogp_tpu_torch.inference import smc_depth

F64 = torch.float64
P = 128


@pytest.fixture(autouse=True)
def _torch_cpu_f64():
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _series(n=24, seed=2):
    rng = np.random.default_rng(seed)
    ts = np.linspace(0, 1, n)
    return ts, np.sin(2 * np.pi * 3 * ts) + 0.1 * rng.standard_normal(n)


def test_embed_particles_matches_jax():
    rng = np.random.default_rng(0)
    nt = rng.integers(0, 9, (5, 7))
    pz = rng.standard_normal((5, 7, 3))
    vec = [rng.standard_normal(5) for _ in range(3)]
    jp = JSD.embed_particles(JSMC.Particles(
        jnp.asarray(nt, jnp.int32), jnp.asarray(pz), *map(jnp.asarray, vec),
        jnp.asarray(0.0), jnp.arange(5)), 31)
    tp = smc_depth.embed_particles(smc.Particles(
        torch.as_tensor(nt), torch.as_tensor(pz),
        *map(torch.as_tensor, vec), torch.zeros(()), torch.arange(5)), 31)
    np.testing.assert_array_equal(tp.node_type.numpy(), np.asarray(
        jp.node_type))
    np.testing.assert_array_equal(tp.params.numpy(), np.asarray(jp.params))
    assert smc_depth.embed_particles(tp, 31) is tp
    with pytest.raises(ValueError):
        smc_depth.embed_particles(tp, 15)


@pytest.fixture(scope="module", params=[False, True], ids=["unbiased",
                                                           "biased"])
def jax_extension(request):
    """Depth-2 prior trees (ChangePoints on) embedded in depth 3 and
    extended by the JAX package on a 24-point series, with the draws of
    each particle's key taken again by the JAX samplers. One jitted call."""
    biased = request.param
    cfg2, cfg3 = JC.GPConfig(max_depth=2), JC.GPConfig(max_depth=3)
    tab2, tab3 = JM.prior_tables(cfg2), JM.prior_tables(cfg3)
    D = tab3.depth_cap
    keys = jax.random.split(jax.random.PRNGKey(3), 2 * P)
    nt2, pz2 = jax.jit(jax.vmap(lambda k: JM.sample_tree(
        k, tab2, dtype=jnp.float64)))(keys[:P])
    nt = np.zeros((P, 7), np.int64)
    pz = np.zeros((P, 7, 3))
    nt[:, :3], pz[:, :3] = np.asarray(nt2), np.asarray(pz2)
    nz = np.random.default_rng(4).standard_normal(P)
    ts, xs = _series()
    data = JSMC.make_dataset(ts, xs)
    d = (data.ts, data.xs, data.mask)

    def one(key, a, b, c):
        nt_new, pz_new, lml_new, w = JSD.attach_extend_step(
            key, a, b, c, d, cfg3, tab3, 2, biased=biased)
        k_pa, k_path, _ = jax.random.split(key, 3)
        sizes = JT.subtree_sizes(a).astype(b.dtype)
        idx_a, path = JMV.sample_pick_node(k_pa, a, sizes, biased, D)
        h = JDA.subtree_height(a, idx_a, tab3)
        hole = JDA.sample_random_path(k_path, idx_a, D - (h - 1), tab3, D)
        lml_old = JM.lml(a, b, c, *d, cfg3, tab3)
        lp_old = JM.tree_prior_logpdf(a, b, tab3, leaf_cap=2)
        return (nt_new, pz_new, lml_new, w, idx_a, path.stop_level,
                path.dirs, hole, lml_old, lp_old)

    out = jax.jit(jax.vmap(one))(keys[P:], jnp.asarray(nt, jnp.int32),
                                 jnp.asarray(pz), jnp.asarray(nz))
    names = ("nt_new", "pz_new", "lml_new", "w", "idx_a", "stop_level",
             "dirs", "hole", "lml_old", "lp_old")
    res = {k: np.array(v) for k, v in zip(names, out)}
    return dict(res, nt=nt, pz=pz, nz=nz, biased=biased, ts=ts, xs=xs)


def test_extension_weight_matches_jax(jax_extension):
    """extend_weight on JAX's draws and new trees: lml_new within rtol
    1e-10, w within 1e-9 (1 + |lml_old| + |lml_new|) (w is a difference
    of LMLs and can be small)."""
    j = jax_extension
    cfg3 = C.GPConfig(max_depth=3)
    tab3 = TM.prior_tables(cfg3, "cpu", F64)
    data = smc.make_dataset(j["ts"], j["xs"], dtype=F64, device="cpu")
    nt = torch.as_tensor(j["nt"])
    idx_a = torch.as_tensor(j["idx_a"], dtype=torch.int64)
    ext = smc_depth.Extension(
        node_type=torch.as_tensor(j["nt_new"], dtype=torch.int64),
        params=torch.as_tensor(j["pz_new"]), idx_a=idx_a,
        path_a=TMV.PickPath(
            stop_level=torch.as_tensor(j["stop_level"], dtype=torch.int64),
            dirs=torch.as_tensor(j["dirs"], dtype=torch.int64)),
        hole=torch.as_tensor(j["hole"], dtype=torch.int64),
        force_cp=TMV.gather_at(nt, idx_a) == C.CHANGEPOINT)
    # The draws cover attaches at the root and below it, under and over
    # ChangePoints.
    assert (j["idx_a"] == 0).any() and (j["idx_a"] > 0).any()
    assert bool(ext.force_cp.any())
    assert (j["hole"] != j["idx_a"]).any()
    nt_new, pz_new, lml_new, w = smc_depth.extend_weight(
        nt, torch.as_tensor(j["pz"]), torch.as_tensor(j["nz"]), ext,
        (data.ts, data.xs, data.mask), cfg3, tab3, 2, j["biased"])
    assert nt_new is ext.node_type and pz_new is ext.params
    np.testing.assert_allclose(lml_new.numpy(), j["lml_new"], rtol=1e-10)
    # An auxiliary ChangePoint drawn at a below a non-ChangePoint parent is
    # outside the prior's support: weight -inf in both packages.
    fin = np.isfinite(j["w"])
    assert fin.sum() >= P - 8
    np.testing.assert_array_equal(w.numpy()[~fin], j["w"][~fin])
    tol = 1e-9 * (1 + np.abs(j["lml_old"]) + np.abs(j["lml_new"]))
    err = np.abs(w.numpy()[fin] - j["w"][fin])
    assert (err <= tol[fin]).all(), err.max()


def test_leaf_capped_prior_matches_jax(jax_extension):
    """The old tree's prior scored on the embedded heap with leaf_cap=2."""
    j = jax_extension
    tab3 = TM.prior_tables(C.GPConfig(max_depth=3), "cpu", F64)
    lp = TM.tree_prior_logpdf(torch.as_tensor(j["nt"]),
                              torch.as_tensor(j["pz"]), tab3, leaf_cap=2)
    assert np.isfinite(j["lp_old"]).all()
    np.testing.assert_allclose(lp.numpy(), j["lp_old"], rtol=1e-12)


def test_extend_propose_draws_valid_extensions():
    """The port's own draws: the old subtree(a) sits at the hole, the new
    trees are valid under the deeper config, and their weights (through
    extend_weight) are finite."""
    ts, xs = _series()
    cfg2, cfg3 = C.GPConfig(max_depth=2), C.GPConfig(max_depth=3)
    tab2 = TM.prior_tables(cfg2, "cpu", F64)
    tab3 = TM.prior_tables(cfg3, "cpu", F64)
    gen = torch.Generator().manual_seed(5)
    data = smc.make_dataset(ts, xs, dtype=F64, device="cpu")
    parts = smc.initialize(gen, P, data, cfg2, tab2)
    parts = smc_depth.embed_particles(parts, cfg3.max_nodes)
    ext = smc_depth.extend_propose(gen, parts.node_type, parts.params, tab3)
    nt, nt_new = parts.node_type.numpy(), ext.node_type.numpy()
    for p in range(P):
        a, h = int(ext.idx_a[p]), int(ext.hole[p])
        assert nt_new[p, h] == nt[p, a]
    _, _, lml_new, w = smc_depth.extend_weight(
        parts.node_type, parts.params, parts.noise_z, ext,
        (data.ts, data.xs, data.mask), cfg3, tab3, 2)
    assert torch.isfinite(lml_new).all()
    # Weight -inf exactly where the auxiliary draw put a ChangePoint below
    # a non-ChangePoint parent (outside the prior's support); the rest are
    # valid trees under the deeper config.
    par = (np.arange(1, 7) - 1) // 2
    off = ((nt_new[:, 1:] == C.CHANGEPOINT)
           & (nt_new[:, par] != C.CHANGEPOINT)).any(1)
    fin = torch.isfinite(w).numpy()
    np.testing.assert_array_equal(fin, ~off)
    assert fin.sum() >= P - 8
    keep = torch.as_tensor(np.flatnonzero(fin))
    smc.validate_particles(parts.replace(
        node_type=ext.node_type[keep], params=ext.params[keep],
        log_weights=w[keep], lml=lml_new[keep]), cfg3)


@pytest.mark.parametrize("biased", [False, True])
def test_detach_support_logprob_by_enumeration(biased):
    """The DETACH backward kernel's mass on the old config's support, on
    depth-3 prior trees (ChangePoints on) for old depths 1 and 2, against
    an enumeration of every pair (a, b) scored by moves.assess_pick_node
    and detached by moves_da.move_subtree."""
    from autogp_tpu_torch.inference import moves_da as TDA
    cfg3 = C.GPConfig(max_depth=3)
    tab3 = TM.prior_tables(cfg3, "cpu", F64)
    D = tab3.depth_cap
    nt, _ = TM.sample_tree(torch.Generator().manual_seed(3), 24, tab3, F64,
                           "cpu")
    sizes = TT.subtree_sizes(nt).to(F64)
    depth = np.floor(np.log2(np.arange(7) + 1)).astype(int) + 1
    want = np.zeros((2, len(nt)))
    for p in range(len(nt)):
        for a in np.flatnonzero(nt[p].numpy() > 0):
            for b in np.flatnonzero(nt[p].numpy() > 0):
                if not (tab3.ancestors[b] == a).any():
                    continue
                A, B = torch.tensor([a]), torch.tensor([b])
                lq_a, _ = TMV.assess_pick_node(TDA.path_between(
                    torch.tensor([0]), A, tab3, D), nt[p:p + 1],
                    sizes[p:p + 1], biased, D)
                lq_b, _ = TMV.assess_pick_node(TDA.path_between(
                    A, B, tab3, D), nt[p:p + 1], sizes[p:p + 1], biased, D,
                    start_idx=A)
                old = TDA.move_subtree(nt[p:p + 1], torch.zeros(1, 7, 3), B,
                                       A, tab3)[0][0].numpy()
                on = np.flatnonzero(old > 0)
                cp_bad = any(old[i] == C.CHANGEPOINT
                             and old[(i - 1) // 2] != C.CHANGEPOINT
                             for i in on if i > 0)
                for k, depth_old in enumerate((1, 2)):
                    if depth[on].max() <= depth_old and not cp_bad:
                        want[k, p] += float(torch.exp(lq_a + lq_b))
    for k, depth_old in enumerate((1, 2)):
        got = smc_depth.detach_support_logprob(nt, depth_old, tab3, biased)
        np.testing.assert_allclose(got.numpy(), np.log(want[k]), rtol=0,
                                   atol=1e-12)
    assert (want[0] < 1).any() and (want[1] < 1).any()


def test_smc_anneal_depth_smoke():
    """Port of tests/test_inference.py:245: runs, finite weights, depth
    grows; the per-depth statistics and the callback."""
    ts, xs = _series()
    seen, stats = [], []
    parts, cfg = smc_depth.run_smc_anneal_depth(
        torch.Generator().manual_seed(0), ts, xs, schedule=[1, 2],
        n_particles=4, n_mcmc=1, n_hmc=1, device="cpu",
        callback_fn=lambda **kw: seen.append((kw["depth"], kw["resampled"],
                                              kw["particles"].node_type
                                              .shape[1])),
        round_stats=stats)
    assert cfg.max_depth == 2
    assert parts.node_type.shape[1] == 3 and parts.params.dtype == F64
    assert torch.isfinite(parts.log_weights).all()
    assert torch.isfinite(parts.lml).all()
    smc.validate_particles(parts, cfg)
    assert [(d, m) for d, _, m in seen] == [(1, 1), (2, 3)]
    assert [s["depth"] for s in stats] == [1, 2]
    assert [s["resampled"] for s in stats] == [r for _, r, _ in seen]
    assert not stats[-1]["resampled"]
    assert all(s["mh_accepted"] <= 4 for s in stats)
    with pytest.raises(ValueError):
        smc_depth.run_smc_anneal_depth(None, ts, xs, [2, 2], device="cpu")


def test_smc_anneal_depth_prior_oracle():
    """Port of tests/test_inference.py:301: with EMPTY data the target at
    every depth is the prior, so after annealing depth 1 -> 2 the weighted
    structure distribution must equal the enumerable depth-2 prior."""
    Pn = 512
    parts, cfg = smc_depth.run_smc_anneal_depth(
        torch.Generator().manual_seed(7), np.zeros(0), np.zeros(0),
        schedule=[1, 2], n_particles=Pn, n_mcmc=1, n_hmc=0, noise=1.0,
        device="cpu")
    assert cfg.max_depth == 2
    nts = parts.node_type.numpy()
    w = smc.normalized_weights(parts.log_weights).numpy()
    ess = float(smc.effective_sample_size(parts.log_weights))
    assert ess > 50

    d_cp = np.asarray(cfg.node_dist_cp)
    d_leaf = np.asarray(cfg.node_dist_leaf)
    probs = {}
    for root in range(1, 9):
        if d_cp[root - 1] == 0:
            continue
        if root in (C.PLUS, C.TIMES, C.CHANGEPOINT):
            for left in range(1, 6):
                for right in range(1, 6):
                    if d_leaf[left - 1] > 0 and d_leaf[right - 1] > 0:
                        probs[root * 100 + left * 10 + right] = (
                            d_cp[root - 1] * d_leaf[left - 1]
                            * d_leaf[right - 1])
        else:
            probs[root * 100] = d_cp[root - 1]
    assert abs(sum(probs.values()) - 1.0) < 1e-12

    keys_got = nts[:, 0] * 100 + nts[:, 1] * 10 + nts[:, 2]
    for sk, pw in sorted(probs.items()):
        got = float(w[keys_got == sk].sum())
        tol = 5.0 * np.sqrt(pw * (1 - pw) / ess) + 0.02
        assert abs(got - pw) < tol, (sk, got, pw, tol)


def test_smc_anneal_depth_defaults_to_the_card(monkeypatch):
    """Without a card the default device raises: nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts, xs = _series()
    with pytest.raises(RuntimeError, match="cuda"):
        smc_depth.run_smc_anneal_depth(torch.Generator(), ts, xs, [1, 2])
