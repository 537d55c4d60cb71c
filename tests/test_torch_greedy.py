"""The port's greedy search pieces against autogp_tpu.inference.greedy on
the CPU in float64: candidate enumeration (bitwise, from the same
default_rng), the sweep bucket, n_params and the AIC, and map_optimize on a
fixed candidate batch (the same optimized parameters, scores, LMLs and
accepted rounds per lane), a candidate whose LML is NaN included."""

import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autogp_tpu import config as JC
from autogp_tpu import model as JM
from autogp_tpu.inference import greedy as JG
from autogp_tpu.inference import smc as JS
from autogp_tpu_torch import config as TC
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.inference import greedy as TG
from autogp_tpu_torch.inference import smc as TS

F64 = torch.float64


@pytest.fixture(autouse=True)
def _torch_cpu():
    torch.set_num_threads(1)


def _cfgs(**kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JC.GPConfig(**kw), TC.GPConfig(**kw)


def _heap(spec, Mn):
    """(node_type [M] int64, params_z [M, 3]) of {slot: (code, params)}."""
    nt = np.zeros(Mn, np.int64)
    pz = np.zeros((Mn, 3))
    for slot, (code, par) in spec.items():
        nt[slot] = code
        pz[slot, :len(par)] = par
    return nt, pz


HEAPS = {
    "leaf": {0: (2, [0.1, -0.3, 0.5])},
    "plus": {0: (6, []), 1: (5, [0.2, 0.4, -0.1]), 2: (4, [-0.5, 0.3, 0.2])},
    "times_deep": {0: (7, []), 1: (6, []), 2: (2, [0.3, 0.1, -0.2]),
                   3: (5, [0.1, 0.1, 0.1]), 4: (4, [0.2, -0.2, 0.7])},
}


@pytest.mark.parametrize("heap", sorted(HEAPS))
@pytest.mark.parametrize("kw", [{"max_depth": 3, "changepoints": False},
                                {"max_depth": 4, "changepoints": False},
                                {"max_depth": 4}],
                         ids=["d3_nocp", "d4_nocp", "d4_cp"])
def test_enumerate_next_structures_bitwise(heap, kw):
    """The same candidates, in the same order, with the same random leaf
    parameters, from the same numpy default_rng seed."""
    jc, tc = _cfgs(**kw)
    nt, pz = _heap(HEAPS[heap], tc.max_nodes)
    a = JG.enumerate_next_structures(nt.astype(np.int32), pz, jc,
                                     np.random.default_rng(4))
    b = TG.enumerate_next_structures(nt, pz, tc, np.random.default_rng(4))
    assert len(a) == len(b) > 0
    for (na, pa), (nb, pb) in zip(a, b):
        np.testing.assert_array_equal(na, nb)
        assert pa.tobytes() == pb.tobytes()
    assert TG.leaf_node_types(tc) == JG.leaf_node_types(jc)
    assert TG.op_node_types(tc) == JG.op_node_types(jc)


@pytest.mark.parametrize("kw", [{"max_depth": 3, "changepoints": False},
                                {"max_depth": 5, "changepoints": False},
                                {"max_depth": 4}, {}],
                         ids=["d3_nocp", "d5_nocp", "d4_cp", "default"])
def test_sweep_bucket_n_params_and_aic_equal_the_jax_package(kw):
    jc, tc = _cfgs(**kw)
    for d in range(1, tc.depth_cap + 1):
        assert TG.sweep_bucket(tc, d) == JG.sweep_bucket(jc, d)
    assert TG.sweep_bucket(_cfgs(changepoints=False, max_depth=3)[1],
                           3) == 32     # config 3's batch
    rng = np.random.default_rng(1)
    for heap in HEAPS.values():
        nt, _ = _heap(heap, tc.max_nodes)
        for infer_noise in (True, False):
            k_j = int(JG.n_params(jnp.asarray(nt, jnp.int32), infer_noise))
            k_t = int(TG.n_params(torch.as_tensor(nt), infer_noise))
            assert k_t == k_j
            lml = float(rng.standard_normal() * 50)
            assert float(TG.compute_aic(torch.tensor(lml, dtype=F64), k_t)) \
                == float(JG.compute_aic(jnp.float64(lml), k_j))


# ---------------------------------------------------------------------------
# map_optimize on a fixed batch
# ---------------------------------------------------------------------------

ROUNDS = 6


def _problem(n):
    """Config 3's kind of series (trend times season, numpy seed 0), n
    points; both packages' (cfg, tables, data)."""
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=float)
    y = (1.0 + 0.02 * t) * (10.0 + 3.0 * np.sin(2 * np.pi * t / 12.0)) \
        + 0.5 * rng.standard_normal(n)
    ts = (t - t.min()) / (t.max() - t.min())
    xs = (y - y.mean()) / (y.max() - y.min())
    jc, tc = _cfgs(max_depth=3, changepoints=False)
    jd = JS.make_dataset(ts, xs, dtype=jnp.float64)
    td = TS.make_dataset(ts, xs, dtype=F64, device="cpu")
    return (jc, JM.prior_tables(jc), jd), (
        tc, TM.prior_tables(tc, "cpu", F64), td)


def _batch(tc):
    """Eight candidates: the extensions of a Linear root (seeded), with
    the third one's parameters NaN (its LML is NaN at every probe)."""
    nt, pz = _heap({0: (2, [0.2, -0.4, 0.3])}, tc.max_nodes)
    cands = TG.enumerate_next_structures(nt, pz, tc,
                                         np.random.default_rng(2))[:8]
    nts = np.stack([c[0] for c in cands])
    pzs = np.stack([c[1] for c in cands])
    pzs[2] = np.nan
    return nts, pzs


def _jax_map_optimize(nts, pzs, nzs, jax_side, infer_noise, max_rounds):
    """The JAX package's map_optimize over the batch (jit + vmap), with
    its loop's final accepted-round and probe counters read out: while
    tracing, the while loop of map_optimize's 9-element carry returns
    them as an extra row of params_z."""
    cfg, tables, data = jax_side
    real = jax.lax.while_loop

    def loop(cond, body, init):
        out = real(cond, body, init)
        if isinstance(init, tuple) and len(init) == 9:
            pz, nz, s, lml, gp, gn, step, rounds, it = out
            extra = jnp.stack([rounds, it, it]).astype(pz.dtype)[None]
            return (jnp.concatenate([pz, extra]), nz, s, lml, gp, gn, step,
                    rounds, it)
        return out

    with mock.patch.object(jax.lax, "while_loop", loop):
        f = jax.jit(jax.vmap(lambda nt, pz, nz: JG.map_optimize(
            nt, pz, nz, data, cfg, tables, infer_noise,
            max_rounds=max_rounds)))
        pz, nz, s, lml = f(jnp.asarray(nts, jnp.int32), jnp.asarray(pzs),
                           jnp.asarray(nzs))
    pz = np.asarray(pz)
    return (pz[:, :-1], np.asarray(nz), np.asarray(s), np.asarray(lml),
            pz[:, -1, 0].astype(int), pz[:, -1, 1].astype(int))


@pytest.fixture(scope="module")
def fixed_batch():
    """Both packages' map_optimize on the same 8 candidates, N = 64
    bucket (40 points active: the fused gradient route, as config 3's
    256-point bucket takes on the card), noise inferred, max_rounds 6."""
    jax_side, torch_side = _problem(40)
    tc = torch_side[0]
    nts, pzs = _batch(tc)
    nzs = np.full(8, -0.7)
    want = _jax_map_optimize(nts, pzs, nzs, jax_side, True, ROUNDS)
    cfg, tables, data = torch_side
    got = TG.map_optimize(torch.as_tensor(nts), torch.as_tensor(pzs),
                          torch.as_tensor(nzs), data, cfg, tables, True,
                          max_rounds=ROUNDS)
    return nts, pzs, want, got


def test_map_optimize_matches_the_jax_package(fixed_batch):
    """pz, nz, score and lml within 1e-8 relative (float64; the same
    accept decisions on LMLs that agree to ~1e-12) and the same number of
    accepted rounds per lane; the NaN lane never accepts and stays
    frozen after its 37 halvings (0.1 / 2^37 < 1e-12), in both."""
    nts, pzs, (pz, nz, s, lml, rounds, it), got = fixed_batch
    np.testing.assert_array_equal(got.rounds.numpy(), rounds)
    ok = np.arange(8) != 2
    np.testing.assert_allclose(got.params_z.numpy()[ok], pz[ok], rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(got.noise_z.numpy(), nz, rtol=1e-8)
    np.testing.assert_allclose(got.score.numpy(), s, rtol=1e-8)
    np.testing.assert_allclose(got.lml.numpy(), lml, rtol=1e-8)
    assert rounds[2] == 0 and it[2] == 37
    assert np.isnan(got.lml.numpy()[2]) and np.isnan(lml[2])
    assert np.isnan(got.score.numpy()[2]) and np.isnan(s[2])
    assert (rounds[ok] > 0).all()
    # The batch ran until its last lane stopped: the JAX loop's probes.
    assert got.probes == it.max()


def test_map_optimize_frozen_lanes_match_alone(fixed_batch):
    """A lane's result does not depend on the batch it ran in: each of
    three lanes optimized alone (the loop then stops at its own end)
    equals its row of the batch (the same accepted rounds; values to
    1e-12, the same per-lane arithmetic in batches of another size), as
    the reference's batched predicate freezes a finished lane exactly."""
    nts, pzs, _, got = fixed_batch
    _, (cfg, tables, data) = _problem(40)
    for i in (0, 2, 5):
        one = TG.map_optimize(torch.as_tensor(nts[i:i + 1]),
                              torch.as_tensor(pzs[i:i + 1]),
                              torch.full((1,), -0.7, dtype=F64), data, cfg,
                              tables, True, max_rounds=ROUNDS)
        assert int(one.rounds[0]) == int(got.rounds[i])
        for a, b in ((one.params_z[0], got.params_z[i]),
                     (one.noise_z[0], got.noise_z[i]),
                     (one.lml[0], got.lml[i]), (one.score[0], got.score[i])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-14)


def test_nan_candidate_selection_matches_the_jax_package():
    """A candidate whose every probe fails (NaN LML) in a batch of
    finite ones: np.argmin over the AICs returns the first NaN, in both
    packages, so optimize_candidates picks it and reports AIC NaN (a
    greedy stage then rejects it, NaN < aic being False; an initial stage
    would carry NaN). Recorded on ROADMAP.md's watch list."""
    jax_side, torch_side = _problem(24)
    tc = torch_side[0]
    nts, pzs = _batch(tc)
    cands = [(nts[i], pzs[i]) for i in range(5)]
    jcfg, jtab, jdata = jax_side
    want = JG.optimize_candidates(
        [(n.astype(np.int32), p) for n, p in cands], -0.7, jdata, jcfg,
        jtab, True, max_rounds=ROUNDS)
    got = TG.optimize_candidates(cands, -0.7, torch_side[2], tc,
                                 torch_side[1], True, max_rounds=ROUNDS)
    np.testing.assert_array_equal(want[0], cands[2][0])
    np.testing.assert_array_equal(got.node_type, cands[2][0])
    assert np.isnan(want[4]) and np.isnan(got.aic)
    assert got.candidates == 5
