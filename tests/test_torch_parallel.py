"""The port's particle mesh (autogp_tpu_torch/parallel/mesh.py) on gloo
ranks on the CPU, float64.

Ports of tests/test_parallel.py:27 (one sharded SMC round), :143 (the full
fit_smc driver, particle_weights and predict) and :193-226 (construction
on the mesh, streaming, a P the mesh does not divide), and a sharded case
of tests/test_robustness.py:60: a flaky LML whose bad lanes all sit on
one rank, after which the run goes on with the same generator, so a
retry decided per rank would leave that rank's stream behind.

The gate is the JAX tests': the sharded run equals the unsharded port's
run from the same seed, integers exactly and floats at rtol=1e-12,
atol=0 (the other test_torch_* files hold the unsharded port to the JAX
package). For each world size the ranks are spawned once (a module
fixture): each joins a gloo group over TCP on localhost, runs every case
and writes what it gathered, and the tests hold every rank's results to
the unsharded run made here. A rank that fails or hangs past the join's
timeout fails the tests of its world size.
"""

import os
import pickle
import socket
import tempfile
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

import autogp_tpu_torch as A
from autogp_tpu_torch import config as C
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.inference import hmc as hmc_mod
from autogp_tpu_torch.inference import smc
from autogp_tpu_torch.parallel import mesh as pmesh

F64 = torch.float64
CFG = C.GPConfig(max_depth=3)
JOIN_TIMEOUT_S = 120
INT_KINDS = "iub"


def _series(seed, n=24):
    rng = np.random.default_rng(seed)
    ts = np.linspace(0, 1, n)
    return ts, np.sin(8 * ts) + 0.1 * rng.standard_normal(n)


def _gathered(particles, mesh):
    return (particles if mesh is None
            else pmesh.gather_particles(particles, mesh))


def _fields(prefix, particles):
    return {prefix + k: getattr(particles, k).numpy().copy() for k in (
        "node_type", "params", "noise_z", "log_weights", "lml",
        "log_ml_est", "parents")}


def _model(ts, xs, n_particles, mesh, config=CFG):
    # A ParticleMesh carries the device; the unsharded run names it.
    kw = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    return A.GPModel(ts, xs, n_particles=n_particles, config=config, **kw)


# ---------------------------------------------------------------------------
# The cases: each runs unsharded (mesh None) here and sharded in the ranks
# ---------------------------------------------------------------------------

def case_round(mesh, world_size):
    """tests/test_parallel.py:27: initialize, then one SMC round
    (reweight, resampling, two MH steps with HMC)."""
    P = 16
    ts, xs = _series(0)
    tab = TM.prior_tables(CFG, "cpu", F64)
    data = smc.make_dataset(ts, xs, pad_to=32, dtype=F64, device="cpu")
    parts = smc.initialize(torch.Generator().manual_seed(0), P, data, CFG,
                           tab, mesh=mesh)
    hc = hmc_mod.HMCConfig(n_exit=1, L_param=3, L_noise=3)
    out, stats = smc.smc_round(
        torch.Generator().manual_seed(7), parts, data, CFG, tab, n_mcmc=2,
        n_hmc=1, biased=False, allow_resample=True, ess_threshold=P / 2,
        adaptive_rejuvenation=False, hmc_cfg=hc, mesh=mesh)
    res = _fields("", _gathered(out, mesh))
    res["shard"] = out.n_particles
    res["resampled"] = bool(stats["resampled"])
    for k in ("mh_accepted", "hmc_sweeps", "hmc_accepted"):
        x = stats[k]
        res[k] = (x if mesh is None else mesh.gather(x)).numpy()
    return res


def case_fit(mesh, world_size):
    """tests/test_parallel.py:143: GPModel + fit_smc over the whole
    driver (init, reweight, forced resampling, rejuvenation with HMC,
    three rounds, verbose, a callback that gets the whole batch), then
    particle_weights and predict."""
    ts, xs = _series(4)
    A.seed(21)
    m = _model(ts, xs, 16, mesh)
    seen = []

    def callback(particles, step, **kw):
        seen.append([step, particles.n_particles, float(particles.lml.sum())])

    A.fit_smc(m, schedule=[8, 16, 24], n_mcmc=2, n_hmc=1,
              adaptive_resampling=False,
              hmc_config={"L_param": 3, "L_noise": 3, "n_exit": 1},
              verbose=True, callback_fn=callback)
    res = _fields("", _gathered(m.particles, mesh))
    res["callback"] = np.array(seen)
    res["shard"] = m.particles.n_particles
    res["num_particles"] = m.num_particles
    res["weights"] = m.particle_weights()
    res["ess"] = np.float64(m.effective_sample_size())
    df = A.predict(m, ts[:6], quantiles=[0.1])
    res["y_mean"] = df["y_mean"].to_numpy()
    res["y_0.1"] = df["y_0.1"].to_numpy()
    res["round_stats"] = np.array([[r["step"], r["resampled"],
                                    r["mh_accepted"], r["hmc_sweeps"],
                                    r["hmc_accepted"]]
                                   for r in m.round_stats])
    return res


def case_streaming(mesh, world_size):
    """tests/test_parallel.py:193-226: construction draws the prior batch
    onto the mesh; add_data and maybe_resample keep it there. Then the
    MCMC entry points, predict_proba and a to_dict / from_dict round
    trip on the mesh."""
    ts, xs = _series(5, 20)
    A.seed(22)
    m = _model(ts[:18], xs[:18], 8, mesh)
    res = _fields("init_", _gathered(m.particles, mesh))
    res["shard_init"] = m.particles.n_particles
    A.add_data(m, ts[18:], xs[18:])
    res["shard_add"] = m.particles.n_particles
    res["add_log_weights"] = _gathered(m.particles, mesh).log_weights.numpy()
    res["resampled"] = A.maybe_resample(m, float(m.num_particles))
    res["shard_resample"] = m.particles.n_particles
    res.update(_fields("", _gathered(m.particles, mesh)))
    res["weights"] = m.particle_weights()
    res["mcmc_structure"] = A.mcmc_structure(m, 2, 1, check=True)
    res["mcmc_parameters"] = A.mcmc_parameters(m, 2)
    res["shard_mcmc"] = m.particles.n_particles
    res.update(_fields("mcmc_", _gathered(m.particles, mesh)))
    res["logp"] = A.predict_proba(m, ts[:3], xs[:3])["logp"].to_numpy()
    d = A.to_dict(m)
    res["dict_noise_zs"] = np.asarray(d["noise_zs"])
    res["dict_log_weights"] = np.asarray(d["pf_state"]["log_weights"])
    kw = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    m2 = A.from_dict(d, **kw)
    res["shard_from_dict"] = m2.particles.n_particles
    res.update(_fields("from_dict_", _gathered(m2.particles, mesh)))
    return res


def case_flaky_init(mesh, world_size):
    """A sharded case of tests/test_robustness.py:60: the LML is NaN on
    the last rank's rows (the last P / world_size particles) in the first
    two batches initialize draws, so that rank retries twice; then one
    SMC round runs on the same generator."""
    P = 8
    cfg = C.GPConfig(max_depth=2, noise=0.54321)
    tab = TM.prior_tables(cfg, "cpu", F64)
    ts, xs = _series(1, 20)
    data = smc.make_dataset(ts, xs, dtype=F64, device="cpu")
    offset = 0 if mesh is None else mesh.shard(P // mesh.size).offset
    first_bad = P - P // world_size
    orig, calls = TM.lml, [0]

    def flaky(nt, *args):
        out = orig(nt, *args)
        calls[0] += 1
        rows = torch.arange(nt.shape[0]) + offset
        bad = (rows >= first_bad) & (calls[0] <= 4)
        return torch.where(bad, float("nan"), out)

    gen = torch.Generator().manual_seed(2)
    TM.lml = flaky
    try:
        parts = smc.initialize(gen, P, data, cfg, tab, max_retries=8,
                               mesh=mesh)
    finally:
        TM.lml = orig
    res = _fields("init_", _gathered(parts, mesh))
    res["lml_calls"] = calls[0]
    out, _ = smc.smc_round(gen, parts, data, cfg, tab, n_mcmc=2, n_hmc=1,
                           biased=False, allow_resample=True,
                           ess_threshold=float(P),
                           adaptive_rejuvenation=False,
                           hmc_cfg=hmc_mod.HMCConfig(L_param=3, L_noise=3),
                           mesh=mesh)
    res.update(_fields("", _gathered(out, mesh)))
    return res


def case_raises(mesh, world_size):
    """GPModel(mesh=) with a P the mesh does not divide raises ValueError
    (tests/test_parallel.py:225), as does an int mesh that is not the
    world size; an int equal to it builds the mesh."""
    if mesh is None:
        return {}
    ts, xs = _series(5, 20)
    res = {}
    for name, kw in (("p_not_divisible", {"n_particles": 3 * world_size // 2,
                                          "mesh": mesh}),
                     ("int_not_world_size", {"n_particles": 2 * world_size,
                                             "mesh": world_size + 1,
                                             "device": "cpu"})):
        try:
            A.GPModel(ts, xs, config=CFG, **kw)
            res[name] = False
        except ValueError:
            res[name] = True
    m = A.GPModel(ts, xs, n_particles=2 * world_size, config=CFG,
                  mesh=world_size, device="cpu")
    res["int_mesh_shard"] = m.particles.n_particles
    return res


CASES = {"round": case_round, "fit": case_fit, "streaming": case_streaming,
         "flaky_init": case_flaky_init, "raises": case_raises}


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world_size, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world_size, timeout=timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        mesh = pmesh.particle_mesh(device="cpu")
        res = {name: fn(mesh, world_size) for name, fn in CASES.items()}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world_size):
    """Every rank's results, after all ranks exited; a rank that raised
    or outlived the join's timeout fails."""
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = tmp.start_processes(
            _rank_main, args=(world_size, _free_port(), out_dir),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    pytest.fail(f"{world_size} ranks did not finish in "
                                f"{JOIN_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        out = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


_REFS = {}


def _reference(name, world_size):
    """The unsharded run of a case (once per case, or per world size for
    the cases that depend on it)."""
    key = (name, world_size if name in ("flaky_init", "raises") else None)
    if key not in _REFS:
        _REFS[key] = CASES[name](None, world_size)
    return _REFS[key]


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def ranks(request):
    torch.set_num_threads(1)
    return request.param, _spawn(request.param)


def _assert_equal_to_unsharded(name, world_size, per_rank):
    """Every rank's gathered results equal the unsharded run's (the sizes
    of the shards, keys "shard*", excepted)."""
    want = _reference(name, world_size)
    for r, res in enumerate(per_rank):
        got = res[name]
        for k, w in want.items():
            if k.startswith("shard"):
                continue
            w = np.asarray(w)
            msg = f"{name}: rank {r}, {k}"
            if w.dtype.kind in INT_KINDS:
                np.testing.assert_array_equal(got[k], w, err_msg=msg)
            else:
                np.testing.assert_allclose(got[k], w, rtol=1e-12, atol=0,
                                           err_msg=msg)


def _shard_sizes(name, per_rank, keys):
    return {(r, k): res[name][k] for r, res in enumerate(per_rank)
            for k in keys}


def test_sharded_smc_round_matches_unsharded(ranks):
    world_size, per_rank = ranks
    assert _reference("round", world_size)["resampled"]
    _assert_equal_to_unsharded("round", world_size, per_rank)
    assert set(_shard_sizes("round", per_rank, ["shard"]).values()) == {
        16 // world_size}


def test_fit_smc_mesh_matches_unsharded_full_driver(ranks):
    world_size, per_rank = ranks
    ref = _reference("fit", world_size)
    assert ref["round_stats"][:2, 1].all()   # resampling collectives ran
    assert ref["round_stats"][:, 3].sum() > 0   # and HMC sweeps
    _assert_equal_to_unsharded("fit", world_size, per_rank)
    assert set(_shard_sizes("fit", per_rank, ["shard"]).values()) == {
        16 // world_size}


def test_gpmodel_mesh_initialize_sharded_and_streaming(ranks):
    world_size, per_rank = ranks
    assert _reference("streaming", world_size)["resampled"]
    _assert_equal_to_unsharded("streaming", world_size, per_rank)
    sizes = _shard_sizes("streaming", per_rank,
                         ["shard_init", "shard_add", "shard_resample",
                          "shard_mcmc", "shard_from_dict"])
    assert set(sizes.values()) == {8 // world_size}


def test_mesh_that_does_not_divide_p_raises(ranks):
    world_size, per_rank = ranks
    for res in per_rank:
        r = res["raises"]
        assert r["p_not_divisible"] and r["int_not_world_size"]
        assert r["int_mesh_shard"] == 2


def test_initialize_retry_decided_over_all_ranks(ranks):
    world_size, per_rank = ranks
    ref = _reference("flaky_init", world_size)
    assert np.isfinite(ref["init_lml"]).all()
    assert np.isfinite(ref["init_log_weights"]).all()
    _assert_equal_to_unsharded("flaky_init", world_size, per_rank)
    # Only the last rank saw NaN, and it retried twice (six LML calls);
    # the others drew the same batches without a bad lane.
    assert [res["flaky_init"]["lml_calls"] for res in per_rank] == \
        [6] * world_size


# ---------------------------------------------------------------------------
# On the card: a particle's results do not depend on its batch
# ---------------------------------------------------------------------------

def _bits(t):
    t = t.detach().contiguous()
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.mark.gpu
@pytest.mark.parametrize("N", [256, 1024])
def test_particle_bits_do_not_depend_on_the_batch_on_the_card(N):
    """What a sharded fit's bits rest on: a particle's LML (value and
    under grad), its noise value and gradient (the K0 route) and its HMC
    prior sum are the same bits in batches of 1, 3, 7, 17 and 64, as
    HMC's compaction and a mesh's shards give them (gp_math.row_sum pads
    a batch under 16 rows on the card). The z-space gradient is left out:
    kernel 5 splits a particle's tiles into min(tiles, 8448 / P) runs, so
    in another batch its double sums group otherwise and a float32 entry
    can round to the next value."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev, f32 = torch.device("cuda"), torch.float32
    cfg = C.GPConfig(max_depth=5)
    tab = TM.prior_tables(cfg, dev, f32)
    gen = torch.Generator(device=dev).manual_seed(3)
    nt, pz = TM.sample_tree(gen, 64, tab, f32, dev)
    nz = torch.randn(64, generator=gen, device=dev)
    ts = torch.linspace(0, 1, N, device=dev)
    mask = (torch.arange(N, device=dev) < 3 * N // 4).float()
    xs = torch.sin(20 * ts) * mask

    def run(rows):
        n_, z_, w_ = nt[rows], pz[rows], nz[rows]
        with torch.enable_grad():   # the LmlTapeFused route's value
            v = TM.lml(n_, z_.clone().requires_grad_(True), w_, ts, xs,
                       mask, cfg, tab)
        K0 = TM.assemble_K0(n_, z_, ts, mask, cfg, tab)
        nv, ng = TM.lml_value_and_noise_grad_from_K0(K0, w_, xs, mask, cfg)
        pmask = (torch.arange(3, device=dev)
                 < tab.arity[n_][..., None]).to(f32)
        return v, nv, ng, hmc_mod._lp_params(z_, pmask)

    full = run(torch.arange(64, device=dev))
    for a, b in ((0, 1), (9, 12), (40, 47), (5, 22), (0, 64)):
        rows = torch.arange(a, b, device=dev)
        for x, y in zip(full, run(rows)):
            assert torch.equal(_bits(x[rows]), _bits(y)), (N, a, b)
