"""The control comes out not correct: the reference computed in TF32,
put in the program's place and read by each cell's own comparison and
limits (`check.readings` with the control on), at a size a test run can
hold: eight particles that a fit on the card left with ill-conditioned
grams, on 1024 points (the fit) and on a 512-point window (the stream).
The program's own float64 path on the CPU passes on the same particles,
its gradient and its reweight included."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, run, workload as W
from benchmark.reference import gp as ref

CELLS = {"config4.fit_p512_nopredict": 1024,
         "config5.stream_w512_nopredict": 512}
FIXTURE = json.loads((Path(__file__).parent
                      / "ill_conditioned.json").read_text())


def program_side(A, M, smc, config, t, y, n_prev):
    """The readings' inputs as the program's float64 path on the CPU
    makes them from the fixture's particles: the stored particles, one
    parameter-gradient call on the whole data, and a reweight from the
    first `n_prev` points to all of them."""
    f64 = torch.float64
    nt = torch.tensor(FIXTURE["node_type"])
    pz = torch.tensor(FIXTURE["params"], dtype=f64)
    nz = torch.tensor(FIXTURE["noise_z"], dtype=f64)
    g = config["gp_config"]
    cfg = A.GPConfig(changepoints=g["changepoints"], max_depth=g["max_depth"],
                     static_max_depth=g["static_max_depth"],
                     prior=config["prior"])
    tables = M.prior_tables(cfg, "cpu", f64)
    (ts, ti), (ys, yi) = check.transforms(t, y)
    tt, yy = ts * t + ti, ys * y + yi
    n, k = len(t), nt.shape[0]
    new = smc.make_dataset(tt, yy, dtype=f64, device="cpu")
    old = smc.make_dataset(tt, yy, n=n_prev, dtype=f64, device="cpu")
    q = pz.clone().requires_grad_(True)
    lml = M.lml(nt, q, nz, new.ts, new.xs, new.mask, cfg, tables)
    pmask = torch.as_tensor(ref.param_mask(nt), dtype=f64)
    u = -((M.normal_logpdf(q) * pmask).sum((-2, -1))
          + M.normal_logpdf(nz) + lml)
    (grad,) = torch.autograd.grad(u.sum(), q)
    call = {"node_type": nt, "params": pz, "noise_z": nz, "mask": new.mask,
            "lml": lml.detach(), "grad": grad}
    with torch.no_grad():
        lml = lml.detach()
        before = smc.Particles(
            node_type=nt, params=pz, noise_z=nz, log_weights=torch.zeros(k),
            lml=M.lml(nt, pz, nz, old.ts, old.xs, old.mask, cfg, tables),
            log_ml_est=torch.zeros(()), parents=torch.arange(k))
        after = smc.reweight(before, new, cfg, tables)
    particles = before.replace(lml=lml)
    return particles, {"grad": call, "reweight": (before, after)}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_a_number(cell):
    import autogp_tpu_torch as A
    from autogp_tpu_torch import model as M
    from autogp_tpu_torch.inference import smc
    _, _, config, traffic = run.load_cell(cell)
    traffic = dict(traffic, check=dict(traffic["check"], control=True))
    n = CELLS[cell]
    t, y = W.series(FIXTURE["series"], FIXTURE["series"]["seed"])
    t, y = t[:n], y[:n]
    particles, kept = program_side(A, M, smc, config, t, y, n - 1)
    record = {"particles": particles, "t": t, "y": y, "t_fit": t,
              "y_fit": y, "t_prev": t[:n - 1], "y_prev": y[:n - 1],
              "future": np.zeros(0), "df": None}
    got, ctl = check.readings(ref.Model(config), record, kept, traffic,
                              torch.device("cpu"))
    limits = {k: v for k, v in traffic["limits"].items() if k != "unmoved"}
    ok_prog, _ = check.judge(got, limits)
    ok_ctl, lines = check.judge(ctl, limits)
    assert ok_prog, got
    assert not ok_ctl, lines
    assert set(got) >= set(limits) and set(ctl) >= set(limits)
