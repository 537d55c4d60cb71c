"""The goldens the other port tests do not read, held to the port at the
JAX tests' tolerances (tests/test_golden.py:105-160,
tests/test_tpu_kernels.py's vjp_grad_f64 test): the joint-Cholesky
posterior, the GP-sum posterior and the mixture quantile of golden.json
(an independent mpmath transcription of the reference), and the float64
LML value and gradient truth of vjp_grad_f64.npz. CPU, float64."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from autogp_tpu_torch import config as C
from autogp_tpu_torch import gp_math
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.distributions import MixtureMvNormal, MvNormal

HERE = os.path.dirname(__file__)
GOLDEN = json.load(open(os.path.join(HERE, "golden", "golden.json")))
_CODE = {"CONST": C.CONSTANT, "LIN": C.LINEAR, "SE": C.SQUARED_EXPONENTIAL,
         "GE": C.GAMMA_EXPONENTIAL, "PER": C.PERIODIC, "+": C.PLUS,
         "*": C.TIMES, "CP": C.CHANGEPOINT}
F64 = torch.float64


@pytest.fixture(autouse=True)
def _torch_cpu():
    torch.set_num_threads(1)


def _cfg(**kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return C.GPConfig(**kw)


def _heap(spec, Mn):
    """[1, M] node types and [1, M, 3] whitened params of a golden tree."""
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
    return torch.as_tensor(nt)[None], torch.as_tensor(pz)[None]


def _setup():
    cfg = _cfg(max_depth=GOLDEN["max_depth"])
    tab = TM.prior_tables(cfg, "cpu", F64)
    d = GOLDEN["data"]
    ts = torch.as_tensor(d["ts"], dtype=F64)
    xs = torch.as_tensor(d["xs"], dtype=F64)
    return cfg, tab, ts, xs, torch.ones_like(ts), torch.as_tensor(
        d["ts_pred"], dtype=F64)


def test_posterior_mvn_golden():
    """test_posterior_mvn_golden: mean rtol 1e-8, covariance rtol 1e-6."""
    cfg, tab, ts, xs, mask, ts_pred = _setup()
    g = GOLDEN["posterior"]
    nt, pz = _heap(GOLDEN["trees"][g["tree"]], cfg.max_nodes)
    pt = TM.transform_params(nt, pz, tab)
    mu, cov = gp_math.posterior_mvn_masked(
        nt, pt, torch.tensor([g["noise"]], dtype=F64), ts, xs, mask,
        ts_pred, cfg.depth_cap,
        noise_pred=torch.tensor([g["noise_pred"]], dtype=F64))
    np.testing.assert_allclose(mu[0].numpy(), g["mu"], rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(cov[0].numpy(), g["cov"], rtol=1e-6,
                               atol=1e-10)


def test_infer_gp_sum_golden():
    """test_infer_gp_sum_golden: the components' blocks from the plain
    evaluator, then the joint-Cholesky GP-sum posterior (its 1e-8 jitter
    on Saa before conditioning, the reference's after: equal to ~1e-8);
    mean rtol 1e-6, covariance rtol 1e-5 / atol 5e-8."""
    cfg, tab, ts, xs, mask, ts_pred = _setup()
    g = GOLDEN["gp_sum"]
    p, n = g["p"], ts.shape[0]
    z = torch.cat([ts, ts_pred[:p]])
    blocks = []
    for comp in g["components"]:
        nt, pz = _heap(comp, cfg.max_nodes)
        K = gp_math.eval_cov(nt, TM.transform_params(nt, pz, tab), z, z,
                             cfg.depth_cap)[0]
        blocks.append((K[:n, :n], K[:n, n:], K[n:, n:]))
    Ktt, Ktp, Kpp = (torch.stack([b[i] for b in blocks])[None]
                     for i in range(3))
    mu, cov = gp_math.infer_gp_sum_from_blocks(
        Ktt, Ktp, Kpp, torch.tensor([g["noise"]], dtype=F64), xs, mask,
        noise_pred=torch.tensor([g["noise_pred"]], dtype=F64))
    np.testing.assert_allclose(mu[0].numpy(), g["mu"], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(cov[0].numpy(), g["cov"], rtol=1e-5,
                               atol=5e-8)


def test_mixture_quantile_golden():
    """test_mixture_quantile_golden: the bisection of the mixture CDF
    within 2e-6 of the golden quantiles."""
    g = GOLDEN["mixture_quantile"]
    mix = MixtureMvNormal(
        [MvNormal(np.array([m]), np.array([[s * s]]))
         for m, s in zip(g["mus"], g["sigmas"])],
        np.asarray(g["weights"]))
    for q, expect in g["quantiles"].items():
        x, ok = mix.quantile(float(q), tol=1e-8)
        assert ok
        np.testing.assert_allclose(x[0], expect, atol=2e-6)


def test_lml_value_and_gradient_vjp_golden():
    """vjp_grad_f64.npz (8 prior trees at depth cap 4, N = 256: the fused
    gradient route, LmlTapeFused): the value and the z-space gradients
    against the float64 truth with test_lml_fused_vjp_matches_unfused_tpu's
    tolerances (value rtol 5e-4 / atol 1e-4 N; parameter gradient 5e-4
    and noise gradient 1e-5 of the truth's scale, the bounds it holds
    well-conditioned particles to); every particle finite."""
    z = np.load(os.path.join(HERE, "golden", "vjp_grad_f64.npz"))
    cfg = _cfg(max_depth=4)
    tab = TM.prior_tables(cfg, "cpu", F64)
    N = len(z["ts"])
    ts = torch.as_tensor(z["ts"], dtype=F64)
    xs = torch.as_tensor(z["xs"], dtype=F64)
    mask = torch.ones_like(ts)
    nt = torch.as_tensor(z["node_type"], dtype=torch.int64)
    pz = torch.as_tensor(z["params"], dtype=F64).requires_grad_(True)
    nz = torch.as_tensor(z["noise_z"], dtype=F64).requires_grad_(True)
    val = TM.lml(nt, pz, nz, ts, xs, mask, cfg, tab)
    gp, gn = torch.autograd.grad(val.sum(), (pz, nz))
    v, gp, gn = val.detach().numpy(), gp.numpy(), gn.numpy()
    assert np.isfinite(v).all() and np.isfinite(gp).all()
    np.testing.assert_allclose(v, z["v64"], rtol=5e-4, atol=1e-4 * N)
    for i in range(len(v)):
        s = np.abs(z["gp64"][i]).max() + 1e-9
        assert np.abs(gp[i] - z["gp64"][i]).max() / s < 5e-4, i
        sn = abs(z["gn64"][i]) + 1e-9
        assert abs(gn[i] - z["gn64"][i]) / sn < 1e-5, i
