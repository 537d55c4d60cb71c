"""decompose's fragment models below float64: their LMLs in float64.

A fragment model has noise 1e-10 (plus the model jitter 1e-5) and is often
of low rank, so a float32 gram's rounding, far larger than the noise,
moves its LML far beyond 1e-3 or makes it non-finite. `decompose` of a
float32 model computes the fragments' LMLs by `model.lml_f64` (float64
encodings, data and tables; kernel 1's float64 entry on the card, its
plain version here) and stores them in the model's dtype. Held here on
the CPU against the same model in float64; the card's run:
tests/test_torch_cuda.py and chip_smoke.py phases 14 and 18.
"""

import numpy as np
import pytest
import torch

import autogp_tpu_torch as A
from autogp_tpu_torch import config as C
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.inference import smc


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _series(n):
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=np.float64)
    return t, (0.02 * t + 3 * np.sin(2 * np.pi * t / 52)
               + 1.5 * np.sin(2 * np.pi * t / 13)
               + 0.5 * rng.standard_normal(n))


@pytest.mark.parametrize("n,seed", [(256, 3), (200, 4)])
def test_float32_fragments_take_float64_lmls(n, seed):
    """A float32 model's fragment LMLs equal the float64 model's to the
    float32 rounding of the stored value, finite wherever those are; the
    fragment models keep the float32 model's dtype and device."""
    t, y = _series(n)
    A.seed(seed)
    m64 = A.GPModel(t, y, n_particles=6, device="cpu")
    m32 = A.from_dict(A.to_dict(m64), device="cpu", dtype=torch.float32)
    ref = A.from_dict(A.to_dict(m32), device="cpu", dtype=torch.float64)
    subs = A.decompose(m32)
    assert all(s.dtype == torch.float32 for s in subs)
    got = np.concatenate([s.particles.lml.double().numpy() for s in subs])
    want = np.concatenate([s.particles.lml.numpy()
                           for s in A.decompose(ref)])
    fin = np.isfinite(want)
    assert fin.sum() >= len(want) // 2
    assert np.isfinite(got[fin]).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


def test_lml_f64_is_the_float64_lml():
    """On float64 inputs, lml_f64 (a float64 Cholesky of the full gram)
    gives model.lml's value (the blocked driver) to 1e-10."""
    f64 = torch.float64
    cfg = C.GPConfig(max_depth=4)
    tab = TM.prior_tables(cfg, "cpu", f64)
    gen = torch.Generator().manual_seed(2)
    nt, pz = TM.sample_tree(gen, 8, tab, f64, "cpu")
    nz = torch.randn(8, generator=gen, dtype=f64)
    t, y = _series(100)
    data = smc.make_dataset(t / 100, (y - y.mean()) / np.ptp(y), dtype=f64,
                            device="cpu")
    args = (data.ts, data.xs, data.mask, cfg, tab)
    got = TM.lml_f64(nt, pz, nz, *args)
    want = TM.lml(nt, pz, nz, *args)
    fin = torch.isfinite(want)
    assert int(fin.sum()) >= 6
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-10, atol=0)
