"""`LmlTapeFused` (autogp_tpu_torch.ops.cov_vjp) against the JAX
package's `lml_tape_fused` in interpret mode, on the CPU in float64: the
port's autograd Function and the JAX custom VJP it ports, on trees whose
tapes sit on both sides of the JAX package's TAPE_CAP = 19. The trees and
data are tests/test_torch_grad.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autogp_tpu.ops import cov_pallas_vjp
from autogp_tpu_torch import model as TM
from autogp_tpu_torch.ops import cov_vjp
from test_torch_grad import _cfg, _data, mixed_trees

F64 = torch.float64


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


def test_lml_tape_fused_matches_jax():
    """LmlTapeFused value and (params_t, noise) gradients against
    jax.value_and_grad of lml_tape_fused(interpret=True) at N=128: rtol
    1e-9 (float64; the same factorization and cotangent, different
    summation orders)."""
    cfg, _ = _cfg()
    tab = TM.prior_tables(cfg, "cpu", F64)
    nt, pz = (a[1:3] for a in mixed_trees(7))    # tapes of 19 and 23
    ts, xs, mask = _data(128, seed=7)
    ntt = torch.as_tensor(nt)
    pt = TM.transform_params(ntt, torch.as_tensor(pz), tab)
    noise = torch.as_tensor(np.linspace(0.05, 0.5, len(nt)))
    ptg, ng = pt.clone().requires_grad_(True), noise.clone().requires_grad_()
    v = cov_vjp.LmlTapeFused.apply(ptg, ng, ntt, torch.as_tensor(ts),
                                   torch.as_tensor(xs), torch.as_tensor(mask),
                                   5)
    gp, gn = torch.autograd.grad(v.sum(), (ptg, ng))
    for i in range(len(nt)):
        vj, (gpj, gnj) = jax.value_and_grad(
            lambda p, n: cov_pallas_vjp.lml_tape_fused(
                jnp.asarray(nt[i]), p, n, jnp.asarray(ts), jnp.asarray(xs),
                jnp.asarray(mask), 5, interpret=True), argnums=(0, 1))(
            jnp.asarray(pt[i].numpy()), jnp.asarray(float(noise[i])))
        np.testing.assert_allclose(float(v[i].detach()), float(vj),
                                   rtol=1e-10)
        gpj = np.asarray(gpj)
        np.testing.assert_allclose(gp[i].numpy(), gpj, rtol=0,
                                   atol=1e-9 * np.abs(gpj).max())
        np.testing.assert_allclose(float(gn[i]), float(gnj), rtol=1e-9)
