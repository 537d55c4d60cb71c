"""Kernels 3-4: K^-1, beta and ||L^-1||_F^2 from a Cholesky factor
(csrc/kinv.cu).

Port of autogp_tpu/ops/kinv_pallas.py. One CUDA kernel family replaces
the Pallas `_kernel` (:73) in both of its launches on the HMC path:

- `linv_stats_wd(L, alpha, wd)` -> (beta, fro), the noise-gradient
  statistics (`_launch(want_kinv=False, wd=...)`, :223), once per
  noise-HMC leapfrog;
- `kinv_beta_strips(alpha, wd, L)` -> (K^-1 lower-only, beta, fro), the
  LML gradient's cotangent inputs (`_launch_strips`, :276). The "strips"
  are the in-place factor of ops/chol.py's driver (chol_solve_strips).

beta = L^-T alpha (= K^-1 x when alpha = L^-1 x) and fro = ||L^-1||_F^2.
K^-1 is lower-only: strictly-upper B x B blocks are 0 and the diagonal
blocks dense-symmetric, B = min(N, 128) as in the Cholesky driver, so one
route covers every power-of-two bucket >= 32.

CUDA tensors launch the kernel (float32, or the wrapper raises); CPU
tensors take the plain version, which ignores `wd` (as the JAX fallback
did): L^-1 by `torch.linalg.solve_triangular`, then
`gp_math.kinv_from_linv`. `strips_launches` and `stats_launches` count
the kernel launches of `kinv_beta_strips` and `linv_stats_wd`, and
nothing else.
"""

from __future__ import annotations

import torch

from autogp_tpu_torch import backend
from autogp_tpu_torch import gp_math
from autogp_tpu_torch.ops.chol import BLOCK

strips_launches = 0
stats_launches = 0


def linv_plain(L):
    """L^-1 [P, N, N] of a lower factor, by triangular solve."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def _stats_plain(Linv, alpha):
    beta = torch.matmul(Linv.mT, alpha[..., None])[..., 0]
    return beta, torch.sum(Linv * Linv, dim=(-2, -1))


def kinv_beta_plain(L, alpha):
    """(K^-1 lower-only, beta, fro): the plain version of the kernel."""
    Linv = linv_plain(L)
    beta, fro = _stats_plain(Linv, alpha)
    return gp_math.kinv_from_linv(Linv), beta, fro


def linv_stats_plain(L, alpha):
    """(beta, fro): the plain version of the kernel without K^-1."""
    return _stats_plain(linv_plain(L), alpha)


def kinv_beta_strips(alpha, wd, L):
    """(K^-1 [P, N, N] lower-only, beta [P, N], ||L^-1||_F^2 [P]) from the
    strips-form factor of `chol.chol_solve_strips` (L in place, wd the
    per-panel Lkk^-1 [P, nb, B, B])."""
    if not backend.on_cuda(L):
        return kinv_beta_plain(L, alpha)
    return _launch(L, alpha, wd, want_kinv=True)


def linv_stats_wd(L, alpha, wd):
    """(beta [P, N], ||L^-1||_F^2 [P]) without K^-1, from the factor of
    `chol.chol_solve_strips`."""
    if not backend.on_cuda(L):
        return linv_stats_plain(L, alpha)
    _, beta, fro = _launch(L, alpha, wd, want_kinv=False)
    return beta, fro


def _launch(L, alpha, wd, want_kinv: bool):
    global strips_launches, stats_launches
    from autogp_tpu_torch.ops import _build
    f32 = torch.float32
    backend.check_kernel_input("L", L, f32, 3)
    backend.check_kernel_input("alpha", alpha, f32, 2)
    backend.check_kernel_input("wd", wd, f32, 4)
    P, N, _ = L.shape
    B = min(N, BLOCK)
    if B not in (32, 64, 128) or N % B != 0 or L.shape[2] != N:
        raise ValueError(f"kinv: N={N} must be a power of two >= 32")
    if alpha.shape != (P, N) or wd.shape != (P, N // B, B, B):
        raise ValueError(f"kinv: alpha {tuple(alpha.shape)} / wd "
                         f"{tuple(wd.shape)} do not match L {tuple(L.shape)}")
    dev = L.device
    X = torch.empty_like(L)                          # L^-1 scratch
    fro_part = torch.empty((P, N // B), dtype=torch.float64, device=dev)
    beta = torch.empty((P, N), dtype=f32, device=dev)
    fro = torch.empty((P,), dtype=f32, device=dev)
    kinv = torch.empty_like(L) if want_kinv else None
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.autogp_kinv(L.data_ptr(), wd.data_ptr(), alpha.data_ptr(),
                          X.data_ptr(), beta.data_ptr(),
                          fro_part.data_ptr(), fro.data_ptr(),
                          kinv.data_ptr() if want_kinv else None, P, N,
                          stream)
    _build.check("autogp_kinv", err)
    if want_kinv:
        strips_launches += 1
    else:
        stats_launches += 1
    return kinv, beta, fro
