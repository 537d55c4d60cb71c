"""Kernels 3-4: K^-1, beta, ||L^-1||_F^2 and L^-1 from a Cholesky factor
(csrc/kinv.cu).

Port of autogp_tpu/ops/kinv_pallas.py. One CUDA kernel family replaces
the Pallas `_kernel` (:73) in every one of its launches:

- `linv_stats_wd(L, alpha, wd)` -> (beta, fro), the noise-gradient
  statistics (`_launch(want_kinv=False, wd=...)`, :223), once per
  noise-HMC leapfrog;
- `kinv_beta_strips(alpha, wd, L)` -> (K^-1 lower-only, beta, fro), the
  LML gradient's cotangent inputs (`_launch_strips`, :276). The "strips"
  are the in-place factor of ops/chol.py's driver (chol_solve_strips), so
  this entry is also the reference's `kinv_beta_wd` (`want_kinv` with
  `wd` on an assembled L, :390-411): the port's strips are L itself;
- `linv_beta(L, alpha, wd=None)` -> (L^-1 with exact zeros above the
  diagonal, beta, fro), the `want_v` launch (:469-494) behind the in-tape
  L^-1 backend of the LML gradient (ops/cov_vjp.py, INTAPE_LINV). beta and
  fro come out bitwise those of `linv_stats_wd` on the same L and Wd;
- `kinv_beta(L, alpha)` and `linv_stats(L, alpha)`, the entries without
  Wd (:361-386, :415-432): Wd is `gp_math.tri_inv_blocked` of the
  factor's diagonal blocks (as the reference did in XLA, :195-200), then
  the kernel runs as in `kinv_beta_strips` / `linv_stats_wd`. `linv_beta`
  computes Wd the same way when it is not given.

beta = L^-T alpha (= K^-1 x when alpha = L^-1 x) and fro = ||L^-1||_F^2.
K^-1 is lower-only: strictly-upper B x B blocks are 0 and the diagonal
blocks dense, B = min(N, 128) as in the Cholesky driver, so one route
covers every power-of-two bucket >= 32. The kernel forms K^-1 = L^-T L^-1
on the tensor cores in 3xTF32, element (i, j) with column i of L^-1 as
the first operand, so the upper triangle of a diagonal block may differ
from its mirror by rounding; nothing reads it (kernel 5 weights it 0).
Kernel 5c's in-tape K^-1 tiles (ops/cov_vjp.py) form every lower element
bit for bit as this kernel does. The plain version's diagonal blocks are
symmetric.

CUDA tensors launch the kernel (float32, or the wrapper raises); CPU
tensors take the plain version, which ignores `wd` (as the JAX fallback
did): L^-1 by `torch.linalg.solve_triangular`, then
`gp_math.kinv_from_linv`. Each entry counts its own kernel launches and
nothing else: `strips_launches`, `stats_launches`, `linv_beta_launches`,
`kinv_beta_launches`, `linv_stats_launches`.
"""

from __future__ import annotations

import torch

from autogp_tpu_torch import backend
from autogp_tpu_torch import gp_math
from autogp_tpu_torch.ops.chol import BLOCK
from autogp_tpu_torch.utils import trace

strips_launches = 0
stats_launches = 0
linv_beta_launches = 0
kinv_beta_launches = 0
linv_stats_launches = 0


def linv_plain(L):
    """L^-1 [P, N, N] of a lower factor, exact zeros above the diagonal."""
    return gp_math.tri_inv_blocked(L)


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


def linv_beta_plain(L, alpha):
    """(L^-1, beta, fro): the plain version of the kernel's L^-1 output."""
    Linv = linv_plain(L)
    return (Linv, *_stats_plain(Linv, alpha))


def factor_wd(L):
    """Wd [P, N/B, B, B]: the inverses of L's diagonal B x B blocks, B =
    min(N, 128), for the entries that are not given the factorization's."""
    return gp_math.tri_inv_blocked(gp_math.diag_blocks(L, min(L.shape[-1],
                                                              BLOCK)))


def kinv_beta_strips(alpha, wd, L):
    """(K^-1 [P, N, N] lower-only, beta [P, N], ||L^-1||_F^2 [P]) from the
    strips-form factor of `chol.chol_solve_strips` (L in place, wd the
    per-panel Lkk^-1 [P, nb, B, B])."""
    global strips_launches
    if not backend.on_cuda(L):
        return kinv_beta_plain(L, alpha)
    out = _launch(L, alpha, wd, "kinv")
    strips_launches += 1
    return out


def linv_stats_wd(L, alpha, wd):
    """(beta [P, N], ||L^-1||_F^2 [P]) without K^-1, from the factor of
    `chol.chol_solve_strips`."""
    global stats_launches
    if not backend.on_cuda(L):
        return linv_stats_plain(L, alpha)
    _, beta, fro = _launch(L, alpha, wd, None)
    stats_launches += 1
    return beta, fro


def linv_beta(L, alpha, wd=None):
    """(V = L^-1 [P, N, N] with exact zeros above the diagonal, beta [P, N],
    ||L^-1||_F^2 [P]). `wd` is the factorization's per-panel Lkk^-1 (as
    `chol.chol_solve_strips` returns it); without it the wrapper computes
    it (`factor_wd`), as the reference's `linv_beta` does."""
    global linv_beta_launches
    if not backend.on_cuda(L):
        return linv_beta_plain(L, alpha)
    out = _launch(L, alpha, factor_wd(L) if wd is None else wd, "linv")
    linv_beta_launches += 1
    return out


def kinv_beta(L, alpha):
    """`kinv_beta_strips` for a factor without its Wd: (K^-1 lower-only,
    beta, fro)."""
    global kinv_beta_launches
    if not backend.on_cuda(L):
        return kinv_beta_plain(L, alpha)
    out = _launch(L, alpha, factor_wd(L), "kinv")
    kinv_beta_launches += 1
    return out


def linv_stats(L, alpha):
    """`linv_stats_wd` for a factor without its Wd: (beta, fro)."""
    global linv_stats_launches
    if not backend.on_cuda(L):
        return linv_stats_plain(L, alpha)
    _, beta, fro = _launch(L, alpha, factor_wd(L), None)
    linv_stats_launches += 1
    return beta, fro


def _launch(L, alpha, wd, out):
    """(mat, beta, fro) by one launch; mat is K^-1 lower-only for out =
    "kinv" (L^-1 then lives in a scratch), L^-1 for "linv", else None."""
    from autogp_tpu_torch.ops import _build
    with trace.span("ops.kinv"):
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
                             f"{tuple(wd.shape)} do not match L "
                             f"{tuple(L.shape)}")
        dev = L.device
        X = torch.empty_like(L)             # L^-1: scratch, or the output
        fro_part = torch.empty((P, N // B), dtype=torch.float64, device=dev)
        beta = torch.empty((P, N), dtype=f32, device=dev)
        fro = torch.empty((P,), dtype=f32, device=dev)
        lib = _build.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        if out == "linv":
            err = lib.autogp_linv_beta(L.data_ptr(), wd.data_ptr(),
                                       alpha.data_ptr(), X.data_ptr(),
                                       beta.data_ptr(), fro_part.data_ptr(),
                                       fro.data_ptr(), P, N, stream)
            _build.check("autogp_linv_beta", err)
            return X, beta, fro
        kinv = torch.empty_like(L) if out == "kinv" else None
        err = lib.autogp_kinv(L.data_ptr(), wd.data_ptr(), alpha.data_ptr(),
                              X.data_ptr(), beta.data_ptr(),
                              fro_part.data_ptr(), fro.data_ptr(),
                              None if kinv is None else kinv.data_ptr(), P, N,
                              stream)
        _build.check("autogp_kinv", err)
        return kinv, beta, fro
