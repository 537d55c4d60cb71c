"""Kernel 2: per-panel Cholesky + inverse (csrc/chol_panel.cu), and the
blocked factor driver around it.

Port of autogp_tpu/ops/chol_pallas.py. `panel_factor` wraps the CUDA kernel
that replaces the Pallas `_panel_kernel` (:46-109, launched by
`_panel_factor`, :128) and the `tri_inv_blocked` call after it; its plain
version is `torch.linalg.cholesky_ex` plus a triangular solve, with NaN
written wherever `info > 0` (JAX returns NaN for a matrix that is not PD,
and `torch.linalg.cholesky` would raise).

The driver keeps the one-level right-looking design of `_factor_driver`
(:188-261): for each B-wide panel, kernel 2 factors the diagonal block and
inverts it, then plain IEEE-f32 matmuls form L21 = A21 Lkk^-T, the trailing
update A22 - L21 L21^T and the forward solve alpha = L^-1 x, as the JAX
package did in XLA. Only the lower triangle of the input is read. B =
min(N, 128), so every SMC bucket (N = 32 ... 1024) runs through the kernel.

Three entries, one driver: `chol_solve_diag` (diag(L), alpha) for the LML
value path, as `cholesky_solve_diag_batched` (:413); `chol_solve` (L,
alpha) for predict's train factor; `chol_solve_strips` (diag, alpha, Wd,
L) for the LML gradient and noise HMC, which covers both
`cholesky_solve_strips_batched` (:424) and `cholesky_solve_wd_batched`
(:403).
"""

from __future__ import annotations

import torch

from autogp_tpu_torch import backend

BLOCK = 128

launches = 0


def panel_factor_plain(A):
    """(L, L^-1) of a batch of B x B blocks [P, B, B], reading the lower
    triangle; both NaN for a particle whose block is not PD."""
    L, info = torch.linalg.cholesky_ex(torch.tril(A))
    L = torch.where((info > 0)[:, None, None],
                    torch.full((), float("nan"), dtype=A.dtype,
                               device=A.device), L)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return L, torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


def panel_factor(A):
    """(L, L^-1), each [P, B, B] contiguous, of the lower triangle of A.

    A may be a strided view (a diagonal block of a larger batch) whose
    last dimension is contiguous. CUDA tensors launch the kernel, CPU
    tensors take `panel_factor_plain`."""
    if not backend.on_cuda(A):
        return panel_factor_plain(A)
    return _launch(A)


def _launch(A):
    global launches
    from autogp_tpu_torch.ops import _build
    if A.dtype != torch.float32:
        raise TypeError(f"panel: expected torch.float32, got {A.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"panel: expected [P, B, B], got {tuple(A.shape)}")
    P, B, _ = A.shape
    if not 1 <= B <= BLOCK:
        raise ValueError(f"panel: B={B} outside 1..{BLOCK}")
    if A.stride(2) != 1:
        raise ValueError("panel: the last dimension must be contiguous")
    L = torch.empty((P, B, B), dtype=A.dtype, device=A.device)
    W = torch.empty_like(L)
    lib = _build.library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = lib.autogp_chol_panel(A.data_ptr(), A.stride(0), A.stride(1),
                                L.data_ptr(), W.data_ptr(), P, B, stream)
    _build.check("autogp_chol_panel", err)
    launches += 1
    return L, W


def _driver(K, x, want_l: bool, want_wd: bool = False):
    """Right-looking blocked factorization of K [P, N, N] with the solve
    alpha = L^-1 x riding the panel loop. Returns (L or None, diag(L),
    alpha, Wd or None); Wd [P, nb, B, B] stacks kernel 2's per-panel
    Lkk^-1 blocks. Every entry runs this same code, so diag and alpha are
    bitwise the same whichever outputs are kept."""
    P, N, _ = K.shape
    B = min(N, BLOCK)
    if N % B != 0:
        raise ValueError(f"N={N} is not a multiple of the panel width {B}")
    if backend.on_cuda(K):
        backend.require_ieee_f32()
    nb = N // B
    A = K
    xcur = x
    diags, alphas, wds = [], [], []
    L = torch.zeros_like(K) if want_l else None
    for k in range(nb):
        r0 = k * B
        Lkk, Winv = panel_factor(A[:, :B, :B])
        a_k = torch.matmul(Winv, xcur[:, :B, None])[..., 0]
        alphas.append(a_k)
        diags.append(torch.diagonal(Lkk, dim1=-2, dim2=-1))
        if want_wd:
            wds.append(Winv)
        if want_l:
            L[:, r0:r0 + B, r0:r0 + B] = Lkk
        if k + 1 < nb:
            L21 = torch.matmul(A[:, B:, :B], Winv.mT)       # [P, m-B, B]
            # Trailing update; only its lower triangle is read later.
            A = torch.baddbmm(A[:, B:, B:], L21, L21.mT, alpha=-1.0)
            xcur = xcur[:, B:] - torch.matmul(L21, a_k[..., None])[..., 0]
            if want_l:
                L[:, r0 + B:, r0:r0 + B] = L21
    wd = torch.stack(wds, dim=1) if want_wd else None
    return L, torch.cat(diags, dim=1), torch.cat(alphas, dim=1), wd


def chol_solve_diag(K, x):
    """(diag(L) [P, N], alpha = L^-1 x [P, N]) of a batch of SPD K
    [P, N, N] (lower triangle read): the LML value pair. NaN where the
    factorization fails."""
    _, d, alpha, _ = _driver(K, x, want_l=False)
    return d, alpha


def chol_solve(K, x):
    """(L [P, N, N], alpha [P, N]) of a batch of SPD K (lower read)."""
    L, _, alpha, _ = _driver(K, x, want_l=True)
    return L, alpha


def chol_solve_strips(K, x):
    """(diag(L), alpha, Wd [P, nb, B, B], L): the factorization of the
    gradient path and of noise HMC (the `cholesky_solve_strips_batched`
    and `cholesky_solve_wd_batched` contracts, chol_pallas.py:403-439).
    Wd stacks the per-panel diagonal-block inverses Lkk^-1 that kernel 2
    writes anyway, for the kinv kernel.

    The JAX package handed the factor over as nb block-column strips only
    to avoid [N, N] concatenations on the TPU. This driver writes L in
    place, so the "strips" here are that in-place L [P, N, N] (zeros above
    the diagonal); diag and alpha are bitwise `chol_solve_diag`'s."""
    L, d, alpha, wd = _driver(K, x, want_l=True, want_wd=True)
    return d, alpha, wd, L
