"""Kernel 5: the tape backward of the covariance assembly, fused with the
MVN cotangent (csrc/cov_tape_bwd.cu), and the LML as an autograd Function.

Port of autogp_tpu/ops/cov_pallas_vjp.py:

- `cov_tape_bwd` wraps the CUDA kernel that replaces the Pallas
  `_bwd_kernel_tape` (:275) in its fused symmetric mode (fused=True,
  sym=True; launched by `_cov_grads_tape`, :543): given the lower-only
  K^-1, beta and the LML cotangent g of each particle it returns the
  gradient of g * LML with respect to the transformed parameters and the
  noise. Its plain version forms the cotangent 0.5 g (beta beta^T - K^-1)
  m m^T and takes the vector-Jacobian product of `cov.cov_tape_plain`
  with torch.autograd.grad.
- `LmlTapeFused` is `lml_tape_fused` (:842) over the batch. Forward:
  kernel 1 (lower_only), `chol.chol_solve_strips`, the LML value --
  bitwise the value-only route's. Backward: `kinv.kinv_beta_strips`, then
  kernel 5. Differentiable in (params_t, noise) only.

The kinv kernel and kernel 5 take every power-of-two N >= 32 (B = min(N,
128)), so there is no XLA-style fallback and no TAPE_CAP dispatch (that
cap was a VMEM budget). Kernel 5's unfused mode (a given cotangent, for
`cov_matrix_diff`) and its in-tape L^-1 mode have no caller in the port
and are not ported (ROADMAP.md).
"""

from __future__ import annotations

import torch

from autogp_tpu_torch import backend
from autogp_tpu_torch import gp_math
from autogp_tpu_torch.ops import chol, cov, kinv

launches = 0

TILE = 32   # csrc/cov_tape_bwd.cu kTile


def cov_tape_bwd_plain(node_type, params_t, ts, mask, kinv_lower, beta, g,
                       depth_cap: int):
    """Plain version of the kernel (same contract as `cov_tape_bwd`)."""
    Kinv = torch.tril(kinv_lower) + torch.tril(kinv_lower, -1).mT
    kbar = gp_math.mvn_logpdf_cotangent(beta, Kinv, mask, g)
    with torch.enable_grad():
        par = params_t.detach().requires_grad_(True)
        nz = torch.zeros(par.shape[0], dtype=par.dtype, device=par.device,
                         requires_grad=True)
        K = cov.cov_tape_plain(node_type, par, nz, ts, ts, mask, mask,
                               depth_cap, gram=True, lower_only=False)
        pbar, nbar = torch.autograd.grad(K, (par, nz), grad_outputs=kbar)
    return pbar, nbar


def cov_tape_bwd(node_type, params_t, ts, mask, kinv_lower, beta, g,
                 depth_cap: int):
    """(pbar [P, M, 3], nbar [P]): the gradient of sum_p g_p LML_p with
    respect to params_t [P, M, 3] and noise [P], given the lower-only
    K^-1 [P, N, N] and beta = K^-1 x [P, N] of each particle's gram.

    node_type [P, M]; ts, mask [N]; g [P]. CUDA tensors launch the kernel
    (float32, or it raises), CPU tensors take `cov_tape_bwd_plain`."""
    if not backend.on_cuda(params_t):
        return cov_tape_bwd_plain(node_type, params_t, ts, mask, kinv_lower,
                                  beta, g, depth_cap)
    return _launch(node_type, params_t, ts, mask, kinv_lower, beta, g,
                   depth_cap)


def _launch(node_type, params_t, ts, mask, kinv_lower, beta, g, depth_cap):
    global launches
    from autogp_tpu_torch.ops import _build
    P, M = node_type.shape
    N = ts.shape[0]
    if M != (1 << depth_cap) - 1:
        raise ValueError(f"heap of {M} slots does not match depth {depth_cap}")
    if N % TILE != 0:
        raise ValueError(f"cov_tape_bwd: N={N} is not a multiple of {TILE}")
    tslot, ttype, tlpos, trpos, tlen = cov.build_tape(node_type, depth_cap)
    f32 = torch.float32
    args = [("params", params_t, f32, 3), ("ts", ts, f32, 1),
            ("mask", mask, f32, 1), ("kinv", kinv_lower, f32, 3),
            ("beta", beta, f32, 2), ("g", g, f32, 1)]
    for name, t, dt, nd in args:
        backend.check_kernel_input(name, t, dt, nd)
    if (params_t.shape != (P, M, 3) or kinv_lower.shape != (P, N, N)
            or beta.shape != (P, N) or g.shape != (P,)
            or mask.shape != (N,)):
        raise ValueError("cov_tape_bwd: shapes do not match [P, M] trees "
                         "on N points")
    n_acc = 3 * M + 1
    nt = N // TILE
    dev = params_t.device
    partial = torch.empty((P, nt * (nt + 1) // 2, n_acc),
                          dtype=torch.float64, device=dev)
    out = torch.empty((P, n_acc), dtype=f32, device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.autogp_cov_tape_bwd(
        tslot.data_ptr(), ttype.data_ptr(), tlpos.data_ptr(),
        trpos.data_ptr(), tlen.data_ptr(), params_t.data_ptr(),
        ts.data_ptr(), mask.data_ptr(), kinv_lower.data_ptr(),
        beta.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
        P, M, N, stream)
    _build.check("autogp_cov_tape_bwd", err)
    launches += 1
    return out[:, :3 * M].reshape(P, M, 3), out[:, 3 * M]


class LmlTapeFused(torch.autograd.Function):
    """[P] LMLs of (ts, xs, mask) under trees node_type with transformed
    params_t [P, M, 3] and noise [P], differentiable in (params_t, noise).

    apply(params_t, noise, node_type, ts, xs, mask, depth_cap)."""

    @staticmethod
    def forward(ctx, params_t, noise, node_type, ts, xs, mask,
                depth_cap: int):
        P, N = node_type.shape[0], ts.shape[0]
        K = cov.cov_tape(node_type, params_t, noise, ts, ts, mask, mask,
                         depth_cap, gram=True, lower_only=True)
        d, alpha, wd, L = chol.chol_solve_strips(K, (xs * mask).expand(P, N))
        ctx.save_for_backward(params_t, alpha, wd, L, node_type, ts, mask)
        ctx.depth_cap = depth_cap
        return gp_math.mvn_logpdf_from_factor(d, alpha, mask)

    @staticmethod
    def backward(ctx, g):
        params_t, alpha, wd, L, node_type, ts, mask = ctx.saved_tensors
        Kinv, beta, _ = kinv.kinv_beta_strips(alpha, wd, L)
        pbar, nbar = cov_tape_bwd(node_type, params_t, ts, mask, Kinv, beta,
                                  g.contiguous(), ctx.depth_cap)
        return pbar, nbar, None, None, None, None, None
