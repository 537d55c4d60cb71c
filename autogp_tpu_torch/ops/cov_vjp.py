"""Kernels 5 and 7: the backward of the covariance assembly, tape-driven
(csrc/cov_tape_bwd.cu) and per-slot (csrc/cov_slot_bwd.cu), the assembly
and the LML as autograd Functions.

Port of autogp_tpu/ops/cov_pallas_vjp.py:

- `cov_tape_bwd` wraps the CUDA kernel that replaces the Pallas
  `_bwd_kernel_tape` (:275) in its fused symmetric mode (fused=True,
  sym=True; launched by `_cov_grads_tape`, :543): given the lower-only
  K^-1, beta and the LML cotangent g of each particle it returns the
  gradient of g * LML with respect to the transformed parameters and the
  noise. Its plain version forms the cotangent 0.5 g (beta beta^T - K^-1)
  m m^T and takes the vector-Jacobian product of `cov.cov_tape_plain`
  with torch.autograd.grad.
- `cov_tape_bwd_linv` wraps the same kernel's in-tape L^-1 entry (the
  Pallas kernel's `linv=True` mode, :289-297, :381-397, :646-655, only with
  sym): the same contract, given V = L^-1 with exact zeros above the
  diagonal (`kinv.linv_beta`) in place of K^-1. Each block forms its K^-1
  tile from two column strips of V, so K^-1 never exists in device
  memory. Its plain version is `cov_tape_bwd_plain` on
  `gp_math.kinv_from_linv(V)`.
- `cov_grads_tape` wraps the same kernel's unfused entry (`beta=None`
  there): the cotangent Kbar [P, N, N] itself is the input, no symmetry is
  assumed and every tile is visited.
- `cov_grads` wraps the CUDA kernels that replace the per-slot
  `_bwd_kernel` (:117, launched by `_cov_grads`, :676): the same contract,
  given the heaps instead of tapes. A device pass compacts each heap into
  its tape, then the unfused entry's body runs on it, so the result is
  bitwise `cov_grads_tape`'s; one C call, three launches, no tape built
  here. Both share one plain version, the vector-Jacobian product of
  `cov.cov_matrix_plain`.
- `cov_matrix_diff` (:741) is the assembly as an autograd Function: forward
  kernel 1 (`tape=True`) or kernel 6, backward `cov_grads_tape` or
  `cov_grads`. Differentiable in (params_t, noise) only.
- `LmlTapeFused` is `lml_tape_fused` (:842) over the batch. Forward:
  kernel 1 (lower_only), `chol.chol_solve_strips`, the LML value --
  bitwise the value-only route's. Backward, chosen by the module constant
  `INTAPE_LINV` (cov_pallas_vjp.py:33, read when the forward runs):
  `kinv.kinv_beta_strips`, then kernel 5 (False, the default, as in the
  reference), or `kinv.linv_beta` on the same factor and Wd, then
  `cov_tape_bwd_linv` (True). Differentiable in (params_t, noise) only.

The kinv kernel and kernel 5 take every power-of-two N >= 32 (B = min(N,
128)) and there is no TAPE_CAP dispatch (that cap was a VMEM budget);
`model.lml` sends the buckets the reference sends (power-of-two N >= 64)
to `LmlTapeFused` and the rest through `cov_matrix_diff`. `launches`,
`linv_launches`, `unfused_launches` and `slot_launches` count the launches
of `cov_tape_bwd`, `cov_tape_bwd_linv`, `cov_grads_tape` and `cov_grads`,
and nothing else.

Each kernel entry splits a particle's tiles into runs by the size of the
batch (`bwd_chunks`), and its double sums follow that split. So every
entry, and `cov_matrix_diff` and `LmlTapeFused` above them, take an
optional `part_batch`: the batch whose split to use (default: the batch
given). A mesh's shard or HMC's live lanes pass the whole batch's count,
and each particle's gradient is then bit for bit what the whole batch
gives it.
"""

from __future__ import annotations

import torch

from autogp_tpu_torch import backend
from autogp_tpu_torch import gp_math
from autogp_tpu_torch.ops import chol, cov, kinv

launches = 0
linv_launches = 0
unfused_launches = 0
slot_launches = 0

TILE = 32   # csrc/cov_tape_bwd.cu kTile

# The tape backward's block geometry (csrc/cov_tape_bwd.cu kThreads,
# kBudget, kBudgetLinv, kTargetBlocks, kStaging): the partial scratch is
# sized here by `bwd_chunks`, and the tests hold `bwd_threads` and
# `tile_runs` to what the kernel must do. The in-tape entry stages two
# 32-row slabs of each of its two V strips, rows padded to 40 floats, and
# 16 bytes to align them.
BWD_THREADS = 256
BWD_BUDGET = 48 * 1024
BWD_BUDGET_LINV = 46 * 1024
BWD_TARGET_BLOCKS = 8448
BWD_STAGING = 2 * 2 * TILE * (TILE + 8) * 4 + 16

# Gradient terms of a tape instruction, by node type (config.py codes 1-9).
TERMS_OF_TYPE = cov.TERMS_OF_TYPE
tape_terms = cov.tape_terms

# LmlTapeFused's backward backend: False = K^-1 by the kinv kernel, then
# kernel 5; True = L^-1 by the kinv kernel, then kernel 5's in-tape mode.
# A/B: autogp_tpu_torch/scripts/bench_grad_ab.py.
INTAPE_LINV = False


def part_of(P: int, part_batch: int | None) -> int:
    """The batch whose partition a launch of P particles uses: part_batch,
    which may not be smaller than P, or P itself."""
    if part_batch is None:
        return P
    if part_batch < P:
        raise ValueError(f"part_batch={part_batch} is smaller than the "
                         f"batch of {P}")
    return int(part_batch)


def bwd_chunks(P: int, N: int, fused: bool,
               part_batch: int | None = None) -> int:
    """Blocks per particle of the tape backward: min(tiles, max(1,
    BWD_TARGET_BLOCKS // B)), tiles = the lower tiles (fused entries) or
    all tiles of the ceil(N / 32)-tile grid, B = `part_of(P, part_batch)`."""
    nt = -(-N // TILE)
    tiles = nt * (nt + 1) // 2 if fused else nt * nt
    return min(tiles, max(1, BWD_TARGET_BLOCKS // part_of(P, part_batch)))


def given_scratch(P: int, M: int, N: int, part_batch: int | None = None,
                  max_len: int | None = None):
    """Shapes of the scratch of the given-cotangent entries: the partial
    sums [P, bwd_chunks(P, N, False, part_batch), 3 L + 1] (float64) of
    the unfused body, which `cov_grads` runs too, for the batch's longest
    tape L = max_len (default M: at most 3 L + 1 terms), and `cov_grads`'
    tapes [5 P M + P] (int32: slot, type, lpos and rpos [P, M] each, each
    slot's tape position [P, M], then the lengths)."""
    L = M if max_len is None else max_len
    return ((P, bwd_chunks(P, N, False, part_batch), 3 * L + 1),
            (5 * P * M + P,))


def bwd_threads(length: int, n_terms: int, linv: bool,
                budget: int | None = None) -> int:
    """Threads a block of the tape backward runs for a tape of `length`
    positions and `n_terms` gradient terms (the noise's included): the
    most, up to BWD_THREADS and a multiple of 32 from 32 up, whose double
    accumulators (8 n_terms bytes each) and value and adjoint stacks (12
    bytes per position each, or the in-tape entry's staging strips if
    larger) fit `budget` bytes (by default BWD_BUDGET, BWD_BUDGET_LINV for
    the in-tape entry: the budgets when the grid fills the card; the
    kernel grows them for a smaller grid)."""
    if budget is None:
        budget = BWD_BUDGET_LINV if linv else BWD_BUDGET
    t = budget // (12 * length + 8 * n_terms)
    if linv:
        t = min(t, (budget - BWD_STAGING) // (8 * n_terms))
    t = min(t, BWD_THREADS)
    return t // 32 * 32 if t >= 32 else max(t, 1)


def tile_runs(mask, P: int, fused: bool, part_batch: int | None = None):
    """The tiles each block of a particle visits, as the kernel walks them:
    a list of bwd_chunks(P, N, fused, part_batch) lists of (ti, tj), the
    same for every particle of the batch. Fused: the lower
    tiles whose 32 rows and 32 columns each hold a point with mask != 0,
    row by row; otherwise every tile, row by row. Block c takes the c-th
    run of ceil(tiles / chunks) of them."""
    N = mask.shape[0]
    nt = -(-N // TILE)
    if fused:
        rows = [r for r in range(nt)
                if bool((mask[r * TILE:(r + 1) * TILE] != 0).any())]
        tiles = [(a, b) for i, a in enumerate(rows) for b in rows[:i + 1]]
    else:
        tiles = [(a, b) for a in range(nt) for b in range(nt)]
    chunks = bwd_chunks(P, N, fused, part_batch)
    per = -(-len(tiles) // chunks)
    return [tiles[c * per:(c + 1) * per] for c in range(chunks)]


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
                 depth_cap: int, *, part_batch: int | None = None,
                 tape: cov.Tape | None = None):
    """(pbar [P, M, 3], nbar [P]): the gradient of sum_p g_p LML_p with
    respect to params_t [P, M, 3] and noise [P], given the lower-only
    K^-1 [P, N, N] and beta = K^-1 x [P, N] of each particle's gram.

    node_type [P, M]; ts, mask [N]; g [P]. CUDA tensors launch the kernel
    (float32, or it raises) with the partition of `part_batch` >= P
    particles (default P), CPU tensors take `cov_tape_bwd_plain`. `tape`:
    the batch's `cov.tape` if the caller has it (None: built here)."""
    global launches
    if not backend.on_cuda(params_t):
        return cov_tape_bwd_plain(node_type, params_t, ts, mask, kinv_lower,
                                  beta, g, depth_cap)
    out = _launch(node_type, params_t, ts, mask, kinv_lower, beta, g,
                  depth_cap, linv=False, part_batch=part_batch, tp=tape)
    launches += 1
    return out


def cov_tape_bwd_linv(node_type, params_t, ts, mask, V, beta, g,
                      depth_cap: int, *, part_batch: int | None = None,
                      tape: cov.Tape | None = None):
    """`cov_tape_bwd` given V = L^-1 [P, N, N] (exact zeros above the
    diagonal, as `kinv.linv_beta` returns it) in place of the lower-only
    K^-1: the kernel forms each K^-1 tile from two column strips of V.
    CUDA tensors launch the kernel (float32, or it raises; `part_batch` and
    `tape` as in `cov_tape_bwd`), CPU tensors take `cov_tape_bwd_plain` on
    `gp_math.kinv_from_linv(V)`."""
    global linv_launches
    if not backend.on_cuda(params_t):
        return cov_tape_bwd_plain(node_type, params_t, ts, mask,
                                  gp_math.kinv_from_linv(V), beta, g,
                                  depth_cap)
    out = _launch(node_type, params_t, ts, mask, V, beta, g, depth_cap,
                  linv=True, part_batch=part_batch, tp=tape)
    linv_launches += 1
    return out


def _launch(node_type, params_t, ts, mask, kmat, beta, g, depth_cap,
            linv: bool, part_batch: int | None, tp: cov.Tape | None = None):
    """One launch of the fused entry (kmat = K^-1 lower-only) or of the
    in-tape L^-1 entry (kmat = V), with the partition of
    `part_of(P, part_batch)` particles."""
    from autogp_tpu_torch.ops import _build
    P, M = node_type.shape
    N = ts.shape[0]
    if M != (1 << depth_cap) - 1:
        raise ValueError(f"heap of {M} slots does not match depth {depth_cap}")
    if N % TILE != 0:
        raise ValueError(f"cov_tape_bwd: N={N} is not a multiple of {TILE}")
    name = "autogp_cov_tape_bwd_linv" if linv else "autogp_cov_tape_bwd"
    if tp is None:
        tp = cov.tape(node_type, depth_cap)
    cov.check_tape(name[7:], tp.max_len, tp.max_terms)
    f32 = torch.float32
    args = [("params", params_t, f32, 3), ("ts", ts, f32, 1),
            ("mask", mask, f32, 1), ("kmat", kmat, f32, 3),
            ("beta", beta, f32, 2), ("g", g, f32, 1)]
    for arg, t, dt, nd in args:
        backend.check_kernel_input(arg, t, dt, nd)
    if (params_t.shape != (P, M, 3) or kmat.shape != (P, N, N)
            or beta.shape != (P, N) or g.shape != (P,)
            or mask.shape != (N,)):
        raise ValueError("cov_tape_bwd: shapes do not match [P, M] trees "
                         "on N points")
    dev = params_t.device
    part = part_of(P, part_batch)
    partial = torch.empty((P, bwd_chunks(P, N, True, part),
                           3 * tp.max_len + 1),
                          dtype=torch.float64, device=dev)
    out = torch.empty((P, 3 * M + 1), dtype=f32, device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, name)(
        tp.slot.data_ptr(), tp.type.data_ptr(), tp.lpos.data_ptr(),
        tp.rpos.data_ptr(), tp.length.data_ptr(), params_t.data_ptr(),
        ts.data_ptr(), mask.data_ptr(), kmat.data_ptr(),
        beta.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
        P, M, N, tp.max_len, part, stream)
    _build.check(name, err)
    return out[:, :3 * M].reshape(P, M, 3), out[:, 3 * M]


def cov_grads_plain(node_type, params_t, kbar, ts, mask, depth_cap: int,
                    masked: bool = True):
    """Plain version of `cov_grads_tape` and `cov_grads`: the
    vector-Jacobian product of `cov.cov_matrix_plain` with kbar."""
    with torch.enable_grad():
        par = params_t.detach().requires_grad_(True)
        nz = torch.zeros(par.shape[0], dtype=par.dtype, device=par.device,
                         requires_grad=True)
        K = cov.cov_matrix_plain(node_type, par, nz, ts, mask, depth_cap,
                                 masked)
        pbar, nbar = torch.autograd.grad(K, (par, nz), grad_outputs=kbar)
    return pbar, nbar


def cov_grads_tape(node_type, params_t, kbar, ts, mask, depth_cap: int,
                   masked: bool = True, *, part_batch: int | None = None,
                   tape: cov.Tape | None = None):
    """(pbar [P, M, 3], nbar [P]): the gradient of sum_ij kbar_ij K_ij
    with respect to params_t and the noise, K the assembled gram of
    `cov.cov_tape` / `cov.cov_matrix`, by the tape backward in its unfused
    mode. kbar [P, N, N] is any cotangent (no symmetry assumed); with
    `masked` it is multiplied by mask_i mask_j. Any N. CUDA tensors launch
    the kernel (float32, or it raises; `part_batch` and `tape` as in
    `cov_tape_bwd`), CPU tensors take `cov_grads_plain`."""
    if not backend.on_cuda(params_t):
        return cov_grads_plain(node_type, params_t, kbar, ts, mask,
                               depth_cap, masked)
    return _launch_given(node_type, params_t, kbar, ts, mask, depth_cap,
                         masked, part_batch, tp=tape or
                         cov.tape(node_type, depth_cap))


def cov_grads(node_type, params_t, kbar, ts, mask, depth_cap: int,
              masked: bool = True, *, part_batch: int | None = None,
              maxima=None):
    """The contract of `cov_grads_tape`, by the per-slot backward: the
    heaps are compacted into tapes on the device, then the unfused body
    runs on them (bitwise `cov_grads_tape`). `maxima`: the batch's
    `cov.heap_maxima` if the caller has them (None: read here)."""
    if not backend.on_cuda(params_t):
        return cov_grads_plain(node_type, params_t, kbar, ts, mask,
                               depth_cap, masked)
    return _launch_given(node_type, params_t, kbar, ts, mask, depth_cap,
                         masked, part_batch, maxima=maxima or
                         cov.heap_maxima(node_type, depth_cap))


def _launch_given(node_type, params_t, kbar, ts, mask, depth_cap, masked,
                  part_batch: int | None, tp: cov.Tape | None = None,
                  maxima=None):
    """Launch the tape backward's unfused entry on the Tape `tp`, or (no
    tape) the per-slot backward on the heaps, whose `maxima` are given,
    with a given cotangent."""
    global unfused_launches, slot_launches
    from autogp_tpu_torch.ops import _build
    P, M = node_type.shape
    N = ts.shape[0]
    if M != (1 << depth_cap) - 1:
        raise ValueError(f"heap of {M} slots does not match depth {depth_cap}")
    max_len, _, max_terms = (tp.max_len, 0, tp.max_terms) if tp else maxima
    name = "cov_tape_bwd_unfused" if tp else "cov_slot_bwd"
    cov.check_tape(name, max_len, max_terms)
    f32 = torch.float32
    for arg, t, nd in (("params", params_t, 3), ("ts", ts, 1),
                        ("mask", mask, 1), ("kbar", kbar, 3)):
        backend.check_kernel_input(arg, t, f32, nd)
    if (params_t.shape != (P, M, 3) or kbar.shape != (P, N, N)
            or mask.shape != (N,)):
        raise ValueError("cov_grads: shapes do not match [P, M] trees on N "
                         "points")
    part = part_of(P, part_batch)
    part_shape, tapes_shape = given_scratch(P, M, N, part, max_len)
    dev = params_t.device
    partial = torch.empty(part_shape, dtype=torch.float64, device=dev)
    out = torch.empty((P, 3 * M + 1), dtype=f32, device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if tp:
        err = lib.autogp_cov_tape_bwd_unfused(
            tp.slot.data_ptr(), tp.type.data_ptr(), tp.lpos.data_ptr(),
            tp.rpos.data_ptr(), tp.length.data_ptr(), params_t.data_ptr(),
            ts.data_ptr(), mask.data_ptr(), kbar.data_ptr(),
            partial.data_ptr(), out.data_ptr(), P, M, N, int(masked),
            max_len, part, stream)
        _build.check("autogp_cov_tape_bwd_unfused", err)
        unfused_launches += 1
    else:
        nt32, order = cov.slot_inputs(node_type, depth_cap)
        tapes = torch.empty(tapes_shape, dtype=torch.int32, device=dev)
        err = lib.autogp_cov_slot_bwd(
            nt32.data_ptr(), order.data_ptr(), params_t.data_ptr(),
            ts.data_ptr(), mask.data_ptr(), kbar.data_ptr(),
            tapes.data_ptr(), partial.data_ptr(), out.data_ptr(), P, M, N,
            int(masked), max_len, part, stream)
        _build.check("autogp_cov_slot_bwd", err)
        slot_launches += 1
    return out[:, :3 * M].reshape(P, M, 3), out[:, 3 * M]


class CovMatrixDiff(torch.autograd.Function):
    """apply(params_t, noise, node_type, ts, mask, depth_cap, masked,
    tape, part_batch): the gram [P, N, N] of `cov_matrix_diff`."""

    @staticmethod
    def forward(ctx, params_t, noise, node_type, ts, mask, depth_cap: int,
                masked: bool, tape: bool, part_batch):
        ctx.save_for_backward(params_t, node_type, ts, mask)
        ctx.opts = (depth_cap, masked, tape, part_batch)
        # The forward's tape (or the heaps' maxima) serves the backward.
        on_card = backend.on_cuda(params_t)
        if not tape:
            ctx.shape = (cov.heap_maxima(node_type, depth_cap) if on_card
                         else None)
            return cov.cov_matrix(node_type, params_t, noise, ts, mask,
                                  depth_cap, masked, maxima=ctx.shape)
        ctx.shape = cov.tape(node_type, depth_cap) if on_card else None
        m = mask if masked else torch.ones_like(mask)
        return cov.cov_tape(node_type, params_t, noise, ts, ts, m, m,
                            depth_cap, gram=True, lower_only=False,
                            tape=ctx.shape)

    @staticmethod
    def backward(ctx, kbar):
        params_t, node_type, ts, mask = ctx.saved_tensors
        depth_cap, masked, tape, part_batch = ctx.opts
        args = (node_type, params_t, kbar.contiguous(), ts, mask, depth_cap,
                masked)
        if tape:
            pbar, nbar = cov_grads_tape(*args, part_batch=part_batch,
                                        tape=ctx.shape)
        else:
            pbar, nbar = cov_grads(*args, part_batch=part_batch,
                                   maxima=ctx.shape)
        return pbar, nbar, None, None, None, None, None, None, None


def cov_matrix_diff(node_type, params_t, noise, ts, mask, depth_cap: int,
                    masked: bool = True, tape: bool = True, *,
                    part_batch: int | None = None):
    """Differentiable assembly [P, N, N] = eval_cov(tree)(ts, ts) +
    noise I, padded rows and columns the identity when `masked`
    (cov_pallas_vjp.py:741-768). Forward: the tape kernel (`tape=True`) or
    the per-slot kernel; backward: `cov_grads_tape` or `cov_grads`.
    Differentiable in (params_t, noise); node_type, ts and mask are
    constants. The backward uses the partition of `part_batch` particles
    (`cov_grads_tape`)."""
    return CovMatrixDiff.apply(params_t, noise, node_type, ts, mask,
                               depth_cap, masked, tape, part_batch)


class LmlTapeFused(torch.autograd.Function):
    """[P] LMLs of (ts, xs, mask) under trees node_type with transformed
    params_t [P, M, 3] and noise [P], differentiable in (params_t, noise).

    apply(params_t, noise, node_type, ts, xs, mask, depth_cap,
    part_batch); the backward's kernel 5 uses the partition of
    `part_batch` particles (None: the batch's own)."""

    @staticmethod
    def forward(ctx, params_t, noise, node_type, ts, xs, mask,
                depth_cap: int, part_batch=None):
        P, N = node_type.shape[0], ts.shape[0]
        # One tape for kernel 1 here and kernel 5 in the backward.
        ctx.tape = (cov.tape(node_type, depth_cap)
                    if backend.on_cuda(params_t) else None)
        K = cov.cov_tape(node_type, params_t, noise, ts, ts, mask, mask,
                         depth_cap, gram=True, lower_only=True,
                         tape=ctx.tape)
        d, alpha, wd, L = chol.chol_solve_strips(K, (xs * mask).expand(P, N))
        ctx.save_for_backward(params_t, alpha, wd, L, node_type, ts, mask)
        ctx.depth_cap = depth_cap
        ctx.part_batch = part_batch
        ctx.intape = INTAPE_LINV
        return gp_math.mvn_logpdf_from_factor(d, alpha, mask)

    @staticmethod
    def backward(ctx, g):
        params_t, alpha, wd, L, node_type, ts, mask = ctx.saved_tensors
        if ctx.intape:
            kmat, beta, _ = kinv.linv_beta(L, alpha, wd)
            bwd = cov_tape_bwd_linv
        else:
            kmat, beta, _ = kinv.kinv_beta_strips(alpha, wd, L)
            bwd = cov_tape_bwd
        pbar, nbar = bwd(node_type, params_t, ts, mask, kmat, beta,
                         g.contiguous(), ctx.depth_cap,
                         part_batch=ctx.part_batch, tape=ctx.tape)
        return pbar, nbar, None, None, None, None, None, None
