"""Kernels 1 and 6: covariance assembly, tape-driven (csrc/cov_tape.cu) and
per-slot (csrc/cov_slot.cu, which compacts each heap into its tape on the
device and runs kernel 1's tile body: bitwise kernel 1's full gram).

Port of autogp_tpu/ops/cov_pallas.py: `build_tape` (:147-176) as a torch
op; `cov_tape`, the wrapper of the CUDA kernel that replaces the Pallas
`_cov_kernel_tape_1p` (:252-296, launched by `cov_matrix_tape`, :299);
`cov_matrix`, the wrapper of the one that replaces `_cov_kernel_1p`
(:386-415, launched by `cov_matrix` / `cov_matrix_batched`, :363-487); and
their plain PyTorch versions built on gp_math.eval_cov.

Both dispatch on the device of their inputs only: CUDA tensors launch the
kernel (float32, or it raises), CPU tensors take the plain version.
`launches` and `slot_launches` count the launches of kernels 1 and 6 and
nothing else.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from autogp_tpu_torch import backend
from autogp_tpu_torch import gp_math

# Value-stack bound compiled into the kernel (csrc/cov_tape.cu kMaxDepth).
MAX_DEPTH = 8

launches = 0
slot_launches = 0


@functools.lru_cache(maxsize=None)
def _postorder(depth_cap: int, device, dtype=torch.int64) -> torch.Tensor:
    """The static post-order slot sequence, kept on `device`."""
    return torch.as_tensor(np.asarray(gp_math.postorder(depth_cap)),
                           dtype=dtype, device=device)


def build_tape(node_type, depth_cap: int):
    """Post-order instruction tapes of the active slots, batched.

    node_type [P, M]. Returns (tape_slot, tape_type, tape_lpos, tape_rpos),
    each [P, M] int32, and length [P] int32; entries at or past the length
    are no-ops (type 0). lpos/rpos are the tape positions of a slot's
    children (-1 for leaves). Same values as cov_pallas.build_tape."""
    P, M = node_type.shape
    dev = node_type.device
    po = _postorder(depth_cap, dev)
    nt = node_type.to(torch.int64)
    act = nt[:, po] > 0                                       # [P, M]
    pos = torch.cumsum(act.to(torch.int64), dim=1) - 1
    length = act.sum(dim=1)
    dest = torch.where(act, pos, torch.full_like(pos, M))
    tape_slot = torch.zeros((P, M + 1), dtype=torch.int64, device=dev)
    tape_slot.scatter_(1, dest, po.expand(P, M))
    tape_slot = tape_slot[:, :M]
    ar = torch.arange(M, device=dev)
    valid = ar[None, :] < length[:, None]
    tape_type = torch.where(valid, torch.gather(nt, 1, tape_slot), 0)
    pos_of_slot = torch.zeros((P, M), dtype=torch.int64, device=dev)
    pos_of_slot.scatter_(1, po.expand(P, M), pos)
    lslot = torch.clamp(2 * ar + 1, max=M - 1)
    rslot = torch.clamp(2 * ar + 2, max=M - 1)
    has_child = (2 * ar + 1 < M)[None, :]
    lpos_by_slot = torch.where(has_child, pos_of_slot[:, lslot], -1)
    rpos_by_slot = torch.where(has_child, pos_of_slot[:, rslot], -1)
    tape_lpos = torch.where(valid, torch.gather(lpos_by_slot, 1, tape_slot),
                            -1)
    tape_rpos = torch.where(valid, torch.gather(rpos_by_slot, 1, tape_slot),
                            -1)
    i32 = torch.int32
    return (tape_slot.to(i32), tape_type.to(i32), tape_lpos.to(i32),
            tape_rpos.to(i32), length.to(i32))


def cov_tape_plain(node_type, params_t, noise, t_row, t_col, m_row, m_col,
                   depth_cap: int, gram: bool, lower_only: bool):
    """Plain PyTorch version of the kernel (same contract as `cov_tape`)."""
    K = gp_math.eval_cov(node_type, params_t, t_row, t_col, depth_cap)
    keep = (m_row[:, None] * m_col[None, :]) > 0
    if not gram:
        return torch.where(keep, K, torch.zeros((), dtype=K.dtype,
                                                device=K.device))
    eye = torch.eye(K.shape[-2], K.shape[-1], dtype=K.dtype,
                    device=K.device)
    K = torch.where(keep, K + noise[:, None, None] * eye, eye)
    return torch.tril(K) if lower_only else K


def cov_tape(node_type, params_t, noise, t_row, t_col, m_row, m_col,
             depth_cap: int, gram: bool, lower_only: bool = False):
    """Covariance blocks [P, N1, N2] of the encoded trees on t_row x t_col.

    node_type [P, M]; params_t [P, M, 3] transformed; noise [P]; t_row,
    m_row [N1]; t_col, m_col [N2]. With `gram` (N1 == N2, one time grid),
    noise is added on the diagonal and masked rows/columns become the
    identity; otherwise masked entries are 0. `lower_only` (gram only)
    writes zeros above the diagonal, for the lower-reading Cholesky.

    On the card a heap deeper than MAX_DEPTH raises; the plain version
    takes any depth, as the reference's evaluator does."""
    if lower_only and not gram:
        raise ValueError("lower_only applies to a gram block only")
    if gram and t_row.shape[0] != t_col.shape[0]:
        raise ValueError("a gram block is square")
    if not backend.on_cuda(params_t):
        return cov_tape_plain(node_type, params_t, noise, t_row, t_col,
                              m_row, m_col, depth_cap, gram, lower_only)
    if depth_cap > MAX_DEPTH:
        raise ValueError(f"depth_cap={depth_cap} exceeds the kernel's value "
                         f"stack bound {MAX_DEPTH}")
    return _launch(node_type, params_t, noise, t_row, t_col, m_row, m_col,
                   depth_cap, gram, lower_only)


def _launch(node_type, params_t, noise, t_row, t_col, m_row, m_col,
            depth_cap, gram, lower_only):
    global launches
    from autogp_tpu_torch.ops import _build
    P, M = node_type.shape
    N1, N2 = t_row.shape[0], t_col.shape[0]
    if M != (1 << depth_cap) - 1:
        raise ValueError(f"heap of {M} slots does not match depth {depth_cap}")
    tslot, ttype, _, _, tlen = build_tape(node_type, depth_cap)
    f32 = torch.float32
    args = [("tape_slot", tslot, torch.int32, 2),
            ("tape_type", ttype, torch.int32, 2),
            ("tape_len", tlen, torch.int32, 1),
            ("params", params_t, f32, 3), ("noise", noise, f32, 1),
            ("t_row", t_row, f32, 1), ("t_col", t_col, f32, 1),
            ("mask_row", m_row, f32, 1), ("mask_col", m_col, f32, 1)]
    for name, t, dt, nd in args:
        backend.check_kernel_input(name, t, dt, nd)
    if params_t.shape != (P, M, 3) or noise.shape != (P,):
        raise ValueError("params_t must be [P, M, 3] and noise [P]")
    if m_row.shape != (N1,) or m_col.shape != (N2,):
        raise ValueError("masks must match their time grids")
    out = torch.empty((P, N1, N2), dtype=f32, device=params_t.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(params_t.device).cuda_stream
    err = lib.autogp_cov_tape(
        tslot.data_ptr(), ttype.data_ptr(), tlen.data_ptr(),
        params_t.data_ptr(), noise.data_ptr(), t_row.data_ptr(),
        t_col.data_ptr(), m_row.data_ptr(), m_col.data_ptr(),
        out.data_ptr(), P, M, N1, N2, int(gram), int(lower_only), stream)
    _build.check("autogp_cov_tape", err)
    launches += 1
    return out


def cov_matrix_plain(node_type, params_t, noise, ts, mask, depth_cap: int,
                     masked: bool = True):
    """Plain PyTorch version of the per-slot kernel (same contract as
    `cov_matrix`)."""
    m = mask if masked else torch.ones_like(mask)
    return cov_tape_plain(node_type, params_t, noise, ts, ts, m, m,
                          depth_cap, gram=True, lower_only=False)


def cov_matrix(node_type, params_t, noise, ts, mask, depth_cap: int,
               masked: bool = True):
    """Grams [P, N, N] = eval_cov(tree)(ts, ts) + noise I of the encoded
    trees, from the heaps themselves (`cov_matrix_batched`,
    cov_pallas.py:363): one launch, no tape built here. With `masked`,
    rows and columns with mask 0 become the identity. node_type [P, M];
    params_t [P, M, 3]; noise [P]; ts, mask [N], any N."""
    if depth_cap > MAX_DEPTH:
        raise ValueError(f"depth_cap={depth_cap} exceeds the kernel's value "
                         f"stack bound {MAX_DEPTH}")
    if not backend.on_cuda(params_t):
        return cov_matrix_plain(node_type, params_t, noise, ts, mask,
                                depth_cap, masked)
    return _launch_slot(node_type, params_t, noise, ts, mask, depth_cap,
                        masked)


def slot_inputs(node_type, depth_cap: int):
    """(node types [P, M] int32, post-order [M] int32) as the per-slot
    kernels take them."""
    P, M = node_type.shape
    if M != (1 << depth_cap) - 1:
        raise ValueError(f"heap of {M} slots does not match depth {depth_cap}")
    return (node_type.to(torch.int32).contiguous(),
            _postorder(depth_cap, node_type.device, torch.int32))


def _launch_slot(node_type, params_t, noise, ts, mask, depth_cap, masked):
    global slot_launches
    from autogp_tpu_torch.ops import _build
    P, M = node_type.shape
    N = ts.shape[0]
    nt32, order = slot_inputs(node_type, depth_cap)
    f32 = torch.float32
    for name, t, nd in (("params", params_t, 3), ("noise", noise, 1),
                        ("ts", ts, 1), ("mask", mask, 1)):
        backend.check_kernel_input(name, t, f32, nd)
    if (params_t.shape != (P, M, 3) or noise.shape != (P,)
            or mask.shape != (N,)):
        raise ValueError("cov_matrix: params_t must be [P, M, 3], noise [P] "
                         "and mask [N]")
    out = torch.empty((P, N, N), dtype=f32, device=params_t.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(params_t.device).cuda_stream
    err = lib.autogp_cov_slot(
        nt32.data_ptr(), order.data_ptr(), params_t.data_ptr(),
        noise.data_ptr(), ts.data_ptr(), mask.data_ptr(), out.data_ptr(),
        P, M, N, int(masked), stream)
    _build.check("autogp_cov_slot", err)
    slot_launches += 1
    return out
