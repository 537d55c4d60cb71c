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
`cov_tape` also takes float64 CUDA tensors, for the grams float32 cannot
hold (decompose's fragment models): they launch kernel 1's float64 entry
(csrc/cov_tape_f64.cu), with the same contract. `launches`,
`f64_launches` and `slot_launches` count the launches of kernel 1, its
float64 entry and kernel 6, and nothing else.

Depth. The kernels take a heap of any depth cap: each is sized by the
batch's tapes (the active slots in post-order), not by the heap's
M = 2^D - 1 slots. Its shared memory holds the batch's longest tape and
its value stack is picked by the batch's tallest one (`Tape.max_len`,
`Tape.max_height`; `tape_maxima`). For a heap of up to SMALL_HEAP slots
both are bounded by the heap itself (a tape of at most 31 positions, a
stack of at most 5) and nothing is read back; above, the wrapper reads
the batch's maxima from the device once (one sync), and a caller that
runs the forward and the backward on one tape (`LmlTapeFused`,
`cov_matrix_diff`) passes it on, so the backward reads nothing. What
bounds a kernel is the longest tape one block can stage, TAPE_LIMITS by
entry: a tape longer than that raises here with the number, and nothing
is launched. Every heap of up to 255 slots fits every entry.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from autogp_tpu_torch import backend
from autogp_tpu_torch import config as C
from autogp_tpu_torch import gp_math

# A heap of up to this many slots (depth cap 5) bounds its own tapes.
SMALL_HEAP = 31
# Shared memory a block can take on the H100 (csrc/cov_formulas.cuh
# kSmemPerBlock).
SMEM_PER_BLOCK = 232448
# The longest tape one block stages, in positions, by kernel entry: kernel
# 1 stages 16 bytes a position (its type and three parameters); kernel 6
# the same and a 2 KB chunk table; kernel 1's float64 entry 28 bytes (type
# and three doubles); kernels 5 and 5b (and 7, which runs 5b) need 12 len
# + 8 terms <= 48 KB for one thread, terms <= 2 len + 2, 5c the same in
# 46 KB less its 20 KB of staging (csrc/cov_tape_bwd.cu kTapeLimit,
# kTapeLimitLinv).
TAPE_LIMITS = {
    "cov_tape": SMEM_PER_BLOCK // 16,                  # 14528
    "cov_slot": (SMEM_PER_BLOCK - 4 * 513) // 16,      # 14399
    "cov_tape_f64": SMEM_PER_BLOCK // 28,              # 8301
    "cov_tape_bwd": 1754,
    "cov_tape_bwd_linv": 1662,
    "cov_tape_bwd_unfused": 1754,
    "cov_slot_bwd": 1754,
}

# Gradient terms of a tape instruction, by node type (config.py codes 1-9):
# the acc(base + k) calls of csrc/cov_formulas.cuh's ref_leaf_grad /
# ref_op_adjoint.
TERMS_OF_TYPE = (0, 1, 3, 2, 3, 3, 0, 0, 1, 1)

launches = 0
f64_launches = 0
slot_launches = 0


class Tape(NamedTuple):
    """A batch's post-order tapes (`build_tape`) and the maxima that size
    the kernels (`tape_maxima`): ints on the host."""
    slot: torch.Tensor
    type: torch.Tensor
    lpos: torch.Tensor
    rpos: torch.Tensor
    length: torch.Tensor
    height: torch.Tensor
    max_len: int
    max_height: int
    max_terms: int


def tape_terms(tape_type, length):
    """Gradient terms of each tape [P], the noise's included."""
    per = torch.as_tensor(TERMS_OF_TYPE, device=tape_type.device)
    valid = (torch.arange(tape_type.shape[1], device=tape_type.device)[None]
             < length[:, None])
    return (per[tape_type.long()] * valid).sum(1) + 1


def _read_maxima(length, height, terms, depth_cap: int):
    """(max_len, max_height, max_terms) of a batch: the heap's own bounds
    for a heap of up to SMALL_HEAP slots, else the batch's maxima read from
    the device (one sync). max_len is at least 1."""
    M = (1 << depth_cap) - 1
    if M <= SMALL_HEAP:
        return M, depth_cap, 3 * M + 1
    n, h, t = torch.stack([length.max(), height.max(),
                           terms.max()]).tolist()
    return max(int(n), 1), int(h), int(t)


def tape_maxima(tape_type, length, height, depth_cap: int):
    """(max_len, max_height, max_terms) of `build_tape`'s tapes: the
    longest tape, the tallest stack and the most gradient terms of the
    batch, or the heap's bounds of them for a heap of up to SMALL_HEAP
    slots (no sync)."""
    M = (1 << depth_cap) - 1
    terms = None if M <= SMALL_HEAP else tape_terms(tape_type, length)
    return _read_maxima(length, height, terms, depth_cap)


def heap_maxima(node_type, depth_cap: int):
    """`tape_maxima` from the heaps [P, M] themselves, for the per-slot
    kernels (6, 7), whose wrappers build no tape: the active slots in
    post-order are the tape, so the same three numbers."""
    M = (1 << depth_cap) - 1
    if M <= SMALL_HEAP:
        return _read_maxima(None, None, None, depth_cap)
    nt = node_type.to(torch.int64)[:, _postorder(depth_cap, node_type.device)]
    act = nt > 0
    length = act.sum(1)
    per = torch.as_tensor(TERMS_OF_TYPE, device=nt.device)
    return _read_maxima(length, _stack_height(nt, act), per[nt].sum(1) + 1,
                        depth_cap)


def _stack_height(types, valid):
    """Per tape [P]: the most values its post-order evaluation holds at
    once, a running sum of +1 for a leaf and -1 for an operator."""
    op = (types >= C.PLUS) & (types <= C.CHANGEPOINT)
    step = torch.where(valid, torch.where(op, -1, 1), 0)
    return torch.cumsum(step, dim=1).amax(1).clamp_min(0)


def check_tape(name: str, max_len: int, max_terms: int | None = None):
    """Raise, before any launch, if a tape of the batch is longer than
    entry `name` can stage (TAPE_LIMITS), or (kernel 5's entries) its
    longest tape and most terms would not fit one thread's budget."""
    limit = TAPE_LIMITS[name]
    if max_len > limit:
        raise ValueError(f"{name}: a tape of {max_len} positions is longer "
                         f"than the {limit} one block can stage")
    if max_terms is not None:
        budget = (46 * 1024 if name == "cov_tape_bwd_linv" else 48 * 1024)
        if 12 * max_len + 8 * max_terms > budget:
            raise ValueError(f"{name}: {max_len} positions and {max_terms} "
                             f"gradient terms exceed one thread's "
                             f"{budget} bytes")


@functools.lru_cache(maxsize=None)
def _postorder(depth_cap: int, device, dtype=torch.int64) -> torch.Tensor:
    """The static post-order slot sequence, kept on `device`."""
    return torch.as_tensor(np.asarray(gp_math.postorder(depth_cap)),
                           dtype=dtype, device=device)


def build_tape(node_type, depth_cap: int):
    """Post-order instruction tapes of the active slots, batched.

    node_type [P, M]. Returns (tape_slot, tape_type, tape_lpos, tape_rpos),
    each [P, M] int32, length [P] int32 and height [P] int32; entries at
    or past the length are no-ops (type 0). lpos/rpos are the tape
    positions of a slot's children (-1 for leaves). The first five are
    cov_pallas.build_tape's values; the height is the most values the
    tape's evaluation holds on its stack at once (a tree of D levels: at
    most D). All on node_type's device, with no sync."""
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
    height = _stack_height(tape_type, valid)
    i32 = torch.int32
    return (tape_slot.to(i32), tape_type.to(i32), tape_lpos.to(i32),
            tape_rpos.to(i32), length.to(i32), height.to(i32))


def tape(node_type, depth_cap: int) -> Tape:
    """`build_tape` and the batch's maxima (`tape_maxima`), as a Tape."""
    t = build_tape(node_type, depth_cap)
    return Tape(*t, *tape_maxima(t[1], t[4], t[5], depth_cap))


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
             depth_cap: int, gram: bool, lower_only: bool = False, *,
             tape: Tape | None = None):
    """Covariance blocks [P, N1, N2] of the encoded trees on t_row x t_col.

    node_type [P, M]; params_t [P, M, 3] transformed; noise [P]; t_row,
    m_row [N1]; t_col, m_col [N2]. With `gram` (N1 == N2, one time grid),
    noise is added on the diagonal and masked rows/columns become the
    identity; otherwise masked entries are 0. `lower_only` (gram only)
    writes zeros above the diagonal, for the lower-reading Cholesky.

    Any depth cap; on the card a tape longer than TAPE_LIMITS' entry
    raises. `tape`: the batch's Tape (`tape()`) if the caller has it, or
    None to build it here. Float64 CUDA tensors launch the float64 entry
    (every float input float64), float32 ones the float32 kernel."""
    if lower_only and not gram:
        raise ValueError("lower_only applies to a gram block only")
    if gram and t_row.shape[0] != t_col.shape[0]:
        raise ValueError("a gram block is square")
    if not backend.on_cuda(params_t):
        return cov_tape_plain(node_type, params_t, noise, t_row, t_col,
                              m_row, m_col, depth_cap, gram, lower_only)
    return _launch(node_type, params_t, noise, t_row, t_col, m_row, m_col,
                   depth_cap, gram, lower_only, tape)


def _launch(node_type, params_t, noise, t_row, t_col, m_row, m_col,
            depth_cap, gram, lower_only, tp: Tape | None = None,
            min_height: int = 0):
    """One launch; `min_height` > the batch's height runs a taller stack
    instance (the same output bit for bit: tests)."""
    global launches, f64_launches
    from autogp_tpu_torch.ops import _build
    P, M = node_type.shape
    N1, N2 = t_row.shape[0], t_col.shape[0]
    if M != (1 << depth_cap) - 1:
        raise ValueError(f"heap of {M} slots does not match depth {depth_cap}")
    f64 = params_t.dtype == torch.float64
    name = "autogp_cov_tape_f64" if f64 else "autogp_cov_tape"
    if tp is None:
        tp = tape(node_type, depth_cap)
    check_tape(name[7:], tp.max_len)
    tslot, ttype, tlen = tp.slot, tp.type, tp.length
    ft = torch.float64 if f64 else torch.float32
    args = [("tape_slot", tslot, torch.int32, 2),
            ("tape_type", ttype, torch.int32, 2),
            ("tape_len", tlen, torch.int32, 1),
            ("params", params_t, ft, 3), ("noise", noise, ft, 1),
            ("t_row", t_row, ft, 1), ("t_col", t_col, ft, 1),
            ("mask_row", m_row, ft, 1), ("mask_col", m_col, ft, 1)]
    for arg, t, dt, nd in args:
        backend.check_kernel_input(arg, t, dt, nd)
    if params_t.shape != (P, M, 3) or noise.shape != (P,):
        raise ValueError("params_t must be [P, M, 3] and noise [P]")
    if m_row.shape != (N1,) or m_col.shape != (N2,):
        raise ValueError("masks must match their time grids")
    out = torch.empty((P, N1, N2), dtype=ft, device=params_t.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(params_t.device).cuda_stream
    maxima = ((tp.max_len,) if f64
              else (tp.max_len, max(tp.max_height, min_height)))
    err = getattr(lib, name)(
        tslot.data_ptr(), ttype.data_ptr(), tlen.data_ptr(),
        params_t.data_ptr(), noise.data_ptr(), t_row.data_ptr(),
        t_col.data_ptr(), m_row.data_ptr(), m_col.data_ptr(),
        out.data_ptr(), P, M, N1, N2, int(gram), int(lower_only), *maxima,
        stream)
    _build.check(name, err)
    if f64:
        f64_launches += 1
    else:
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
               masked: bool = True, *, maxima=None):
    """Grams [P, N, N] = eval_cov(tree)(ts, ts) + noise I of the encoded
    trees, from the heaps themselves (`cov_matrix_batched`,
    cov_pallas.py:363): one launch, no tape built here. With `masked`,
    rows and columns with mask 0 become the identity. node_type [P, M];
    params_t [P, M, 3]; noise [P]; ts, mask [N], any N. `maxima`: the
    batch's `heap_maxima` if the caller has them (None: read here)."""
    if not backend.on_cuda(params_t):
        return cov_matrix_plain(node_type, params_t, noise, ts, mask,
                                depth_cap, masked)
    return _launch_slot(node_type, params_t, noise, ts, mask, depth_cap,
                        masked, maxima)


def slot_inputs(node_type, depth_cap: int):
    """(node types [P, M] int32, post-order [M] int32) as the per-slot
    kernels take them."""
    P, M = node_type.shape
    if M != (1 << depth_cap) - 1:
        raise ValueError(f"heap of {M} slots does not match depth {depth_cap}")
    return (node_type.to(torch.int32).contiguous(),
            _postorder(depth_cap, node_type.device, torch.int32))


def _launch_slot(node_type, params_t, noise, ts, mask, depth_cap, masked,
                 maxima=None, min_height: int = 0):
    global slot_launches
    from autogp_tpu_torch.ops import _build
    P, M = node_type.shape
    N = ts.shape[0]
    nt32, order = slot_inputs(node_type, depth_cap)
    if maxima is None:
        maxima = heap_maxima(node_type, depth_cap)
    max_len, max_height, _ = maxima
    check_tape("cov_slot", max_len)
    f32 = torch.float32
    for arg, t, nd in (("params", params_t, 3), ("noise", noise, 1),
                        ("ts", ts, 1), ("mask", mask, 1)):
        backend.check_kernel_input(arg, t, f32, nd)
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
        P, M, N, int(masked), max_len, max(max_height, min_height), stream)
    _build.check("autogp_cov_slot", err)
    slot_launches += 1
    return out
