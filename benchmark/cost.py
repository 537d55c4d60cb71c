"""The yardstick of the kernels: operations, special-function calls and
bytes each launch needs, and the least time the chip takes for them.

The per-element costs of a tree's tape and the byte counts follow
chip_smoke.py's `FWD_COST`, `BWD_COST`, `tape_cost` and its bounds; the
rates are read the same whatever kernel implements a count, so a kernel
that moves work from one pipe to another cannot read above 100%:

- products a float32-accurate kernel may put on the tensor cores (the
  Cholesky's and the triangular inverse's N^3 / 3, K^-1 = X^T X) at
  3xTF32's 495 / 3 TFLOP/s;
- other FP32 arithmetic at 67 TFLOP/s;
- special functions (exp, log, sin, reciprocal) at 16 a clock per SM;
- bytes at 3.35 TB/s, each input read once and each output written once.

A launch's least time is the largest of its pipes' times (the pipes run
side by side). Costs are counted for what the inputs need: a tree's tape
runs on the active elements only (the masks), the panel and K^-1 kernels
on the whole padded block they are handed.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet; dense rates at the 700 W limit).
PEAK_F32 = 67e12
PEAK_TC_F32 = 495e12 / 3      # 3xTF32: three TF32 products per FP32 one
PEAK_BYTES = 3.35e12
PEAK_SFU = 16 * 132 * 1.98e9  # 16 results / clock / SM, 132 SMs, 1.98 GHz

# (FP32 operations, special-function calls) per matrix element for one
# tape instruction of each node code 1..9: forward (covariance assembly)
# and backward (its vector-Jacobian product).
FWD_COST = {1: (0, 0), 2: (4, 0), 3: (5, 1), 4: (4, 3), 5: (6, 2),
            6: (1, 0), 7: (1, 0), 8: (10, 4), 9: (1, 0)}
BWD_COST = {1: (1, 0), 2: (10, 0), 3: (8, 0), 4: (12, 2), 5: (16, 2),
            6: (0, 0), 7: (2, 0), 8: (22, 4), 9: (1, 0)}
COTANGENT_FLOPS = 6   # 0.5 g (beta_i beta_j - K^-1_ij) m_i m_j


def least_seconds(flops=0.0, sfu=0.0, nbytes=0.0, tc=0.0):
    """The least time of the work on the chip: the slowest of its pipes
    (FP32, tensor cores, special functions, memory)."""
    return max(flops / PEAK_F32, tc / PEAK_TC_F32, sfu / PEAK_SFU,
               nbytes / PEAK_BYTES)


def tape_table(table, device, dtype):
    """[10, 2] per-code (flops, sfu) of `table`, code 0 costing nothing."""
    import torch
    rows = [(0, 0)] + [table[c] for c in range(1, 10)]
    return torch.tensor(rows, dtype=dtype, device=device)


def tape_costs(node_type, table):
    """[P, 2] (flops, sfu) per element of running each particle's tape
    once: the sum over its active slots (a tape holds each active slot
    once). `table` is `tape_table(...)` on node_type's device."""
    return table[node_type].sum(dim=1)


def cov_launch(node_type, m_row, m_col, gram, lower_only, table):
    """(flops, sfu, bytes) of one covariance-assembly launch, as device
    scalars: the tape on every active element (the lower triangle of a
    lower-only gram), and every element of the [P, N1, N2] float32
    output written once."""
    P = node_type.shape[0]
    per = tape_costs(node_type, table).sum(dim=0)          # [2]
    n1, n2 = m_row.sum(), m_col.sum()
    elems = n1 * (n1 + 1) / 2 if (gram and lower_only) else n1 * n2
    nbytes = 4.0 * P * m_row.shape[0] * m_col.shape[0]
    return per[0] * elems, per[1] * elems, nbytes


def bwd_launch(node_type, mask, fwd_table, bwd_table):
    """(flops, sfu, bytes) of one fused tape-backward launch: forward and
    backward tape plus the cotangent on every active lower element; the
    active lower K^-1 and the active beta read once."""
    P = node_type.shape[0]
    f = tape_costs(node_type, fwd_table) + tape_costs(node_type, bwd_table)
    per = f.sum(dim=0)
    n = mask.sum()
    low = n * (n + 1) / 2
    return ((per[0] + COTANGENT_FLOPS * P) * low, per[1] * low,
            4.0 * P * (low + n))


def panel_launch(P, B):
    """(tc flops, sfu, bytes) of one panel launch on [P, B, B]: Cholesky
    and triangular inverse, B^3 / 3 each; B square roots and B
    reciprocals; read A, write L and L^-1."""
    return P * 2 * B ** 3 / 3, P * 2 * B, 3 * P * B * B * 4


def kinv_launch(P, N, B, with_kinv):
    """(tc flops, bytes) of one K^-1 launch on [P, N, N] with panels of B:
    the triangular inverse (N^3 / 3), and with K^-1 its product X^T X
    (N^3 / 3); read L, Wd and alpha, write beta and the norm, and K^-1."""
    NN = P * N * N
    if with_kinv:
        return 2 * P * N ** 3 / 3, 4 * (2 * NN + P * N * B + 3 * P * N)
    return P * N ** 3 / 3, 4 * (NN + P * N * B + 2 * P * N)


def factor_launch(P, N):
    """(tc flops, bytes) of one whole factorization and solve of a
    [P, N, N] gram: N^3 / 3 + N^2; read the lower triangle, write L's."""
    return P * (N ** 3 / 3 + N * N), 4 * P * N * (N + 1)
