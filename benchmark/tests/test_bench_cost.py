"""Operation and byte counts against counts made by hand."""

import math

import pytest
import torch

from benchmark import cost

F64 = torch.float64


def heap(*codes):
    """A depth-3 heap (7 slots) with the given codes in slot order."""
    nt = torch.zeros((1, 7), dtype=torch.int64)
    nt[0, :len(codes)] = torch.tensor(codes)
    return nt


FWD = cost.tape_table(cost.FWD_COST, "cpu", F64)
BWD = cost.tape_table(cost.BWD_COST, "cpu", F64)

# (code, forward flops, forward special functions) read off the formulas:
# Linear b + c (t1 - a)(t2 - a): 4 flops; SE b exp(-d^2 / (2 a^2)): 5 and
# one exp; GE c exp(-(|d| / a)^g): 4 and exp, log, exp; Periodic
# c exp(-2 sin^2(pi |d| / p) / l^2): 6 and sin, exp; Constant: a load.
LEAVES = [(1, 0, 0), (2, 4, 0), (3, 5, 1), (4, 4, 3), (5, 6, 2), (9, 1, 0)]


@pytest.mark.parametrize("code, flops, sfu", LEAVES)
def test_one_leaf_tape(code, flops, sfu):
    got = cost.tape_costs(heap(code), FWD)[0].tolist()
    assert got == [flops, sfu]


@pytest.mark.parametrize("op, flops, sfu", [(6, 1, 0), (7, 1, 0),
                                            (8, 10, 4)])
def test_operator_tapes_add_their_children(op, flops, sfu):
    # op(SE, Periodic): the operator's own cost plus both leaves'.
    got = cost.tape_costs(heap(op, 3, 5), FWD)[0].tolist()
    assert got == [flops + 5 + 6, sfu + 1 + 2]


def test_backward_tape_of_each_code():
    for code, (f, s) in cost.BWD_COST.items():
        nt = heap(code) if code not in (6, 7, 8) else heap(code, 2, 2)
        extra = (2 * 10, 0) if code in (6, 7, 8) else (0, 0)
        got = cost.tape_costs(nt, BWD)[0].tolist()
        assert got == [f + extra[0], s + extra[1]]


def test_cov_launch_counts_the_active_lower_triangle():
    nt = torch.cat([heap(3), heap(6, 2, 5)])       # SE; Plus(Linear, Per)
    m = torch.tensor([1.0] * 5 + [0.0] * 3)
    flops, sfu, nbytes = cost.cov_launch(nt, m, m, True, True, FWD)
    low = 5 * 6 / 2
    assert float(flops) == (5 + 1 + 4 + 6) * low
    assert float(sfu) == (1 + 2) * low
    assert nbytes == 4 * 2 * 8 * 8
    flops, _, nbytes = cost.cov_launch(nt, m[:4], m, False, False, FWD)
    assert float(flops) == 16 * 4 * 5 and nbytes == 4 * 2 * 4 * 8


def test_bwd_launch():
    nt = heap(3)
    m = torch.tensor([1.0] * 4 + [0.0] * 4)
    flops, sfu, nbytes = cost.bwd_launch(nt, m, FWD, BWD)
    low = 10
    assert float(flops) == (5 + 8 + cost.COTANGENT_FLOPS) * low
    assert float(sfu) == 1 * low
    assert float(nbytes) == 4 * (low + 4)


def test_dense_counts():
    assert cost.panel_launch(2, 128) == (2 * 2 * 128 ** 3 / 3, 2 * 256,
                                         3 * 2 * 128 * 128 * 4)
    tc, nbytes = cost.kinv_launch(1, 256, 128, True)
    assert tc == 2 * 256 ** 3 / 3
    assert nbytes == 4 * (2 * 256 ** 2 + 256 * 128 + 3 * 256)
    tc, nbytes = cost.factor_launch(3, 64)
    assert tc == 3 * (64 ** 3 / 3 + 64 * 64) and nbytes == 4 * 3 * 64 * 65


def test_least_seconds_takes_the_slowest_pipe():
    assert math.isclose(cost.least_seconds(flops=67e12,
                                           nbytes=3.35e12 / 2), 1.0)
    assert math.isclose(cost.least_seconds(tc=495e12 / 3 * 2), 2.0)
    assert math.isclose(cost.least_seconds(nbytes=3.35e12 * 3, sfu=1.0),
                        3.0)
