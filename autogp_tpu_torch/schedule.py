"""SMC data-annealing schedules (reference: src/Schedule.jl)."""

from __future__ import annotations

import math
from typing import List


def linear_schedule(n: int, percent: float) -> List[int]:
    """Adds roughly n*percent new observations per step (Schedule.jl:24-39)."""
    assert 0 < n
    assert 0 < percent < 1
    step = int(round(percent * n))
    step = max(step, 1)
    checkpoints = list(range(step, n + 1, step))
    remaining = n - checkpoints[-1]
    assert 0 <= remaining < step
    if remaining == 0:
        return checkpoints
    if remaining < step / 2:
        checkpoints[-1] = n
        return checkpoints
    return checkpoints + [n]


def logarithmic_schedule(n: int, base: float, start: int = None) -> List[int]:
    """Schedule.jl:46-84. With `start`, step i adds start*base^i points;
    without, the total at step i is base^i."""
    assert 0 < n
    if start is not None:
        assert 1 <= base
        assert 0 < start <= n
        checkpoints = []
        total = 0
        i = 0
        while True:
            block = start * base ** i
            if n < total + block:
                break
            total += int(round(block))
            i += 1
            checkpoints.append(total)
        remaining = n - checkpoints[-1]
        assert 0 <= remaining
        if remaining == 0:
            return [int(c) for c in checkpoints]
        return [int(c) for c in checkpoints] + [n]
    assert 1 < base
    if n < base:
        return [n]
    checkpoints = [int(round(base ** i))
                   for i in range(1, int(math.floor(math.log(n, base))) + 1)]
    checkpoints.append(n)
    return checkpoints
