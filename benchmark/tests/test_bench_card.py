"""On the card: a cell cut small runs end to end, traced and not, and
comes out correct. Skips without a card."""

import pytest

from benchmark import run
from benchmark.tests.small import small


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["config4.fit_p512_nopredict",
                                  "config5.stream_w512_nopredict"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_small_cell_runs_on_the_card(cuda_device, cell, trace):
    out, lines = run.run_cell(cell, 2 ** 31 + 5, 1.0, trace, cuda_device,
                              override=small(n_particles=64, n_points=256,
                                             window=256))
    assert out["correct"] is True, lines
    if trace:
        assert out["busy_s"] > 0 and out["metrics"]
