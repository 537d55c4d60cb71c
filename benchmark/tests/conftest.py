"""Settings of the benchmark's own tests (`pytest benchmark/tests`).

Tests that need the card carry the `gpu` marker and decide inside a
fixture whether there is one: on the CPU they skip with a reason."""

import os
import sys
from pathlib import Path

import pytest

# One thread a process: the tests run at tiny sizes, often several
# processes at once, and idle pools of spinning threads only slow them.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    import torch
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)
