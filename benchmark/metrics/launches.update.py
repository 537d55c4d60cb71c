"""launches.update: Device kernels per stream update, counted by
torch.profiler."""

from benchmark.metrics.common import launches_per_unit


def read(trace):
    return launches_per_unit(trace, "stream")
