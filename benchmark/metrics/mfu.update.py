"""mfu.update: A stream update's likelihood work at the chip's peaks, as a
share of the profiled updates' wall time."""

from benchmark.metrics.common import mfu


def read(trace):
    return mfu(trace, "stream")
