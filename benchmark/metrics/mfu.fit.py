"""mfu.fit: A fit's likelihood work at the chip's peaks, as a share of the
profiled fit's wall time."""

from benchmark.metrics.common import mfu


def read(trace):
    return mfu(trace, "fit")
