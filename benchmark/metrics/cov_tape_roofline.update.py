"""cov_tape_roofline.update: Kernel 1 (cov_tape_kernel, ops.cov) share of
its roofline in a stream update."""

from benchmark.metrics.common import roofline


def read(trace):
    return roofline(trace, "cov_tape", "stream")
