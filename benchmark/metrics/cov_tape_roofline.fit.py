"""cov_tape_roofline.fit: Kernel 1 (cov_tape_kernel, ops.cov) share of its
roofline in a fit."""

from benchmark.metrics.common import roofline


def read(trace):
    return roofline(trace, "cov_tape", "fit")
