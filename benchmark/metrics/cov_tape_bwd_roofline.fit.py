"""cov_tape_bwd_roofline.fit: Kernel 5 (cov_tape_bwd_kernel,
reduce_tiles_kernel; ops.cov_vjp) share of its roofline in a fit."""

from benchmark.metrics.common import roofline


def read(trace):
    return roofline(trace, "cov_tape_bwd", "fit")
