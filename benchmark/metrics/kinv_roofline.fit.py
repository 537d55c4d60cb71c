"""kinv_roofline.fit: Kernels 3-4 (linv_kernel, kinv_lower_kernel,
fro_sum_kernel; ops.kinv) share of their roofline in a fit."""

from benchmark.metrics.common import roofline


def read(trace):
    return roofline(trace, "kinv", "fit")
