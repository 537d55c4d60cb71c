"""chol_panel_roofline.update: Kernel 2 (chol_panel_kernel, ops.chol) share
of its roofline in a stream update."""

from benchmark.metrics.common import roofline


def read(trace):
    return roofline(trace, "chol_panel", "stream")
