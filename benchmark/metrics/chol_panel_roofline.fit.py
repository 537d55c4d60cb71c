"""chol_panel_roofline.fit: Kernel 2 (chol_panel_kernel, ops.chol) share of
its roofline in a fit."""

from benchmark.metrics.common import roofline


def read(trace):
    return roofline(trace, "chol_panel", "fit")
