"""forecast_frame_ms.update: Host ms per update of the forecast's table on
the host (the predict.frame span: normal quantiles, per-particle frames,
their concatenation) in the profiled updates."""

from benchmark.metrics.forecast import ms_per_update


def read(trace):
    return ms_per_update(trace, "predict.frame")
