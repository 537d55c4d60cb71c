"""forecast_ms.update: Host ms per update of the forecast, the api.predict
unit (float64 assembly, factor, solve, moments and the host's table), in
the profiled updates."""

from benchmark.metrics.forecast import UNIT, ms_per_update


def read(trace):
    return ms_per_update(trace, UNIT)
