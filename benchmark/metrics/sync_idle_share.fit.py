"""sync_idle_share.fit: Percent of the profiled fit's device idle time in gaps
during which a named sync site returned (needs the device events in the
trace)."""

from benchmark.spans import sync_idle_share


def read(trace):
    return sync_idle_share(trace, "fit")
