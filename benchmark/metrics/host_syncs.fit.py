"""host_syncs.fit: Named and unnamed host syncs per fit in the profiled pass
(the program's trace.sync sites and the synchronizing operations outside
them)."""

from benchmark.spans import syncs_per_unit


def read(trace):
    return syncs_per_unit(trace, "fit")
