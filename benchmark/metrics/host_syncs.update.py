"""host_syncs.update: Named and unnamed host syncs per update in the profiled
pass."""

from benchmark.spans import syncs_per_unit


def read(trace):
    return syncs_per_unit(trace, "stream")
