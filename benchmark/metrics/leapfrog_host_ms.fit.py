"""leapfrog_host_ms.fit: Mean host ms of one leapfrog (hmc.leapfrog under
hmc.params_trajectory) in the profiled fit: the time to issue one gradient
evaluation, nothing synchronised."""

from benchmark.spans import leapfrog_ms


def read(trace):
    return leapfrog_ms(trace, "fit")
