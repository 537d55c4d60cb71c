"""param_traj_ms.fit: Mean ms per parameter-HMC trajectory
(hmc.params_trajectory) under a synchronising timer, in a fit."""

from benchmark.metrics.common import mean_ms


def read(trace):
    return mean_ms(trace, "hmc.params_trajectory", "fit")
