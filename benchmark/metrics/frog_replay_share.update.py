"""frog_replay_share.update: Percent of the profiled updates' HMC
leapfrogs (hmc.leapfrog under hmc.params_trajectory or
hmc.noise_trajectory) that replayed a CUDA graph (hold an hmc.replay
span)."""

from benchmark.metrics.replays import replay_share


def read(trace):
    return replay_share(trace, "stream")
