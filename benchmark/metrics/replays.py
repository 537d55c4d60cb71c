"""What the `frog_replay_share.*` readers share: the share of HMC
leapfrogs that replayed a CUDA graph, from the program's spans
(`benchmark.spans`)."""

from benchmark.spans import _ready

TRAJECTORIES = ("hmc.params_trajectory", "hmc.noise_trajectory")


def replay_share(trace, kind):
    """Percent of the profiled pass's leapfrogs (hmc.leapfrog directly
    under a parameter or noise trajectory) that hold an hmc.replay span:
    0 where every leapfrog ran eagerly, None without a leapfrog."""
    rec = _ready(trace, kind)
    if rec is None:
        return None
    spans = rec.spans
    frogs = {i for i, s in enumerate(spans)
             if s[0] == "hmc.leapfrog" and s[3] >= 0
             and spans[s[3]][0] in TRAJECTORIES}
    if not frogs:
        return None
    replayed = {s[3] for s in spans if s[0] == "hmc.replay" and s[3] in frogs}
    return 100.0 * len(replayed) / len(frogs)
