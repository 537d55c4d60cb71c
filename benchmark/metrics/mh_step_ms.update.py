"""mh_step_ms.update: Mean ms per MH structure step
(moves.tree_rejuvenation_step) under a synchronising timer, in a stream
update."""

from benchmark.metrics.common import mean_ms


def read(trace):
    return mean_ms(trace, "moves.mh_step", "stream")
