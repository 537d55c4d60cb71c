"""mh_propose_host_ms.update: Host ms per MH step spent building the two
proposals (moves.propose_sr + moves.propose_da) in the profiled updates."""

from benchmark.spans import propose_ms


def read(trace):
    return propose_ms(trace, "stream")
