"""What the `forecast*_ms.update` readers share: host time of the
forecast (the `api.predict` unit after each update) and of its parts, from
the program's spans (`benchmark.spans`)."""

from benchmark.spans import _ready

UNIT = "api.predict"


def ms_per_update(trace, name):
    """Host ms per profiled update of the spans called `name` inside an
    `api.predict` unit (the unit itself included); None on another kind of
    cell or where no such unit was recorded."""
    rec = _ready(trace, "stream")
    if rec is None or UNIT not in rec.units:
        return None
    ns = sum(s[2] - s[1] for s in rec.spans
             if s[0] == name and s[4] >= 0 and rec.units[s[4]] == UNIT)
    return ns * 1e-6 / trace["units"]
