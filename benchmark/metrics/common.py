"""What the per-layer readers share. Each reader `metrics/<name>.py`
defines `read(trace)`: the metric's number, or None where the trace holds
nothing to read (another kind of cell, a wrapper a later change renamed,
launches the two passes did not agree on). A share is never given as 0
for want of a reading.

`trace` is what `run.traced` returns: "kind" ("fit" or "stream"),
"units", the profiled pass's "wall_s", "busy_s", "launches" and
"family_s" (device seconds of each kernel family), the recorded pass's
"timers" ({label: {"seconds", "calls"}}) and "least_s" (least seconds of
each family's launches on the chip, `cost.py`), and "family_ok" (the
recorded pass's launches of the family, CUDA graph replays included, are
the launches of its main kernel that the profiled pass counted).
"""

FAMILIES = ("cov_tape", "chol_panel", "kinv", "cov_tape_bwd")


def roofline(trace, family, kind):
    """Percent of the family's device time that its launches need at
    least: sum of least times over sum of measured times."""
    if trace["kind"] != kind or not trace["family_ok"].get(family):
        return None
    spent = trace["family_s"].get(family, 0.0)
    if spent <= 0:
        return None
    return 100.0 * trace["least_s"][family] / spent


def mean_ms(trace, label, kind):
    """Mean milliseconds per call of a layer's synchronising timer."""
    t = trace["timers"].get(label)
    if trace["kind"] != kind or not t or not t["calls"]:
        return None
    return 1e3 * t["seconds"] / t["calls"]


def launches_per_unit(trace, kind):
    if trace["kind"] != kind or not trace["launches"] or not trace["units"]:
        return None
    return trace["launches"] / trace["units"]


def mfu(trace, kind):
    """Percent of the profiled pass's wall time that the unit's
    likelihood work needs at least on the chip: covariance assembly,
    factorizations and solves, K^-1, the tape backward (each launch at its
    slowest pipe, `cost.py`)."""
    if trace["kind"] != kind or not trace.get("factor_ok"):
        return None
    ok = trace["family_ok"]
    if not ok.get("cov_tape"):
        return None
    parts = ["cov_tape", "factor"]
    for fam in ("kinv", "cov_tape_bwd"):
        if ok.get(fam):
            parts.append(fam)
        elif trace["least_s"].get(fam, 0.0) > 0:
            return None
    return 100.0 * sum(trace["least_s"][p] for p in parts) / trace["wall_s"]
