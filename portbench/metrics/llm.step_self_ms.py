"""llm.step_self_ms: the step loop's own time, a step (host clock, to its
loss read) less its spans ``grad``, ``uplink`` and ``apply``, mean
milliseconds a step over the window's steps. A program whose steps have
no ``uplink`` span gives nothing."""

PARTS = ("grad", "uplink", "apply")


def read(rec):
    steps = rec.get("steps")
    if not steps or any("uplink" not in s["spans"] for s in steps):
        return None
    return 1e3 * sum(s["dur_s"] - sum(s["spans"].get(k, 0.0) for k in PARTS)
                     for s in steps) / len(steps)
