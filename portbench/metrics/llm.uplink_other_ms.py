"""llm.uplink_other_ms: the LLM uplink outside K0 (the wire casts, the
flatten, the keys, the padding and the unflatten), the span ``uplink``
less its ``kernel`` (``obs/spans.py``), mean milliseconds a step over the
window's steps. A program whose steps have no ``uplink`` span gives
nothing."""


def read(rec):
    steps = rec.get("steps")
    if not steps or any("uplink" not in s["spans"] for s in steps):
        return None
    return 1e3 * sum(s["spans"]["uplink"] - s["spans"].get("kernel", 0.0)
                     for s in steps) / len(steps)
