"""llm.k0_ms: the LLM uplink's kernel (``core/aggregation.py::
approx_allreduce`` -> K0): the span ``kernel``
(``obs/spans.py``), mean milliseconds a step over the window's steps."""


def read(rec):
    steps = rec.get("steps")
    if not steps:
        return None
    return 1e3 * sum(s["spans"].get("kernel", 0.0) for s in steps) / len(steps)
