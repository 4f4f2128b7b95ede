"""llm.apply_ms: the optimizer (``optim/sgd.py``): the span ``apply``
(``obs/spans.py``), mean milliseconds a step over the window's steps."""


def read(rec):
    steps = rec.get("steps")
    if not steps:
        return None
    return 1e3 * sum(s["spans"].get("apply", 0.0) for s in steps) / len(steps)
