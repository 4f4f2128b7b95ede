"""llm.grad_ms: the dense model (``steps.value_and_grad`` over
``models/transformer.py``), forward and backward: the span ``grad``
(``obs/spans.py``), mean milliseconds a step over the window's steps."""


def read(rec):
    steps = rec.get("steps")
    if not steps:
        return None
    return 1e3 * sum(s["spans"].get("grad", 0.0) for s in steps) / len(steps)
