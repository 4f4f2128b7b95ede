"""llm.moe_ms: the MoE FFN of an MLA moe config (``models/moe.py::
moe_ffn_held``: norm, router, dispatch, the held experts, the shared
expert, residual), forward, checkpoint recomputation and backward: the
span ``moe`` (``obs/spans.py``), mean milliseconds a step over the
window's steps. A program without the span gives nothing."""


def read(rec):
    steps = rec.get("steps")
    if not steps or any("moe" not in s["spans"] for s in steps):
        return None
    return 1e3 * sum(s["spans"]["moe"] for s in steps) / len(steps)
