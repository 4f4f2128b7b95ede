"""llm.mla_ms: MLA attention (``models/mla.py`` in every layer of an MLA
moe config: its norm, projections, YaRN, fused attention and residual),
forward, checkpoint recomputation and backward: the span ``mla``
(``obs/spans.py``), mean milliseconds a step over the window's steps. A
program without the span gives nothing."""


def read(rec):
    steps = rec.get("steps")
    if not steps or any("mla" not in s["spans"] for s in steps):
        return None
    return 1e3 * sum(s["spans"]["mla"] for s in steps) / len(steps)
