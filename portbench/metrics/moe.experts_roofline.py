"""moe.experts_roofline: the held experts' GEMMs as a share of the card's
bf16 dense peak (989 TFLOP/s): their model FLOPs, ``6 * 3 * d_model *
moe_intermediate_size`` a computed token-expert pair (forward and
backward; ``portbench/core/mla_moe_flops.py``) times the counter
``moe_assignments_held`` summed over the layers, over the span
``experts`` (forward, recomputation and backward), summed over the
window's steps, in percent. A program without the span or the counter
gives nothing."""


def read(rec):
    from portbench.core.roofline import PEAK_BF16

    steps = rec.get("steps")
    per = rec.get("expert_flops_per_assignment")
    if (not steps or per is None
            or any("experts" not in s["spans"]
                   or "moe_assignments_held" not in s.get("counters", {})
                   for s in steps)):
        return None
    flops = per * sum(sum(s["counters"]["moe_assignments_held"])
                      for s in steps)
    seconds = sum(s["spans"]["experts"] for s in steps)
    return 100.0 * flops / (seconds * PEAK_BF16) if seconds > 0 else None
