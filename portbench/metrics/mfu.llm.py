"""mfu.llm: the whole step's share of the card's bf16 dense peak (989
TFLOP/s): ``6 * N_active * tokens`` of every step of the window
(``portbench/core/roofline.py::train_flops``) over the window's seconds,
in percent."""


def read(rec):
    from portbench.core.roofline import PEAK_BF16

    steps = rec.get("steps")
    if not steps:
        return None
    return 100.0 * len(steps) * rec["step_flops"] / (rec["window_s"] * PEAK_BF16)
