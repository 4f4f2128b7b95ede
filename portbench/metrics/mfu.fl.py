"""mfu.fl: the whole round's share of the card's float32 peak (67 TFLOP/s;
the CNN runs in float32 with TF32 off): the CNN's model FLOPs of every
round of the window (forward and backward of each client's minibatch,
``portbench/core/roofline.py::cnn_round_flops``) and of its eval passes,
over the window's seconds, in percent. The PHY's work is left out."""


def read(rec):
    from portbench.core.roofline import PEAK_F32

    rounds = rec.get("rounds")
    if not rounds:
        return None
    evals = sum(1 for r in rounds if r["phase_s"].get("eval", 0.0) > 0.0)
    flops = len(rounds) * rec["round_flops"] + evals * rec["eval_flops"]
    return 100.0 * flops / (rec["window_s"] * PEAK_F32)
