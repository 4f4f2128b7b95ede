"""The comparison's control at a test's size: the reference computed one
precision below the configuration's and put in the program's place, a
whole run through ``run_cell`` with the chip's look skipped, comes out
not correct (TF32 for the CNN's float32, emulated on the CPU by rounding
the operands; float8 e4m3 for qwen2's bfloat16), by a number of the
gradients (which one depends on the size: on the card the control fails
``grad_err_min`` in every cell)."""

from __future__ import annotations

from portbench.tests._tiny import run_tiny


def _control_fails(cell: str) -> None:
    result, checks = run_tiny(cell, "control")
    assert result["correct"] is False, checks.lines()
    failing = {k for k, v in checks.table().items()
               if v["value"] is None or v["value"] > v["limit"]}
    assert failing & {"grad_gap", "grad_err", "grad_err_min"}, checks.lines()


def test_tf32_control_fails_the_cnn_cells_limit():
    _control_fails("cnn-approx-k2")


def test_fp8_control_fails_the_llm_cells_limit():
    _control_fails("qwen2-1.5b-k0-s256")
