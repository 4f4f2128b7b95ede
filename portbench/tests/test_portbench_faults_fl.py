"""A whole FL run at a test's size, the chip's look skipped: sound, it
comes out correct; with the timed path broken underneath (half of each
minibatch left out, the state left unchanged, an answer altered where it
is produced), it comes out not correct."""

from __future__ import annotations

import pytest

from portbench.tests._tiny import run_tiny


@pytest.mark.parametrize("cell,fault", [
    ("cnn-approx-k2", None), ("cnn-approx-k2", "half_batch"),
    ("cnn-approx-k2", "state_unchanged"), ("cnn-approx-k2", "answer_altered"),
    ("cnn-approx-layered", None)])
def test_fl_run_is_judged(cell, fault):
    result, checks = run_tiny(cell, fault)
    assert result["correct"] is (fault is None), checks.lines()
    assert set(result["metrics"]) == {"fl_rounds_per_s", "fl_round_p95_ms",
                                      "peak_mem_gib", "setup_s"}
