"""A whole LLM run at a test's size, the chip's look skipped: sound, it
comes out correct; with the timed path broken underneath (half of the
batch left out, the state left unchanged, K0's received row altered), it
comes out not correct."""

from __future__ import annotations

import pytest

from portbench.tests._tiny import run_tiny


@pytest.mark.parametrize("fault", [None, "half_batch", "state_unchanged",
                                   "answer_altered"])
def test_llm_run_is_judged(fault):
    result, checks = run_tiny("qwen2-1.5b-k0-s256", fault)
    assert result["correct"] is (fault is None), checks.lines()
    assert set(result["metrics"]) == {"llm_tokens_per_s", "peak_mem_gib",
                                      "setup_s"}
