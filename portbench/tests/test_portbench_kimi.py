"""The MLA moe cell at a test's size on the CPU, the chip's look skipped:
it resolves by name; a sound run comes out correct; each planted fault
(the LLM cells' four and this model's own four) fails a number of the
comparison."""

from __future__ import annotations

import time

import pytest
import torch

from portbench.tests._tiny import ROOT, SEED

# one intra-op thread: parallel test workers with multi-threaded small ops
# stall each other
torch.set_num_threads(1)

CELL = "kimi-k2-mla-moe-b4-s4096"


def tiny_kimi_cell(bias_std: float = 0.04):
    """The cell at a CPU test's widths (d_model 64, 4 heads, 16 experts of
    which 4 held, top-4, a 128-row vocabulary slice, 2 x 32 tokens), in
    float32. At these sizes a held expert sees about 16 tokens, so one
    routing flip between bfloat16 and float32 activations moves its
    gradient by several percent; in float32 the program and the reference
    route alike and agree to rounding, and each fault stands out."""
    from portbench.core import bench

    cell = bench.load_cell(CELL, ROOT)
    cell.config.update(num_hidden_layers=3, hidden_size=64,
                       intermediate_size=96, vocab_size=128,
                       num_attention_heads=4, num_key_value_heads=4,
                       q_lora_rank=24, kv_lora_rank=16, qk_nope_head_dim=8,
                       qk_rope_head_dim=8, v_head_dim=8, n_routed_experts=16,
                       n_experts_held=4, num_experts_per_tok=4,
                       moe_intermediate_size=16, dtype="float32")
    cell.config["assumed"] = dict(cell.config["assumed"],
                                  router_bias_std=bias_std)
    cell.traffic.update(batch=2, seq_len=32)
    cell.spec["sample_tiles"] = 4
    cell.spec["grad_samples"] = 256
    return cell


def run_tiny_kimi(fault=None, **kw):
    from portbench import run as run_lib

    return run_lib.run_cell(CELL, seed=SEED, seconds=0.2, trace=False,
                            device="cpu", t_start=time.perf_counter(),
                            fault=fault, cell=tiny_kimi_cell(**kw))


def _failing(checks) -> set:
    return {k for k, v in checks.table().items()
            if v["value"] is None or v["value"] > v["limit"]}


def test_cell_resolves_by_name():
    from portbench.core import bench

    cell = bench.load_cell(CELL, ROOT)
    assert cell.traffic["driver"] == "llm_mla_moe_train_approx"
    assert cell.config["name"] == "kimi-k2-instruct"
    assert (cell.traffic["batch"], cell.traffic["seq_len"]) == (4, 4096)
    assert {m["name"] for m in cell.per_layer} >= {
        "llm.mla_ms", "llm.moe_ms", "moe.experts_roofline", "llm.grad_ms",
        "llm.k0_ms", "mfu.llm", "k0_roofline"}


def test_sound_run_is_correct():
    result, checks = run_tiny_kimi()
    assert result["correct"] is True, checks.lines()
    assert set(result["metrics"]) == {"llm_tokens_per_s", "peak_mem_gib",
                                      "setup_s"}
    # the bias changes selections, and a held expert's load passes the
    # capacity a dropping router would give it: the faults bias_ignored
    # and capacity_drop change what the program computes
    assert checks.info["bias_changed_share"] > 0.05, checks.lines()
    assert checks.info["held_load_over_capacity"] > 1.0, checks.lines()


@pytest.mark.parametrize("fault", [
    "control", "half_batch", "state_unchanged", "answer_altered",
    "bias_ignored", "softmax_router", "no_yarn", "capacity_drop"])
def test_planted_fault_fails_a_number(fault):
    result, checks = run_tiny_kimi(fault)
    assert result["correct"] is False, checks.lines()
    assert _failing(checks), checks.lines()


def test_kimi_reference_loads_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; sys.path[:0] = [%r]\n"
            "import portbench.reference.kimi_k2, portbench.core.mla_moe_flops\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'repro_torch', 'jax', 'jaxlib', 'flax'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
