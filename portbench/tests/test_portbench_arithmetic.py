"""The benchmark's copied yardstick arithmetic against known values."""

from __future__ import annotations

import dataclasses
import json

import pytest

from portbench.tests._tiny import ROOT


def _config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())["model"]


@pytest.mark.parametrize("n,padded,bound_ms", [
    (1_777_088_000, 1_777_088_512, 78.59),      # the port's untied head
    (1_543_714_304, 1_543_714_816, 68.27)])     # published, tied head
def test_k0_bound_at_qwen2_row(n, padded, bound_ms):
    from portbench.core import roofline

    b = roofline.kernel_bound(1, n, 2, "rayleigh", 32, "k0")
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(bound_ms, abs=0.005)
    assert roofline.padded_words(n) == padded


def test_k2_bound_at_main_path():
    from portbench.core import roofline

    b = roofline.kernel_bound(100, 22_528, 2, "rayleigh", 32, "k2")
    assert b["bound_ms"] == pytest.approx(0.0997, abs=5e-5)
    assert b["bytes"] == 9_103_312
    assert roofline.padded_words(21_840) == 22_528


def test_ops_per_symbol():
    from portbench.core import roofline

    assert roofline.ops_per_symbol(2, "rayleigh") == (66, 119)
    assert roofline.ops_per_symbol(2, "awgn") == (49, 79)


def test_qwen2_params_and_step_flops():
    from portbench.core import roofline

    cfg = _config("qwen2-1.5b")
    active, total = roofline.dense_param_counts(cfg)
    assert total == 1_543_714_304
    assert active == 1_543_714_304
    untied = roofline.dense_param_counts(dict(cfg, tie_embeddings=False))
    assert untied == (1_543_714_304, 1_777_088_000)
    assert roofline.train_flops(cfg, 2048) == 6 * active * 2048
    assert roofline.train_flops(cfg, 2048) == pytest.approx(18.969e12,
                                                            rel=1e-4)


def test_qwen2_counts_match_the_port():
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline as port_roofline

    from portbench.core import roofline

    port = get_config("qwen2-1.5b")
    cfg = _config("qwen2-1.5b")
    assert roofline.dense_param_counts(dict(cfg, tie_embeddings=False)) == \
        port_roofline.n_active_params(dataclasses.replace(
            port, tie_embeddings=False))
    # tied: the same total; the copy counts the head the table serves as
    active, total = port_roofline.n_active_params(dataclasses.replace(
        port, tie_embeddings=True))
    assert roofline.dense_param_counts(cfg) == (
        active + cfg["d_model"] * cfg["vocab_size"], total)


def test_cnn_flops():
    from portbench.core import roofline

    cfg = _config("mnist-cnn")
    assert roofline.cnn_forward_flops(cfg) == 961_000
    assert roofline.cnn_round_flops(cfg, 100, 32) == 9_225_600_000
