"""``run.py`` itself: without a card it fails with its message and prints
no result; the per-layer readers find nothing in an empty record."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests._tiny import ROOT


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run.py would measure it")


def test_run_without_a_card_fails_with_its_message(no_card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cnn-approx-k2",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("metric", json.loads(
    (ROOT / "BENCHMARK.json").read_text())["per_layer"],
    ids=lambda m: m["name"])
def test_reader_finds_nothing_in_an_empty_record(metric):
    from portbench.core import bench

    assert bench.read_metric(metric["name"], {"profile": None}, ROOT) is None
