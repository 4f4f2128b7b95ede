"""Tiny cells for the benchmark's CPU tests: the manifest's cells with
their sizes cut so that a run takes seconds on the CPU."""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

SEED = 2**31 + 977


def tiny_cell(name: str):
    """The cell ``name`` of ``BENCHMARK.json`` at a CPU test's size."""
    from portbench.core import bench

    cell = bench.load_cell(name, ROOT)
    if cell.traffic["driver"] == "fl_fedsgd":
        cell.traffic["world"] = dict(n_clients=4, per_client=8,
                                     digits_per_client=2, train_per_class=8,
                                     test_per_class=4)
        cell.traffic["batch_per_round"] = 4
    else:
        cell.config["model"].update(n_layers=1, d_model=32, n_heads=2,
                                    n_kv_heads=1, head_dim=16, d_ff=48,
                                    vocab_size=128)
        cell.traffic.update(batch=2, seq_len=8)
        cell.spec["sample_tiles"] = 4
    return cell


def run_tiny(name: str, fault=None, seed: int = SEED):
    """One CPU run of the tiny cell: ``(result, checks)``."""
    import time

    from portbench import run as run_lib

    return run_lib.run_cell(name, seed=seed, seconds=0.2, trace=False,
                            device="cpu", t_start=time.perf_counter(),
                            fault=fault, cell=tiny_cell(name))
