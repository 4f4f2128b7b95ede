#!/usr/bin/env python3
"""Readings behind the limits of a cell's comparison, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--faults control half_batch ...] [--fault-seeds 3] [--out FILE]

Each reading is a whole run of the cell through ``run.run_cell``, with a
short window, in one process: the program as it runs (the lower
readings) on every seed, and on the first ``--fault-seeds`` seeds the
same run with each of ``--faults`` planted: ``control`` (the reference
one precision below the configuration's, put in the program's place:
TF32 for the CNN's float32, float8 e4m3 for qwen2's bfloat16),
``half_batch`` (half of the batch left out, the mean over the rest),
``state_unchanged`` and ``answer_altered``. Each must come out not
correct. Prints one JSON line a seed and, with ``--out``, writes them
all to FILE. The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# readings need no measured window: a short one closes the run
WINDOW_S = 0.5


def _reading(cell, seed: int, fault) -> dict:
    import torch

    from portbench import run as run_lib

    t0 = time.perf_counter()
    result, checks = run_lib.run_cell(cell.name, seed=seed, seconds=WINDOW_S,
                                      trace=False, device="cuda", t_start=t0,
                                      fault=fault, cell=cell)
    torch.cuda.empty_cache()
    return {"correct": result["correct"], **checks.values, **checks.info,
            "details": checks.details, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=["control", "half_batch"])
    ap.add_argument("--fault-seeds", type=int, default=3,
                    help="plant the faults on the first this many seeds")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench.core import bench

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload, ROOT)
    rows = []
    for i, seed in enumerate(args.seeds):
        row = {"seed": seed, "program": _reading(cell, seed, None)}
        for fault in args.faults if i < args.fault_seeds else ():
            row[fault] = _reading(cell, seed, fault)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
