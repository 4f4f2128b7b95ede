#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout; ``portbench/README.md`` says what a cell is made of. The run
makes its inputs and weights from ``--seed``, warms up every shape the
cell uses, measures for ``--seconds`` seconds, checks what the timed path
produced against the plain reference under ``portbench/reference``, and
prints one JSON line as the last line of its standard output:
``--trace 0`` gives the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a traced run. Each compared number and its limit
are the last lines of standard error and the last key of the line.

It exits non-zero without a result when there is no CUDA card, fewer
cards than the cell asks for, or a module of JAX or of the JAX package
``repro`` loaded once the window has closed. It measures only the
PyTorch/CUDA port, ``src/repro_torch``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _paths() -> None:
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # Kernel and compiler caches at fixed places inside the checkout, so
    # only a checkout's first run builds (the port's own nvcc build goes to
    # build/kernels/ there).
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def run_cell(name: str, *, seed: int, seconds: float, trace: bool, device,
             t_start: float, fault: str | None = None, cell=None):
    """Run cell ``name`` (or the given ``cell``) and judge it: ``(result
    dict, Checks)``, the result without its ``checks`` entry."""
    import torch

    from portbench.core import bench

    cell = cell or bench.load_cell(name, ROOT)
    out = cell.driver.run(cell, seed=seed, seconds=seconds, trace=trace,
                          device=device, t_start=t_start, fault=fault)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = bench.read_metric(m["name"], out["records"], ROOT)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]][0],
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = torch.device(device)
    if dev.type == "cuda":
        info = bench.device_info(torch, cell.chips, out["peak_bytes"])
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    if trace and out.get("records", {}).get("profile"):
        prof = out["records"]["profile"]
        info["busy_s"], info["window_s"] = prof["busy_s"], prof["window_s"]
    result = {"correct": out["checks"].passed(), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": info,
              "breakdown": out.get("breakdown") if trace else None}
    return result, out["checks"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()

    import torch

    from portbench.core import bench

    cell = bench.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device: the benchmark measures the port on "
              "the card and never falls back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA devices, "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, seed=args.seed,
                              seconds=args.seconds, trace=bool(args.trace),
                              device="cuda", t_start=T_START, cell=cell)
    bad = bench.forbidden_modules()
    if bad:
        print("portbench: modules of JAX or of the JAX package are loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for line in checks.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(bench.result_line(checks=checks, **result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
