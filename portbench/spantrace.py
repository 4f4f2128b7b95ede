#!/usr/bin/env python3
"""Run one cell traced, with the program's spans joined onto the trace.

    python3 portbench/spantrace.py --workload <cell> --seed <n> --seconds <s> [--record-window 1]

A diagnostic beside ``run.py``, which the benchmark's own runs never call.
It runs the cell's driver as ``run.py --trace 1`` does, with the profiled
stretch inside a recording scope of the port's spans
(``repro_torch.obs.spans.record``), and prints one JSON line: the cell's
end-to-end numbers and every per-layer metric of the cell, the trace's
``idle_gaps`` beside ``idle_by_span`` (the same gaps named by the innermost
program span open at each one's middle, ``core/spanjoin.py``), the share
of the stretch's idle time under no span (``unspanned_pct``), the K0 / K1
/ K2 launches a round or step in the stretch, and the clock check: how
many host-side launches of those kernels lie inside the program's
``kernel`` spans. ``--record-window 1`` keeps every span of the whole run
(check rounds, window, stretch) in a recording scope too, so that the
window's rate reads what full tracing costs.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

KERNELS = ("k0_approx_channel", "k1_approx_channel", "k2_approx_channel")


def trace_cell(cell, *, seed: int, seconds: float, device,
               record_window: bool, t_start: float) -> dict:
    """One traced run of ``cell`` with its spans joined onto the trace (the
    module docstring); on the CPU, which the driver does not profile, the
    run's numbers and per-layer metrics alone."""
    import torch

    from portbench.core import bench, spanjoin
    from portbench.core import trace as trace_lib
    from repro_torch.kernels import approx_channel as ac
    from repro_torch.obs import spans

    dev = torch.device(device)
    got: dict = {}
    profiled = trace_lib.profiled

    @contextlib.contextmanager
    def recorded(device):
        with profiled(device) as out:
            before = ac.launch_counts()
            with spans.record(device) as rec:
                yield out
            got.update(out=out, rec=rec, launches={
                k: v - before[k] for k, v in ac.launch_counts().items()})

    trace_lib.profiled = recorded
    try:
        with (spans.record(dev) if record_window
              else contextlib.nullcontext()):
            out = cell.driver.run(cell, seed=seed, seconds=seconds,
                                  trace=True, device=dev, t_start=t_start)
    finally:
        trace_lib.profiled = profiled
    res = {"workload": cell.name, "seed": seed,
           "record_window": int(record_window),
           "correct": out["checks"].passed(),
           "end_to_end": {k: v[0] for k, v in out["end_to_end"].items()}}
    if dev.type == "cuda":
        res["device"] = bench.device_info(torch, cell.chips,
                                          out["peak_bytes"])
    res["per_layer"] = {m["name"]: bench.read_metric(
        m["name"], out["records"], ROOT) for m in cell.per_layer}
    if "rec" in got:
        device, host = spanjoin.trace_events(got["out"]["prof"])
        rows = spanjoin.span_rows(got["rec"].spans)
        roots = sum(1 for s in got["rec"].spans if s.parent is None
                    and s.name in ("round", "step"))
        res["idle_gaps"] = (out.get("breakdown") or {}).get("idle_gaps")
        idle = spanjoin.idle_by_span(device, rows)
        res["idle_by_span"] = idle and idle["gaps"]
        res["idle_totals_by_span"] = idle and idle["by_span"]
        res["unspanned_pct"] = idle and idle["unspanned_pct"]
        res["roots"] = roots
        res["launches_per_root"] = {k: v / max(roots, 1)
                                    for k, v in got["launches"].items()}
        res["clock"] = spanjoin.clock_check(device, host, rows, KERNELS)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--record-window", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import run as run_lib

    run_lib._paths()
    import torch

    from portbench.core import bench

    if not torch.cuda.is_available():
        print("spantrace: no CUDA device: it traces the card", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload, ROOT)
    print(json.dumps(trace_cell(
        cell, seed=args.seed, seconds=args.seconds, device="cuda",
        record_window=bool(args.record_window), t_start=T_START)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
