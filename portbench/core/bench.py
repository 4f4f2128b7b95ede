"""What every cell shares: the manifest and the files it names, the
per-layer readers, the comparison's numbers and limits, the import check,
and the result line.

A cell is found by name: ``BENCHMARK.json``'s ``workloads`` entry gives
its configuration (``configs`` -> ``file``) and its traffic
(``portbench/traffic/<traffic>.json``, whose ``driver`` names
``portbench/drivers/<driver>.py``), and ``portbench/workloads/<cell>.json``
holds what belongs to the cell alone: the limits of its comparison and
the length of its profiled stretch. A per-layer metric ``<name>`` is read
by ``portbench/metrics/<name>.py``'s ``read(records)``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import pathlib
import subprocess
import sys

__all__ = ["ROOT", "Cell", "load_cell", "read_metric", "Checks",
           "forbidden_modules", "device_info", "result_line", "log"]

ROOT = pathlib.Path(__file__).resolve().parents[2]

# Top-level module names no process of the benchmark may hold: JAX and the
# JAX package the port was made from (whole names: the port's own
# ``repro_torch`` begins with ``repro``).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(t_start: float, what: str) -> None:
    """A progress line on standard error: seconds since the run started."""
    import time

    print(f"portbench: {time.perf_counter() - t_start:9.3f} s  {what}",
          file=sys.stderr, flush=True)


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # portbench/traffic/<traffic>.json
    spec: dict            # portbench/workloads/<cell>.json
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries

    @property
    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; ``KeyError`` if there
    is none."""
    man = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    e2e = [m for m in man["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if _applies(m, name) and m["moves"] in reported]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(root / configs[w["config"]]["file"]),
        traffic=_json(root / "portbench" / "traffic" / f"{w['traffic']}.json"),
        spec=_json(root / "portbench" / "workloads" / f"{name}.json"),
        end_to_end=e2e, per_layer=layer)


def read_metric(name: str, records: dict, root: pathlib.Path = ROOT):
    """``portbench/metrics/<name>.py``'s reading of ``records``, or
    ``None`` when it finds nothing to read."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(records)
    return None if value is None else float(value)


class Checks:
    """The numbers a run compares, each with its limit: a number passes
    when it is finite and at most its limit. A number the cell's file
    gives no limit is kept as information and compared with nothing."""

    def __init__(self, limits: dict):
        self.limits = dict(limits)
        self.values: dict = {}
        self.info: dict = {}
        self.details: dict = {}

    def add(self, name: str, value) -> None:
        (self.values if name in self.limits else self.info)[name] = float(value)

    def note(self, name: str, values) -> None:
        """Keep per-leaf numbers behind a compared one, for the record."""
        self.details[name] = list(values)

    def passed(self) -> bool:
        if set(self.values) != set(self.limits):
            return False
        return all(math.isfinite(v) and v <= self.limits[k]
                   for k, v in self.values.items())

    def table(self) -> dict:
        """``{name: {"value", "limit"}}``; a number that is missing or not
        finite is ``None``."""
        out = {}
        for k, lim in self.limits.items():
            v = self.values.get(k)
            ok = v is not None and math.isfinite(v)
            out[k] = {"value": v if ok else None, "limit": lim}
        return out

    def lines(self) -> list:
        out = [f"detail {k} {v!r}" for k, v in self.details.items()]
        out += [f"info {k} {v!r} (not compared)" for k, v in self.info.items()]
        for k, v in self.table().items():
            ok = v["value"] is not None and v["value"] <= v["limit"]
            out.append(f"check {k} {v['value']!r} limit {v['limit']!r} "
                       f"{'ok' if ok else 'FAIL'}")
        return out


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def device_info(torch, chips: int, peak_bytes: int) -> dict:
    """The ``device`` entry: platform, the card's name, the cards used, the
    peak, and the card's power limit as ``nvidia-smi`` reads it."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        info["power_limit"] = out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: Checks,
                breakdown: dict | None = None) -> str:
    """The result's JSON line, the compared numbers last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks.table()
    return json.dumps(out)
