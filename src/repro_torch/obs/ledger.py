"""JSONL run ledger: durable, append-only telemetry for every FL run (port).

Counterpart of ``repro.obs.ledger`` in the same format, so the
reference's reader, validator and ``tools/report.py`` read a ledger the
port wrote. One JSON object per line, flushed as it is written so a
crashed run keeps every completed round:

    {"kind": "manifest", "schema": 2, "fingerprint": ..., "provenance": ...}
    {"kind": "round", "round": 0, "mean_snr_db": ..., ...}
    {"kind": "event", "t": 0.0, "event": "wave", ...}      (async engine)
    {"kind": "eval", "round": 0, "accuracy": ..., ...}
    {"kind": "summary", "final_accuracy": ..., "phases": ...}

The manifest carries a config fingerprint (a stable hash of the run's
algorithm / transport / scenario / compression / downlink arguments, equal
to the reference's for equal arguments), the seed, and a provenance block
with every key of the reference's (``"jax"`` is ``None``: the port does
not use JAX; ``"backend"`` is the engine's device type) plus ``"torch"``
and ``"device"`` (the CUDA device's name, or ``"cpu"``). Round lines are
:class:`~repro_torch.obs.records.RoundRecord` serializations; event lines
wrap :class:`~repro_torch.obs.records.EventRecord`. Attaching a ledger
changes no number of the run: it only reads values the engine computed.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import os
import platform as platform_lib
import subprocess
import sys

import numpy as np
import torch

from repro_torch.obs import records as records_lib

__all__ = [
    "MANIFEST_KEYS",
    "PROVENANCE_KEYS",
    "provenance",
    "config_fingerprint",
    "RunLedger",
    "as_ledger",
    "LedgerData",
    "read_ledger",
    "validate_ledger",
]

# Manifest keys every ledger must carry (validate_ledger enforces these).
MANIFEST_KEYS = ("kind", "schema", "fingerprint", "engine", "algorithm",
                 "n_rounds", "num_clients", "seed", "provenance")
# The reference's provenance keys; the port adds "torch" and "device".
PROVENANCE_KEYS = ("schema", "jax", "numpy", "python", "platform", "backend",
                   "git_sha", "timestamp")


def _git_sha() -> str | None:
    """HEAD of the checkout this package lies in, or ``None`` outside a
    git checkout (provenance never fails a run)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.SubprocessError):
        return None


def provenance(device=None) -> dict:
    """The environment block stamped into ledgers: library versions,
    platform, the device the run used, git sha, UTC time. ``device=None``
    describes the current CUDA device when there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    return {
        "schema": records_lib.SCHEMA_VERSION,
        "jax": None,
        "numpy": np.__version__,
        "python": sys.version.split()[0],
        "platform": platform_lib.platform(),
        "backend": dev.type,
        "git_sha": _git_sha(),
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "torch": torch.__version__,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def _canonical(obj) -> str:
    """Deterministic string form of a config object for fingerprinting:
    dataclasses render as sorted field dicts, containers recurse, leaves
    fall back to ``repr`` (the reference's rule, so equal arguments give
    equal fingerprints in both packages)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = {f.name: _canonical(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)}
        return f"{type(obj).__name__}({sorted(fields.items())})"
    if isinstance(obj, dict):
        return repr(sorted((k, _canonical(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return repr([_canonical(v) for v in obj])
    return repr(obj)


def config_fingerprint(*objs) -> str:
    """Stable 12-hex-digit digest of a run configuration: the join key when
    diffing ledgers (``python -m tools.report a.jsonl b.jsonl``)."""
    text = "|".join(_canonical(o) for o in objs)
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def _json_scalar(obj):
    """``json.dumps`` fallback: numpy scalars and 0-d numpy arrays or torch
    tensors become Python scalars at the wire."""
    if getattr(obj, "ndim", None) == 0 and hasattr(obj, "item"):
        return obj.item()
    raise TypeError(
        f"ledger value of type {type(obj).__name__} is not JSON-serializable")


class RunLedger:
    """Append-only JSONL sink for one FL run (see module docstring).

    ``events=False`` drops the per-event lines while keeping manifest,
    round, eval and summary lines. ``detail="sketch"`` also drops event
    lines and stamps ``detail`` into the manifest; with a
    :class:`~repro_torch.obs.metrics.RoundSketcher` a round line's size
    then depends on the sketch layouts alone. The file opens on the first
    write and every line is flushed. Usable as a context manager; the
    engine closes it at the end of ``run()``, and ``close`` is idempotent.
    """

    def __init__(self, path, *, events: bool = True, detail: str = "full"):
        if detail not in ("full", "sketch"):
            raise ValueError(
                f"detail must be 'full' or 'sketch', got {detail!r}")
        self.path = os.fspath(path)
        self.detail = detail
        self.events = events and detail == "full"
        self._f = None
        self._wrote_manifest = False

    def _write(self, obj: dict) -> None:
        if self._f is None:
            self._f = open(self.path, "w")
        self._f.write(json.dumps(obj, default=_json_scalar) + "\n")
        self._f.flush()

    def write_manifest(self, manifest: dict) -> None:
        """First line of the ledger; later calls are ignored, so a second
        run against the same ledger object cannot corrupt the header."""
        if self._wrote_manifest:
            return
        out = {"kind": "manifest", "schema": records_lib.SCHEMA_VERSION,
               "detail": self.detail}
        out.update(manifest)
        self._write(out)
        self._wrote_manifest = True

    def write_round(self, rec: records_lib.RoundRecord) -> None:
        """One per-round (or per-wave) record line."""
        self._write({"kind": "round", **rec.to_dict()})

    def write_event(self, ev: records_lib.EventRecord) -> None:
        """One event-clock line (no-op when ``events=False``)."""
        if not self.events:
            return
        d = ev.to_dict()
        d["event"] = d.pop("kind")
        self._write({"kind": "event", **d})

    def write_eval(self, rnd: int, accuracy: float, airtime_s: float,
                   event_s: float | None = None) -> None:
        """One accuracy-curve point (round, accuracy, cumulative airtime,
        and for a buffered engine the event-clock time)."""
        out = {"kind": "eval", "round": int(rnd),
               "accuracy": float(accuracy), "airtime_s": float(airtime_s)}
        if event_s is not None:
            out["event_s"] = float(event_s)
        self._write(out)

    def write_summary(self, summary: dict) -> None:
        """Final line: the run's outcome (final accuracy, wall time, the
        phase-timer summary, ...)."""
        self._write({"kind": "summary", **summary})

    def close(self) -> None:
        """Close the file handle (idempotent)."""
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def as_ledger(ledger) -> RunLedger | None:
    """``ledger=`` engine argument -> a :class:`RunLedger` (a path-like
    opens a fresh ledger; a ledger object passes through)."""
    if ledger is None or isinstance(ledger, RunLedger):
        return ledger
    return RunLedger(ledger)


@dataclasses.dataclass
class LedgerData:
    """A parsed ledger: the manifest dict, typed round / event records,
    eval points, and the summary dict (``None`` if the run crashed)."""

    manifest: dict
    rounds: list
    events: list
    evals: list
    summary: dict | None

    @property
    def link(self) -> list:
        """The run's ``FLResult.link``, rebuilt from the round records."""
        return [r.to_link_dict() for r in self.rounds
                if r.has_link_fields()]


def read_ledger(path) -> LedgerData:
    """Parse a JSONL ledger back into typed records.

    Tolerates a torn final line (a crashed run). Accepts every schema in
    ``records.SUPPORTED_SCHEMAS``; rejects unknown schemas, unknown record
    kinds, unknown record fields, and mixed-version lines (a v1 ledger
    whose round line carries a v2-only field), each with a ``path:lineno:``
    error.
    """
    manifest, rounds, events, evals, summary = None, [], [], [], None
    schema = records_lib.SCHEMA_VERSION
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            # A torn final line is a crash's trace; a torn interior line
            # is corruption.
            if i == len(lines) - 1:
                break
            raise
        kind = obj.pop("kind", None)
        if kind == "manifest":
            schema = obj.get("schema")
            if schema not in records_lib.SUPPORTED_SCHEMAS:
                raise ValueError(
                    f"{path}:{i + 1}: ledger schema {schema!r}, reader "
                    f"supports {records_lib.SUPPORTED_SCHEMAS}")
            manifest = obj
        elif kind == "round":
            if schema < 2:
                v2 = [k for k in records_lib.V2_ROUND_FIELDS if k in obj]
                if v2:
                    raise ValueError(
                        f"{path}:{i + 1}: schema-{schema} ledger has a "
                        f"round line with v2-only field(s) {v2} "
                        f"(mixed-version line)")
            try:
                rounds.append(records_lib.RoundRecord.from_dict(obj))
            except ValueError as e:
                raise ValueError(f"{path}:{i + 1}: {e}") from None
        elif kind == "event":
            obj["kind"] = obj.pop("event")
            try:
                events.append(records_lib.EventRecord.from_dict(obj))
            except ValueError as e:
                raise ValueError(f"{path}:{i + 1}: {e}") from None
        elif kind == "eval":
            evals.append(obj)
        elif kind == "summary":
            summary = obj
        else:
            raise ValueError(
                f"{path}:{i + 1}: unknown ledger record kind {kind!r}")
    if manifest is None:
        raise ValueError(f"{path}: no manifest line (not a run ledger?)")
    return LedgerData(manifest, rounds, events, evals, summary)


def validate_ledger(path) -> list:
    """Schema-validate a ledger file; returns a list of problem strings
    (empty = valid)."""
    problems = []
    try:
        data = read_ledger(path)
    except (ValueError, OSError) as e:
        msg = str(e)
        # Per-line reader errors already carry their "path:lineno:".
        if msg.startswith(f"{path}:"):
            return [msg]
        return [f"{path}: unreadable: {e}"]
    for key in MANIFEST_KEYS[1:]:  # "kind" was consumed by the reader
        if key not in data.manifest:
            problems.append(f"{path}: manifest missing key {key!r}")
    prov = data.manifest.get("provenance", {})
    for key in PROVENANCE_KEYS:
        if key not in prov:
            problems.append(f"{path}: provenance missing key {key!r}")
    for i, ev in enumerate(data.events):
        if ev.kind in ("wave", "compute", "uplink") and ev.dur is None:
            problems.append(
                f"{path}: event {i} ({ev.kind}) is a span but has no dur")
    seen = [r.round for r in data.rounds]
    if seen != sorted(seen):
        problems.append(f"{path}: round records out of order")
    for ev in data.evals:
        for key in ("round", "accuracy", "airtime_s"):
            if key not in ev:
                problems.append(f"{path}: eval record missing {key!r}")
    return problems
