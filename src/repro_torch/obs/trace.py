"""Chrome/Perfetto trace export of a buffered engine's event clock (port).

Counterpart of ``repro.obs.trace``: :class:`TraceRecorder` takes a stream
of :class:`~repro_torch.obs.records.EventRecord`\\ s and renders it in the
Chrome trace-event JSON format, which ``https://ui.perfetto.dev`` (or
``chrome://tracing``) loads:

* **waves** track (pid "server") — one span per dispatched wave, from its
  dispatch to its last member's arrival;
* **aggregate** track — an instant per buffer fold, labeled with the model
  version and how many updates it folded;
* **buffer** counter track — the server buffer's fill level over time;
* **client i** tracks (pid "clients") — each client's compute span, then
  its uplink-airtime span, per wave;
* **churn** track — join / leave instants.

Timestamps are the simulated event clock in seconds, written in the
format's microseconds. Ingestion is bookkeeping on host floats, so a
recorder changes no number of the run.
"""

from __future__ import annotations

import json
import os

from repro_torch.obs import records as records_lib

__all__ = ["TraceRecorder", "as_trace"]

# One "process" per track family; Perfetto renders each (pid, tid) pair as
# its own named track.
_PID_SERVER = 1
_PID_CLIENTS = 2
_TID_WAVES = 1
_TID_AGG = 2
_TID_CHURN = 3


def _us(t_s: float) -> float:
    """Simulated seconds -> trace microseconds."""
    return float(t_s) * 1e6


class TraceRecorder:
    """Collects :class:`EventRecord` streams into a Chrome trace.

    ``path=None`` keeps the trace in memory (``to_chrome`` /
    ``export(path)``); a path given here lets the engine call
    :meth:`export` with no argument. Track metadata (process and thread
    names) is emitted on a track's first event only.
    """

    def __init__(self, path=None):
        self.path = None if path is None else os.fspath(path)
        self.events: list = []  # EventRecords, in arrival order
        self._chrome: list = []
        self._named: set = set()

    def _name(self, pid: int, tid: int | None, name: str) -> None:
        key = (pid, tid)
        if key in self._named:
            return
        self._named.add(key)
        if tid is None:  # process metadata
            self._chrome.append({
                "ph": "M", "name": "process_name", "pid": pid,
                "args": {"name": name}})
        else:
            self._name(pid, None,
                       "server" if pid == _PID_SERVER else "clients")
            self._chrome.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": name}})

    def _client_tid(self, client: int) -> int:
        tid = int(client) + 1  # tid 0 renders oddly in some viewers
        self._name(_PID_CLIENTS, tid, f"client {int(client)}")
        return tid

    def add(self, ev: records_lib.EventRecord) -> None:
        """Ingest one engine event (see
        :data:`repro_torch.obs.records.EVENT_KINDS` for spans, instants and
        counters)."""
        self.events.append(ev)
        k = ev.kind
        if k == "wave":
            self._name(_PID_SERVER, _TID_WAVES, "waves")
            self._chrome.append({
                "ph": "X", "name": f"wave {ev.wave}", "cat": "wave",
                "pid": _PID_SERVER, "tid": _TID_WAVES,
                "ts": _us(ev.t), "dur": _us(ev.dur or 0.0),
                "args": {"wave": ev.wave, "members": ev.value}})
        elif k in ("compute", "uplink"):
            tid = self._client_tid(ev.client)
            self._chrome.append({
                "ph": "X", "name": k, "cat": k,
                "pid": _PID_CLIENTS, "tid": tid,
                "ts": _us(ev.t), "dur": _us(ev.dur or 0.0),
                "args": {"wave": ev.wave}})
        elif k == "arrival":
            tid = self._client_tid(ev.client)
            self._chrome.append({
                "ph": "i", "name": "arrival", "cat": "arrival", "s": "t",
                "pid": _PID_CLIENTS, "tid": tid, "ts": _us(ev.t),
                "args": {"wave": ev.wave}})
        elif k == "aggregate":
            self._name(_PID_SERVER, _TID_AGG, "aggregate")
            self._chrome.append({
                "ph": "i", "name": f"v{ev.version}", "cat": "aggregate",
                "s": "p", "pid": _PID_SERVER, "tid": _TID_AGG,
                "ts": _us(ev.t),
                "args": {"version": ev.version, "folded": ev.value}})
        elif k in ("join", "leave"):
            self._name(_PID_SERVER, _TID_CHURN, "churn")
            self._chrome.append({
                "ph": "i", "name": f"{k} {ev.client}", "cat": "churn",
                "s": "t", "pid": _PID_SERVER, "tid": _TID_CHURN,
                "ts": _us(ev.t), "args": {"client": ev.client}})
        elif k == "buffer":
            self._chrome.append({
                "ph": "C", "name": "buffer_fill", "cat": "buffer",
                "pid": _PID_SERVER, "ts": _us(ev.t),
                "args": {"updates": ev.value}})

    def track_types(self) -> set:
        """Distinct track families present (``wave`` / ``client-span`` /
        ``aggregate`` / ``churn`` / ``buffer`` / ``arrival``)."""
        out = set()
        for e in self._chrome:
            cat = e.get("cat")
            if cat in ("compute", "uplink"):
                out.add("client-span")
            elif cat:
                out.add(cat)
        return out

    def to_chrome(self) -> dict:
        """The trace as a Chrome trace-event JSON object."""
        return {"traceEvents": list(self._chrome),
                "displayTimeUnit": "ms",
                "otherData": {"clock": "simulated event seconds",
                              "schema": records_lib.SCHEMA_VERSION}}

    def export(self, path=None) -> str:
        """Write the trace JSON to ``path`` (default: the constructor's)
        and return the path written."""
        path = self.path if path is None else os.fspath(path)
        if path is None:
            raise ValueError("TraceRecorder.export: no path given")
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


def as_trace(trace) -> TraceRecorder | None:
    """``trace=`` engine argument -> a :class:`TraceRecorder` (a path-like
    opens a fresh recorder that exports there; a recorder passes
    through)."""
    if trace is None or isinstance(trace, TraceRecorder):
        return trace
    return TraceRecorder(trace)
