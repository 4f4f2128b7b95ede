"""Observability of the port: typed records, run ledgers, traces, phase
timers, per-client sketches, and the span recorder.

Counterpart of ``repro.obs``, module for module:

* :mod:`repro_torch.obs.records` — :class:`RoundRecord` /
  :class:`EventRecord` (schema v2); ``FLResult.link`` is the
  ``to_link_dict()`` view of ``FLResult.records``;
* :mod:`repro_torch.obs.ledger` — the JSONL :class:`RunLedger` (manifest
  with config fingerprint and provenance, one flushed line per record) and
  its reader and validator, in the reference's format;
* :mod:`repro_torch.obs.trace` — the Chrome/Perfetto
  :class:`TraceRecorder` of a buffered engine's event clock;
* :mod:`repro_torch.obs.timers` — :class:`PhaseTimers`, wall-clock scopes
  with the first call split from the steady state;
* :mod:`repro_torch.obs.sketch` — mergeable bucket sketches (device-side
  ``int32`` histograms, quantile estimates, keyed reservoir exemplars);
* :mod:`repro_torch.obs.metrics` — the per-round :class:`RoundSketcher`
  and the :class:`MetricsRegistry` OpenMetrics exporter;
* :mod:`repro_torch.obs.spans` — the port's own span recorder, with no
  counterpart in the reference: spans at every layer boundary, timed
  without synchronising the device (CUDA event pairs for device work,
  read at a synchronise the program makes), summed per name by
  ``collect`` (``FLResult.phase_s``, the LLM step's spans) or kept whole
  by ``record`` (parent, round or step id, Unix-epoch start and end, the
  profiler's clock). The span tree: a round is ``round`` > ``key``,
  ``sample``, ``link``, ``downlink``, ``gradients``, ``uplink`` (>
  ``keys``, ``kernel``, ``codec``, ``channel``, ``demod``, ``mean``),
  ``apply``, ``telemetry``, ``eval``; the LLM approx step is ``step`` >
  ``grad``, ``uplink`` (> ``flatten``, ``keys``, ``kernel``,
  ``unflatten``), ``apply``. Beside them, ``FLResult.counters``: each
  round's K0 / K1 / K2 launches.

Every sink is an observer: attaching one changes no number of a run.
"""

from repro_torch.obs import spans  # noqa: F401
from repro_torch.obs.ledger import (  # noqa: F401
    LedgerData,
    RunLedger,
    config_fingerprint,
    provenance,
    read_ledger,
    validate_ledger,
)
from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_LAYOUTS,
    MetricsRegistry,
    RoundSketcher,
    registry_from_ledger,
    resolve_sketches,
)
from repro_torch.obs.records import (  # noqa: F401
    EVENT_KINDS,
    LINK_FIELDS,
    SCHEMA_VERSION,
    EventRecord,
    RoundRecord,
)
from repro_torch.obs.sketch import BucketLayout, Sketch  # noqa: F401
from repro_torch.obs.timers import NULL_TIMERS, PhaseStat, PhaseTimers  # noqa: F401
from repro_torch.obs.trace import TraceRecorder  # noqa: F401

__all__ = [
    "SCHEMA_VERSION",
    "LINK_FIELDS",
    "EVENT_KINDS",
    "RoundRecord",
    "EventRecord",
    "RunLedger",
    "LedgerData",
    "read_ledger",
    "validate_ledger",
    "provenance",
    "config_fingerprint",
    "TraceRecorder",
    "PhaseTimers",
    "PhaseStat",
    "NULL_TIMERS",
    "BucketLayout",
    "Sketch",
    "DEFAULT_LAYOUTS",
    "RoundSketcher",
    "resolve_sketches",
    "MetricsRegistry",
    "registry_from_ledger",
    "spans",
]
