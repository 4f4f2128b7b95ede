"""Typed per-round / per-event telemetry records (schema v2), port.

Counterpart of ``repro.obs.records``, field for field, so a ledger the
port writes reads back in either package:

* :class:`RoundRecord` — one synchronous round (or one dispatched wave of
  a buffered engine): the scenario link fields, the compression fields,
  the downlink fields, then observability-only extras (the ``uplink_*``
  aggregates of ``TxStats.round_summary``, the event-clock dispatch time,
  the per-round ``sketches`` group). :meth:`RoundRecord.to_link_dict` is
  the ``FLResult.link`` dict: the link fields only, in
  :data:`LINK_FIELDS` order, unset fields left out.
* :class:`EventRecord` — one event-clock happening of a buffered engine
  (wave dispatch, per-client compute / uplink spans, arrivals,
  aggregations, churn, buffer-fill samples), which the ledger writes as
  JSONL and :mod:`repro_torch.obs.trace` renders as tracks.

``to_dict`` drops unset (``None``) fields and ``from_dict`` restores them;
``SCHEMA_VERSION`` stamps every ledger so a reader can refuse records it
does not understand. Pure Python; :func:`scenario_round_record` reduces
the round's tensors with numpy on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "SCHEMA_VERSION",
    "SUPPORTED_SCHEMAS",
    "V2_ROUND_FIELDS",
    "LINK_FIELDS",
    "EVENT_KINDS",
    "RoundRecord",
    "EventRecord",
    "scenario_round_record",
]

# v1 = the typed records; v2 adds the per-round ``sketches`` group.
# Readers accept every version in SUPPORTED_SCHEMAS; writers stamp
# SCHEMA_VERSION.
SCHEMA_VERSION = 2
SUPPORTED_SCHEMAS = (1, 2)

# Fields that exist only from schema v2 on: a v1-stamped ledger line that
# carries one is a mixed-version line, rejected by ``ledger.read_ledger``.
V2_ROUND_FIELDS = ("sketches",)

# The ``FLResult.link`` keys in their order: scenario fields, then
# compression, then downlink. ``to_link_dict`` walks this tuple.
LINK_FIELDS = (
    "round",
    "mean_snr_db",
    "mean_est_db",
    "mode_counts",
    "n_active",
    "n_stragglers",
    "airtime_s",
    "comp_ratio",
    "comp_bits_on_air",
    "comp_residual_norm",
    "downlink_airtime_s",
    "downlink_ber",
    "downlink_mode_counts",
)

# Event kinds of a buffered engine. Span kinds carry ``dur``; instant kinds
# only ``t``; ``buffer`` is a counter sample (``value`` = updates buffered
# after the event).
EVENT_KINDS = (
    "wave",       # span: one dispatch wave, t .. t + dur (last arrival)
    "compute",    # span: one client's local computation
    "uplink",     # span: one client's uplink airtime
    "arrival",    # instant: an update landed in the server buffer
    "aggregate",  # instant: the buffer folded into a new model version
    "join",       # instant: a churned-out client rejoined
    "leave",      # instant: a client churned out
    "buffer",     # counter: buffer fill level after an event
)


@dataclasses.dataclass
class RoundRecord:
    """Typed telemetry of one FL round (or one buffered-engine wave).

    Only ``round`` is mandatory; every other field stays ``None`` until the
    engine fills it, and ``None`` fields are dropped from both serialized
    forms. The first three groups are the link-dict keys
    (:data:`LINK_FIELDS`); the observability-only group never appears in
    :meth:`to_link_dict`.
    """

    round: int
    # -- scenario link fields (scenario rounds only)
    mean_snr_db: float | None = None
    mean_est_db: float | None = None
    mode_counts: list | None = None
    n_active: int | None = None
    n_stragglers: int | None = None
    airtime_s: float | None = None
    # -- compression fields (compressed uplinks only)
    comp_ratio: float | None = None
    comp_bits_on_air: float | None = None
    comp_residual_norm: float | None = None
    # -- downlink fields (noisy broadcast leg only)
    downlink_airtime_s: float | None = None
    downlink_ber: float | None = None
    downlink_mode_counts: list | None = None
    # -- observability-only fields (never in the link-dict view)
    t_event: float | None = None  # event-clock dispatch time (async engine)
    uplink_symbols: float | None = None  # cohort data symbols on air
    uplink_bits: float | None = None  # cohort payload bits offered
    uplink_bit_errors: float | None = None  # cohort residual bit errors
    uplink_ber: float | None = None  # cohort end-to-end payload BER
    uplink_mean_tx: float | None = None  # mean PHY transmissions/client
    uplink_bits_on_air: float | None = None  # cohort bits actually on air
    # -- schema v2: the round's per-client distribution sketches
    # (``repro_torch.obs.metrics.RoundSketcher.round_group``)
    sketches: dict | None = None

    def to_link_dict(self) -> dict:
        """The ``FLResult.link`` dict: link fields only, in
        :data:`LINK_FIELDS` order, ``None`` fields omitted."""
        return {k: getattr(self, k) for k in LINK_FIELDS
                if getattr(self, k) is not None}

    def has_link_fields(self) -> bool:
        """Whether any link field beyond ``round`` is set: the rounds that
        have an ``FLResult.link`` entry."""
        return any(getattr(self, k) is not None for k in LINK_FIELDS[1:])

    def to_dict(self) -> dict:
        """All set fields (link view and extras) as one flat JSON-ready
        dict."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "RoundRecord":
        """Inverse of :meth:`to_dict`; unknown keys raise ``ValueError``,
        so a corrupt ledger fails loudly."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(
                f"RoundRecord.from_dict: unknown field(s) {sorted(unknown)}")
        if "round" not in d:
            raise ValueError("RoundRecord.from_dict: missing 'round'")
        return cls(**d)


@dataclasses.dataclass
class EventRecord:
    """One event-clock happening of a buffered engine.

    ``t`` is the simulated time in seconds; ``kind`` one of
    :data:`EVENT_KINDS`. Span kinds set ``dur``; ``buffer`` samples set
    ``value`` (the fill level); client- and wave-scoped kinds set
    ``client`` / ``wave``; ``aggregate`` sets ``version`` (the model
    version it produced) and ``value`` (how many updates it folded).
    """

    t: float
    kind: str
    wave: int | None = None
    client: int | None = None
    version: int | None = None
    dur: float | None = None
    value: float | None = None

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown event kind {self.kind!r}; one of {EVENT_KINDS}")

    def to_dict(self) -> dict:
        """Set fields as a flat JSON-ready dict (``None`` omitted)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "EventRecord":
        """Inverse of :meth:`to_dict`; unknown keys raise ``ValueError``."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(
                f"EventRecord.from_dict: unknown field(s) {sorted(unknown)}")
        return cls(**d)


def _host(t) -> np.ndarray:
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)


def scenario_round_record(r, rnd, per_client_air, n_modes) -> RoundRecord:
    """One scenario round's link fields as a :class:`RoundRecord`: numpy
    reductions of the round's ``LinkRound`` and per-client airtime on the
    host, as the reference's."""
    mode = _host(rnd.mode)
    return RoundRecord(
        round=r,
        mean_snr_db=float(np.mean(_host(rnd.snr_db))),
        mean_est_db=float(np.mean(_host(rnd.est_db))),
        mode_counts=np.bincount(mode, minlength=n_modes).tolist(),
        n_active=int(_host(rnd.active).sum()),
        n_stragglers=int(_host(rnd.straggler).sum()),
        airtime_s=float(_host(per_client_air).sum()),
    )
