"""Per-round sketches of the cohort and the OpenMetrics export (port).

Counterpart of ``repro.obs.metrics``:

* :data:`DEFAULT_LAYOUTS` — the bucket layouts of the per-client metrics:
  true and estimated SNR (linear dB buckets), payload BER (log buckets),
  airtime, mode dwell (rounds since the client's last mode switch),
  staleness (buffered engine) and downlink BER.
* :class:`RoundSketcher` — one per engine run: each round, one reduction
  on the sketcher's device (:func:`_round_reduce`) turns the round's
  per-client tensors into fixed-size ``int32`` bucket counts plus ``k``
  worst-client and reservoir exemplars, and only those cross to the host.
  The run-level :class:`~repro_torch.obs.sketch.Sketch` accumulators fold
  every round (merge = element-wise add).
* :class:`MetricsRegistry` — counters, gauges and histograms with an
  OpenMetrics text exposition, and :func:`registry_from_ledger`, which
  rebuilds one from a run ledger.

The sketcher reads the round key only through ``fold_in`` on the reserved
``OBS_KEY_LANE`` and reads tensors the round already produced, so a run
with sketches is bit for bit the run without.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import keylanes
from repro_torch.obs.sketch import (BucketLayout, Sketch, bucket_counts,
                                    reservoir_sample, reservoir_tags, worst_k)

__all__ = [
    "DEFAULT_LAYOUTS",
    "RoundSketcher",
    "resolve_sketches",
    "MetricsRegistry",
    "registry_from_ledger",
    "render_openmetrics",
]

# dB metrics use linear buckets (half a bucket = 0.625 dB); ratio and time
# metrics log buckets (sqrt(gamma) - 1, ~7.5% for the BER layout).
DEFAULT_LAYOUTS = {
    "snr_db": BucketLayout("snr_db", "linear", -20.0, 60.0, 64),
    "est_db": BucketLayout("est_db", "linear", -20.0, 60.0, 64),
    "ber": BucketLayout("ber", "log", 1e-8, 1.0, 128),
    "airtime_s": BucketLayout("airtime_s", "log", 1e-7, 1e3, 96),
    "dwell_rounds": BucketLayout("dwell_rounds", "linear", 0.0, 64.0, 64),
    "staleness": BucketLayout("staleness", "linear", 0.0, 32.0, 32),
    "downlink_ber": BucketLayout("downlink_ber", "log", 1e-8, 1.0, 128),
}

# The sketched round metrics, in the order of ``_round_reduce``'s
# ``layouts`` (``downlink_ber`` last: only rounds with a downlink have it).
_ROUND_METRICS = ("snr_db", "est_db", "ber", "airtime_s", "dwell_rounds",
                  "downlink_ber")


def _round_reduce(key, snr_db, est_db, ber, airtime_s, mode, active,
                  member, prev_mode, dwell, dl_ber, *, layouts: tuple,
                  k: int, with_dl: bool):
    """The per-round reduction, on the inputs' device: ``(counts, dwell,
    prev_mode, exemplars)``, every output of fixed size.

    ``member`` masks the observed cohort (all ones for the sync engine);
    ``active`` also masks the clients whose uplink happened (the BER and
    airtime observations).
    """
    snr_lay, est_lay, ber_lay, air_lay, dwell_lay, dl_lay = layouts
    member_b = member > 0
    eff_b = (member * active) > 0
    dwell = torch.where(
        member_b, torch.where(mode == prev_mode, dwell + 1, 1), dwell)
    prev_mode = torch.where(member_b, mode, prev_mode)
    counts = {
        "snr_db": bucket_counts(snr_db, snr_lay, mask=member_b),
        "est_db": bucket_counts(est_db, est_lay, mask=member_b),
        "ber": bucket_counts(ber, ber_lay, mask=eff_b),
        "airtime_s": bucket_counts(airtime_s, air_lay, mask=eff_b),
        "dwell_rounds": bucket_counts(
            dwell.to(torch.float32), dwell_lay, mask=member_b),
    }
    if with_dl:
        counts["downlink_ber"] = bucket_counts(dl_ber, dl_lay, mask=member_b)
    w_ber, w_idx = worst_k(ber, k, mask=eff_b)
    tags = reservoir_tags(key, snr_db.shape[0])
    tags = torch.where(member_b, tags, torch.inf)
    r_tags, r_idx = reservoir_sample(tags, k)
    ex = {
        "w_ber": w_ber, "w_idx": w_idx,
        "w_snr": snr_db[w_idx], "w_mode": mode[w_idx],
        "r_tags": r_tags, "r_idx": r_idx,
        "r_snr": snr_db[r_idx], "r_ber": ber[r_idx],
    }
    return counts, dwell, prev_mode, ex


class RoundSketcher:
    """Per-round sketches of one engine run, on ``device``.

    :meth:`round_group` takes the round's per-client tensors (SNR, BER,
    airtime, the mode vector, the activity masks), moves them to the
    sketcher's device, and returns the JSON-safe ``sketches`` group of the
    round's :class:`~repro_torch.obs.records.RoundRecord`, folding the same
    counts into the run-level accumulators (:attr:`run`). The mode dwell
    and previous mode live on the device as int32 tensors. Exemplars: the
    ``k`` worst clients by BER (with their SNR and mode) and a ``k``-client
    keyed reservoir. ``device=None`` is the GPU.
    """

    def __init__(self, num_clients: int, *, layouts: dict | None = None,
                 exemplar_k: int = 4, device=None):
        """Set up layouts and the dwell state."""
        keylanes.check_cohort(keylanes.OBS_KEY_LANE, num_clients)
        self.device = resolve_device(device)
        self.num_clients = int(num_clients)
        self.exemplar_k = min(int(exemplar_k), self.num_clients)
        self.layouts = dict(DEFAULT_LAYOUTS)
        if layouts:
            self.layouts.update(layouts)
        self.run = {name: Sketch(lay) for name, lay in self.layouts.items()}
        self._dwell = torch.zeros(self.num_clients, dtype=torch.int32,
                                  device=self.device)
        self._prev_mode = torch.full((self.num_clients,), -1,
                                     dtype=torch.int32, device=self.device)
        self._layout_args = tuple(self.layouts[m] for m in _ROUND_METRICS)

    def _on(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def round_group(self, key, *, snr_db, est_db, ber, airtime_s, mode,
                    active, member=None, downlink_ber=None) -> dict:
        """Sketch one round; returns the record's ``sketches`` group
        (per-metric ``{layout, counts, total}`` and the exemplar lists).
        ``member=None`` means the whole cohort was observed."""
        f32, M = torch.float32, self.num_clients
        if member is None:
            member = torch.ones(M, dtype=f32)
        with_dl = downlink_ber is not None
        if not with_dl:
            downlink_ber = torch.zeros(M, dtype=f32)
        counts, self._dwell, self._prev_mode, ex = _round_reduce(
            self._on(key, torch.int64), self._on(snr_db, f32),
            self._on(est_db, f32), self._on(ber, f32),
            self._on(airtime_s, f32), self._on(mode, torch.int32),
            self._on(active, f32), self._on(member, f32), self._prev_mode,
            self._dwell, self._on(downlink_ber, f32),
            layouts=self._layout_args, k=self.exemplar_k, with_dl=with_dl)
        # One host transfer for every count vector, two for the exemplars.
        # Metrics in sorted order, as the reference's jitted dict returns
        # them, so the groups serialize alike.
        names = sorted(counts)
        flat = torch.cat([counts[n] for n in names]).cpu().numpy()
        floats = torch.stack([ex[n] for n in (
            "w_ber", "w_snr", "r_tags", "r_snr", "r_ber")]).cpu().numpy()
        ints = torch.stack([ex[n].to(torch.int64) for n in (
            "w_idx", "w_mode", "r_idx")]).cpu().numpy()
        group, at = {}, 0
        for name in names:
            size = self.layouts[name].n + 2
            c = flat[at: at + size].astype(np.int64)
            at += size
            self.run[name].add_counts(c)
            group[name] = {"layout": self.layouts[name].to_dict(),
                           "counts": [int(x) for x in c],
                           "total": int(c.sum())}
        group["exemplars"] = self._format_exemplars(floats, ints)
        return group

    @staticmethod
    def _format_exemplars(floats, ints) -> dict:
        """JSON form of the exemplars (masked-out winners, with ``-inf``
        BERs or ``+inf`` tags, are dropped)."""
        w_ber, w_snr, r_tags, r_snr, r_ber = floats
        w_idx, w_mode, r_idx = ints
        worst = [{"client": int(w_idx[j]), "ber": float(w_ber[j]),
                  "snr_db": float(w_snr[j]), "mode": int(w_mode[j])}
                 for j in range(w_ber.shape[0]) if np.isfinite(w_ber[j])]
        reservoir = [{"client": int(r_idx[j]), "tag": float(r_tags[j]),
                      "snr_db": float(r_snr[j]), "ber": float(r_ber[j])}
                     for j in range(r_tags.shape[0])
                     if np.isfinite(r_tags[j])]
        return {"worst_ber": worst, "reservoir": reservoir}

    def observe_staleness(self, values) -> None:
        """Fold host-side staleness observations (buffered aggregations)
        into the run-level ``staleness`` sketch."""
        vals = np.asarray(values, np.float32).reshape(-1)
        if vals.size:
            self.run["staleness"].observe(vals)

    def summary(self) -> dict:
        """Run-level sketch group (non-empty sketches only) for the
        ledger's summary line."""
        return {name: sk.to_dict() for name, sk in self.run.items()
                if sk.total > 0}


def resolve_sketches(sketches, num_clients: int,
                     device=None) -> RoundSketcher | None:
    """The engine's ``sketches=`` argument -> a :class:`RoundSketcher` on
    ``device``: ``None`` / ``False`` none; ``True`` the default layouts; a
    sketcher passes through; a dict overrides layouts (``{metric:
    BucketLayout}``)."""
    if sketches is None or sketches is False:
        return None
    if isinstance(sketches, RoundSketcher):
        return sketches
    if sketches is True:
        return RoundSketcher(num_clients, device=device)
    if isinstance(sketches, dict):
        return RoundSketcher(num_clients, layouts=sketches, device=device)
    raise ValueError(
        f"sketches= must be None/True/RoundSketcher/layout-dict, got "
        f"{type(sketches).__name__}")


def _metric_name_ok(name: str) -> bool:
    """OpenMetrics metric-name validity (``[a-zA-Z_:][a-zA-Z0-9_:]*``)."""
    if not name:
        return False
    ok = set("abcdefghijklmnopqrstuvwxyz"
             "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")
    return name[0] not in "0123456789" and all(c in ok for c in name)


class MetricsRegistry:
    """A flat registry of counters, gauges and sketch-backed histograms.

    :meth:`render` emits it as OpenMetrics text (``# HELP`` / ``# TYPE``,
    cumulative ``_bucket{le=...}`` series for histograms, ``# EOF``).
    Registration is idempotent per name; another type under a registered
    name raises ``ValueError``.
    """

    def __init__(self) -> None:
        """Start empty."""
        self._metrics: dict[str, dict] = {}

    def _register(self, name: str, kind: str, help_text: str) -> dict:
        if not _metric_name_ok(name):
            raise ValueError(f"invalid OpenMetrics metric name {name!r}")
        m = self._metrics.get(name)
        if m is None:
            m = {"kind": kind, "help": help_text, "value": 0.0,
                 "sketch": None}
            self._metrics[name] = m
        elif m["kind"] != kind:
            raise ValueError(
                f"metric {name!r} already registered as {m['kind']}")
        return m

    def counter(self, name: str, help_text: str = "") -> "MetricsRegistry":
        """Declare a counter (monotone; rendered with a ``_total`` sample)."""
        self._register(name, "counter", help_text)
        return self

    def inc(self, name: str, amount: float = 1.0) -> None:
        """Increment a counter (declares it on first use)."""
        m = self._register(name, "counter", "")
        if amount < 0:
            raise ValueError(f"counter {name!r}: negative increment")
        m["value"] += amount

    def gauge(self, name: str, value: float, help_text: str = "") -> None:
        """Set a gauge to ``value`` (declares it on first use)."""
        m = self._register(name, "gauge", help_text)
        m["value"] = float(value)

    def histogram(self, name: str, sketch: Sketch,
                  help_text: str = "") -> None:
        """Attach (or merge) a :class:`Sketch` as a histogram metric."""
        m = self._register(name, "histogram", help_text)
        m["sketch"] = (sketch if m["sketch"] is None
                       else m["sketch"].merge(sketch))

    def sketches(self) -> dict:
        """The registered histogram sketches by metric name."""
        return {n: m["sketch"] for n, m in self._metrics.items()
                if m["kind"] == "histogram" and m["sketch"] is not None}

    def render(self) -> str:
        """The registry as OpenMetrics text exposition (ends ``# EOF``)."""
        return render_openmetrics(self._metrics)


def _fmt_num(v: float) -> str:
    """OpenMetrics sample value (integer-valued floats stay short)."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_openmetrics(metrics: dict) -> str:
    """Render a ``{name: {kind, help, value, sketch}}`` table as
    OpenMetrics text. A histogram's cumulative buckets fold the underflow
    slot into every bucket and the overflow slot only into ``+Inf``;
    ``_sum`` is the bucket-representative estimate (:meth:`Sketch.mean`).
    """
    lines = []
    for name in sorted(metrics):
        m = metrics[name]
        kind, help_text = m["kind"], m["help"]
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        if kind == "counter":
            lines.append(f"{name}_total {_fmt_num(m['value'])}")
        elif kind == "gauge":
            lines.append(f"{name} {_fmt_num(m['value'])}")
        elif kind == "histogram":
            sk = m["sketch"]
            if sk is None:
                continue
            lay = sk.layout
            cum = int(sk.counts[lay.n])
            for edge, c in zip(lay.edges()[1:], sk.counts[: lay.n]):
                cum += int(c)
                lines.append(f'{name}_bucket{{le="{edge:.6g}"}} {cum}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {sk.total}')
            lines.append(f"{name}_sum {_fmt_num(sk.mean() * sk.total)}")
            lines.append(f"{name}_count {sk.total}")
        else:  # pragma: no cover - _register restricts kinds
            raise ValueError(f"unknown metric kind {kind!r}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def registry_from_ledger(path) -> MetricsRegistry:
    """A :class:`MetricsRegistry` from a run ledger: round and event counts
    as counters, final accuracy and airtime as gauges, and histograms from
    the summary's ``sketches`` group (a crashed run without a summary
    merges the per-round groups instead; the merge is exact)."""
    from repro_torch.obs import ledger as ledger_lib

    data = ledger_lib.read_ledger(path)
    reg = MetricsRegistry()
    reg.counter("repro_rounds", "rounds (or waves) recorded in the ledger")
    reg.inc("repro_rounds", len(data.rounds))
    reg.counter("repro_events", "event-clock records in the ledger")
    reg.inc("repro_events", len(data.events))
    if data.summary is not None:
        if "final_accuracy" in data.summary:
            reg.gauge("repro_final_accuracy",
                      data.summary["final_accuracy"],
                      "final eval accuracy of the run")
        if "airtime_s" in data.summary:
            reg.gauge("repro_airtime_seconds", data.summary["airtime_s"],
                      "cumulative cohort airtime at the end of the run")
    if data.summary is not None and isinstance(
            data.summary.get("sketches"), dict):
        groups = [data.summary["sketches"]]
    else:
        groups = [r.sketches for r in data.rounds if r.sketches]
    for group in groups:
        for metric, d in group.items():
            if metric == "exemplars" or not isinstance(d, dict):
                continue
            if "counts" not in d:
                continue
            reg.histogram(f"repro_client_{metric}", Sketch.from_dict(d),
                          f"per-client {metric} distribution "
                          f"(mergeable bucket sketch)")
    return reg
