"""Mergeable constant-memory sketches of per-client link telemetry (port).

Counterpart of ``repro.obs.sketch``, with the same layouts, slots, tags
and selections, so counts and exemplars equal the reference's on equal
inputs:

* **Bucketed histograms** (:class:`BucketLayout`, :func:`bucket_counts`):
  a fixed-size ``int32`` count vector per metric, computed on the values'
  device: ``torch.searchsorted(right=True)`` over the float32 cast of the
  layout's edges, then an integer ``scatter_add_``. Integer counts make
  the merge (element-wise add) exactly associative and commutative.
* **Quantile estimates** (:class:`Sketch`): log layouts bound the relative
  error by ``sqrt(gamma) - 1`` with ``gamma = (hi / lo) ** (1 / n)`` for
  values in ``[lo, hi]``; linear layouts (dB metrics) bound the absolute
  error by ``(hi - lo) / (2 n)``.
* **Deterministic keyed reservoirs** (:func:`reservoir_tags`,
  :func:`reservoir_sample`, :func:`worst_k`): client ``i``'s tag is
  ``uniform(fold_in(key, OBS_KEY_LANE + i))``, a pure function of the
  round key and the index; the ``k`` smallest tags are the sample.

Every count vector has ``n + 2`` slots: ``n`` buckets, an underflow slot
(index ``n``: values below ``lo``; exact zeros on a log layout) and an
overflow slot (``n + 1``: values above ``hi``; ``+inf``). NaN lands where
the reference's ``jnp.searchsorted`` puts it, past the last inner edge
(bucket ``n - 1``). Selections break ties by the lower index and order
floats as XLA's ``top_k`` does, by IEEE total order (``-0.0 < 0.0``, NaN
above ``+inf``, a negative NaN below ``-inf``): a stable sort of the
float's total-order integer key, never ``torch.topk``, whose tie order is
not promised on the GPU.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import keylanes
from repro_torch.core import prng

__all__ = [
    "BucketLayout",
    "Sketch",
    "bucket_counts",
    "reservoir_tags",
    "reservoir_sample",
    "worst_k",
]


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """A fixed bucketing of one metric: ``n`` buckets spanning ``[lo, hi]``.

    ``scale`` is ``"log"`` (geometric buckets; ``lo > 0``) or ``"linear"``
    (equal widths; for dB metrics). The layout is metadata, stamped into
    every ledger line beside its counts; two count vectors merge only if
    their layouts are equal.
    """

    name: str
    scale: str
    lo: float
    hi: float
    n: int

    def __post_init__(self) -> None:
        """Validate the range."""
        if self.scale not in ("log", "linear"):
            raise ValueError(f"layout {self.name!r}: scale must be 'log' or "
                             f"'linear', got {self.scale!r}")
        if self.scale == "log" and self.lo <= 0:
            raise ValueError(f"layout {self.name!r}: log scale needs lo > 0")
        if not self.lo < self.hi:
            raise ValueError(f"layout {self.name!r}: need lo < hi")
        if self.n < 1:
            raise ValueError(f"layout {self.name!r}: need n >= 1 buckets")

    @property
    def gamma(self) -> float:
        """Geometric bucket growth factor (log layouts only)."""
        return (self.hi / self.lo) ** (1.0 / self.n)

    def edges(self) -> np.ndarray:
        """The ``n + 1`` bucket edges as float64 (edge 0 = lo, edge n = hi)."""
        if self.scale == "log":
            return np.geomspace(self.lo, self.hi, self.n + 1)
        return np.linspace(self.lo, self.hi, self.n + 1)

    def representatives(self) -> np.ndarray:
        """Per-bucket point estimates: geometric (log) / arithmetic mids."""
        e = self.edges()
        if self.scale == "log":
            return np.sqrt(e[:-1] * e[1:])
        return 0.5 * (e[:-1] + e[1:])

    def error_bound(self) -> float:
        """The estimation bound for in-range values: relative for log
        layouts (``sqrt(gamma) - 1``), absolute for linear ones (half a
        bucket)."""
        if self.scale == "log":
            return math.sqrt(self.gamma) - 1.0
        return (self.hi - self.lo) / (2.0 * self.n)

    def to_dict(self) -> dict:
        """Plain-dict form for ledger lines / OpenMetrics labels."""
        return {"name": self.name, "scale": self.scale, "lo": self.lo,
                "hi": self.hi, "n": self.n}

    @classmethod
    def from_dict(cls, d: dict) -> "BucketLayout":
        """Rebuild a layout from :meth:`to_dict` output."""
        return cls(name=d["name"], scale=d["scale"], lo=float(d["lo"]),
                   hi=float(d["hi"]), n=int(d["n"]))


def _as_tensor(x, dtype, device=None) -> torch.Tensor:
    t = torch.as_tensor(x)
    return t.to(device=t.device if device is None else device, dtype=dtype)


def bucket_counts(values, layout: BucketLayout, mask=None) -> torch.Tensor:
    """``(n + 2,)`` int32 counts of ``values`` on their device.

    Slot ``n`` counts underflow (``v < lo``), slot ``n + 1`` overflow
    (``v > hi``); entries where ``mask`` is false land in no slot.
    """
    v = _as_tensor(values, torch.float32).reshape(-1)
    n, dev = layout.n, v.device
    edges = torch.from_numpy(
        layout.edges()[1:-1].astype(np.float32)).to(dev)
    inner = torch.searchsorted(edges, v, right=True)
    inner = torch.where(torch.isnan(v), n - 1, inner)
    seg = torch.where(v < float(np.float32(layout.lo)), n,
                      torch.where(v > float(np.float32(layout.hi)), n + 1,
                                  inner))
    if mask is not None:
        m = _as_tensor(mask, torch.bool, dev).reshape(-1)
        seg = torch.where(m, seg, n + 2)
    counts = torch.zeros(n + 3, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, seg, torch.ones_like(seg, dtype=torch.int32))
    return counts[: n + 2]


def reservoir_tags(key: torch.Tensor, num_clients: int) -> torch.Tensor:
    """Per-client reservoir tags on the reserved obs lane: client ``i``
    draws ``uniform(fold_in(key, OBS_KEY_LANE + i))``, on the key's
    device."""
    keylanes.check_cohort(keylanes.OBS_KEY_LANE, num_clients)
    idx = torch.arange(num_clients, dtype=torch.int64, device=key.device)
    return prng.uniform(prng.fold_in(key, idx + int(keylanes.OBS_KEY_LANE)))


def _total_order(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys in IEEE total order (XLA's sort order)."""
    bits = v.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def reservoir_sample(tags, k: int):
    """``(sel_tags, sel_idx)``: the ``k`` smallest tags in ascending order,
    ties to the lower index (the reference's ``top_k`` of ``-tags``)."""
    t = _as_tensor(tags, torch.float32)
    idx = torch.sort(_total_order(t), stable=True).indices[:k]
    return t[idx], idx


def worst_k(values, k: int, mask=None):
    """``(top_values, top_idx)``: the ``k`` largest entries, descending,
    ties to the lower index; masked-out entries become ``-inf`` first."""
    v = _as_tensor(values, torch.float32)
    if mask is not None:
        m = _as_tensor(mask, torch.bool, v.device)
        v = torch.where(m, v, -math.inf)
    idx = torch.sort(_total_order(v), descending=True, stable=True).indices
    idx = idx[:k]
    return v[idx], idx


class Sketch:
    """Host-side mergeable histogram and quantile estimator over a layout.

    Wraps an ``(n + 2,)`` integer count vector (:func:`bucket_counts`):
    counts only, held as int64, so :meth:`merge` is exactly associative
    and commutative and many int32 partials cannot overflow.
    """

    def __init__(self, layout: BucketLayout, counts=None) -> None:
        """An empty sketch, or one adopting an existing count vector."""
        self.layout = layout
        if counts is None:
            self.counts = np.zeros(layout.n + 2, np.int64)
        else:
            c = np.asarray(counts, np.int64).reshape(-1)
            if c.shape[0] != layout.n + 2:
                raise ValueError(
                    f"sketch {layout.name!r}: counts length {c.shape[0]}, "
                    f"layout wants {layout.n + 2}")
            self.counts = c.copy()

    @property
    def total(self) -> int:
        """Number of observed values (including under/overflow)."""
        return int(self.counts.sum())

    def observe(self, values, mask=None) -> "Sketch":
        """Fold raw values into this sketch through :func:`bucket_counts`."""
        self.counts += bucket_counts(values, self.layout,
                                     mask).cpu().numpy().astype(np.int64)
        return self

    def add_counts(self, counts) -> "Sketch":
        """Fold a raw ``(n + 2,)`` count vector (e.g. a round's partial)."""
        if isinstance(counts, torch.Tensor):
            counts = counts.cpu().numpy()
        c = np.asarray(counts, np.int64).reshape(-1)
        if c.shape[0] != self.layout.n + 2:
            raise ValueError(
                f"sketch {self.layout.name!r}: partial length {c.shape[0]}, "
                f"layout wants {self.layout.n + 2}")
        self.counts += c
        return self

    def merge(self, other: "Sketch") -> "Sketch":
        """Element-wise-add merge; layouts must match exactly."""
        if self.layout != other.layout:
            raise ValueError(f"cannot merge sketch {other.layout.name!r} "
                             f"into {self.layout.name!r}: layouts differ")
        return Sketch(self.layout, self.counts + other.counts)

    def quantile(self, q: float) -> float:
        """Rank-``floor(q * (total - 1))`` estimate (np.quantile 'lower').

        The exact order statistic at that rank lies in the reported
        bucket. Underflow ranks report ``0.0`` on log layouts and ``lo`` on
        linear ones; overflow ranks report ``hi``.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        total = self.total
        if total == 0:
            return 0.0
        rank = int(math.floor(q * (total - 1)))
        n = self.layout.n
        # rank order: underflow slot first, then buckets, then overflow.
        order = np.concatenate(([self.counts[n]], self.counts[:n],
                                [self.counts[n + 1]]))
        cum = np.cumsum(order)
        pos = int(np.searchsorted(cum, rank + 1))
        if pos == 0:
            return 0.0 if self.layout.scale == "log" else float(self.layout.lo)
        if pos == n + 1:
            return float(self.layout.hi)
        return float(self.layout.representatives()[pos - 1])

    def mean(self) -> float:
        """Bucket-representative mean (under/overflow use ``lo`` / ``hi``)."""
        total = self.total
        if total == 0:
            return 0.0
        reps = self.layout.representatives()
        lo_rep = 0.0 if self.layout.scale == "log" else self.layout.lo
        s = (float(self.counts[: self.layout.n] @ reps)
             + float(self.counts[self.layout.n]) * lo_rep
             + float(self.counts[self.layout.n + 1]) * self.layout.hi)
        return s / total

    def to_dict(self) -> dict:
        """JSON-safe form: layout metadata and the full count vector (its
        size depends on the layout alone)."""
        return {"layout": self.layout.to_dict(),
                "counts": [int(c) for c in self.counts],
                "total": self.total}

    @classmethod
    def from_dict(cls, d: dict) -> "Sketch":
        """Rebuild a sketch from :meth:`to_dict` output."""
        return cls(BucketLayout.from_dict(d["layout"]), d["counts"])

    def __eq__(self, other) -> bool:
        """Equal layouts and identical counts."""
        return (isinstance(other, Sketch) and self.layout == other.layout
                and bool(np.array_equal(self.counts, other.counts)))

    def __repr__(self) -> str:
        """Compact form with the headline quantiles."""
        return (f"Sketch({self.layout.name!r}, total={self.total}, "
                f"p50={self.quantile(0.5):.4g}, "
                f"p99={self.quantile(0.99):.4g})")
