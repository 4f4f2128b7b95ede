"""Phase timers: wall-clock scopes with the first call split from the rest.

Counterpart of ``repro.obs.timers``, with the same API, ``summary()``
keys and ``report()`` layout. The first call of a phase pays one-time
costs (a kernel build, cuDNN's algorithm search, allocator growth), so
each :class:`PhaseStat` keeps it apart from the steady calls:

    timers = PhaseTimers()
    with timers.scope("round"):
        ...
    timers.summary()["round"]  # first_s vs steady_median_s

A scope measures host wall time between ``__enter__`` and ``__exit__``.
PyTorch launches CUDA work asynchronously, so a scope that only enqueues
would measure the enqueue; the round engine therefore synchronises the
device before it closes each scope on a CUDA run, and a scope reads the
device's work. ``NULL_TIMERS`` is a shared no-op sink, so engine code can
always write ``with timers.scope(...)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

__all__ = ["PhaseStat", "PhaseTimers", "NULL_TIMERS", "resolve_timers"]


@dataclasses.dataclass
class PhaseStat:
    """Accumulated wall-clock samples of one named phase."""

    name: str
    first_s: float | None = None  # the first call: one-time costs included
    steady_s: list = dataclasses.field(default_factory=list)  # later calls

    @property
    def calls(self) -> int:
        """Total number of completed scopes."""
        return (0 if self.first_s is None else 1) + len(self.steady_s)

    @property
    def total_s(self) -> float:
        """Wall-clock seconds across every call, first included."""
        return (self.first_s or 0.0) + sum(self.steady_s)

    def steady_median_s(self) -> float:
        """Median of the post-first calls (0.0 with fewer than two calls)."""
        if not self.steady_s:
            return 0.0
        ss = sorted(self.steady_s)
        n = len(ss)
        mid = n // 2
        return ss[mid] if n % 2 else 0.5 * (ss[mid - 1] + ss[mid])

    def record(self, seconds: float) -> None:
        """Add one completed scope's duration."""
        if self.first_s is None:
            self.first_s = seconds
        else:
            self.steady_s.append(seconds)


class PhaseTimers:
    """A bag of named :class:`PhaseStat` scopes (see module docstring)."""

    def __init__(self):
        self.phases: dict[str, PhaseStat] = {}

    @contextlib.contextmanager
    def scope(self, name: str):
        """Context manager timing one occurrence of phase ``name``."""
        stat = self.phases.get(name)
        if stat is None:
            stat = self.phases[name] = PhaseStat(name)
        t0 = time.perf_counter()
        try:
            yield stat
        finally:
            stat.record(time.perf_counter() - t0)

    def summary(self) -> dict:
        """JSON-ready per-phase summary: calls, first-call seconds, steady
        median and total seconds."""
        return {
            name: {
                "calls": st.calls,
                "first_s": st.first_s or 0.0,
                "steady_median_s": st.steady_median_s(),
                "steady_total_s": sum(st.steady_s),
                "total_s": st.total_s,
            }
            for name, st in self.phases.items()
        }

    def report(self) -> str:
        """Human-readable fixed-width table of :meth:`summary`."""
        lines = [f"{'phase':<14} {'calls':>5} {'first':>10} "
                 f"{'steady med':>10} {'total':>10}"]
        for name, s in self.summary().items():
            lines.append(
                f"{name:<14} {s['calls']:>5} {s['first_s'] * 1e3:>8.1f}ms "
                f"{s['steady_median_s'] * 1e3:>8.2f}ms "
                f"{s['total_s']:>9.2f}s")
        return "\n".join(lines)


class _NullTimers(PhaseTimers):
    """Shared do-nothing sink: ``scope`` records nothing, so runs without
    timers stay as they are."""

    @contextlib.contextmanager
    def scope(self, name: str):
        """No-op scope."""
        yield None


NULL_TIMERS = _NullTimers()


def resolve_timers(phase_timers) -> PhaseTimers:
    """``phase_timers=`` engine argument -> a usable sink (``None`` maps to
    the shared no-op)."""
    return NULL_TIMERS if phase_timers is None else phase_timers
