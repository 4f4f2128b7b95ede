"""Named, device-synchronised time spans inside a collecting scope.

The round engine wraps its uplink in :func:`collect`; code further down
(the key schedule, the kernel launch) marks its steps with :func:`span`.
Inside a collecting scope each span synchronises the device on entry and
on exit and adds its host-clock seconds to the scope's dict under its
name, so the uplink's time splits into its parts on the rounds it
describes. Outside one, :func:`span` only reads a context variable.

This module has no counterpart in the reference. The engine's coarser
phase scopes (``sample``, ``round``, ``telemetry``, ``eval``) are
:mod:`repro_torch.obs.timers`, the reference's ``PhaseTimers``; spans
split the uplink and the downlink inside a round (``FLResult.phase_s``).
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import torch

__all__ = ["collect", "span"]

_ACTIVE = contextvars.ContextVar("repro_torch_spans", default=None)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def collect(device):
    """Collect the spans run inside this scope: yields ``{name: seconds}``,
    each name summed over its spans. ``device`` is the one to synchronise."""
    seconds: dict = {}
    token = _ACTIVE.set((seconds, torch.device(device)))
    try:
        yield seconds
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def span(name: str):
    """Time the enclosed step under ``name`` when a :func:`collect` scope
    is active; do nothing otherwise."""
    active = _ACTIVE.get()
    if active is None:
        yield
        return
    seconds, device = active
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
