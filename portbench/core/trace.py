"""The device trace of a ``--trace 1`` run: a short profiled stretch of the
program, read with ``torch.profiler`` (CUPTI) into the numbers the
per-layer readers need. Nothing is written to disk.

``summarize`` gives, for the stretch:

* ``window_s``: its length on the host clock, the device synchronised at
  both ends, so all of its device work lies inside it;
* ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy or fill) ran;
* ``ops``: seconds and counts of device operations by name;
* ``idle_gaps``: the longest stretches with no device operation, each
  named by the innermost host-side event the trace holds at its middle
  (the CUDA runtime's calls), or by the last one before it.

A trace with no device operation gives ``None``: the readers then find
nothing and their metrics are left out of the line.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["profiled", "summarize", "kernel_ms"]

# Kernel names are C++ signatures; the breakdown keeps their first part.
NAME_CHARS = 120


@contextlib.contextmanager
def profiled(device):
    """Profile the enclosed stretch; yields a dict that holds, on exit,
    ``{"prof": profiler, "window_s": seconds}``."""
    from torch.profiler import ProfilerActivity, profile

    out: dict = {}
    torch.cuda.synchronize(device)
    # CUDA activity only: recording every host-side operator as well slows
    # the eager host path by about half and would read as device idle time.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize(device)
        out["window_s"] = time.perf_counter() - t0
    out["prof"] = prof


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(trace: dict, top: int = 10) -> dict | None:
    """The stretch's busy time, device operations and idle gaps (module
    docstring), or ``None`` when the trace holds no device operation."""
    events = trace["prof"].events()
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
    dev = [d for d in dev if d[1] > d[0]]
    if not dev:
        return None
    ops: dict = {}
    for s, e, name in dev:
        sec, cnt = ops.get(name, (0.0, 0))
        ops[name] = (sec + (e - s) * 1e-6, cnt + 1)
    merged = _merge([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _)
                   in zip(merged, merged[1:])), reverse=True)[:top]
    return {
        "window_s": trace["window_s"],
        "busy_s": min(busy_s, trace["window_s"]),
        "ops": {k: {"seconds": v[0], "count": v[1]} for k, v in ops.items()},
        "device_ops": sorted(([k[:NAME_CHARS], v[0]] for k, v in ops.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": [[_host_label(host, 0.5 * (e0 + s1)), gap * 1e-6]
                      for gap, e0, s1 in gaps],
    }


def _host_label(host, mid) -> str:
    """The innermost host-side event running at ``mid``, else the last one
    that ended before it."""
    inner = [h for h in host if h[0] <= mid <= h[1]]
    if inner:
        return min(inner, key=lambda h: h[1] - h[0])[2]
    before = [h for h in host if h[1] <= mid]
    return ("host, after " + max(before, key=lambda h: h[1])[2] if before
            else "host")


def kernel_ms(summary: dict | None, name_part: str) -> float | None:
    """Mean milliseconds of the device operations whose name holds
    ``name_part``, or ``None`` when there is none."""
    if not summary:
        return None
    sec = cnt = 0
    for name, v in summary["ops"].items():
        if name_part in name:
            sec += v["seconds"]
            cnt += v["count"]
    return sec / cnt * 1e3 if cnt else None
