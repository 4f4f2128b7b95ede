"""The program's spans on the device trace's clock.

A recording scope of the port (``repro_torch.obs.spans.record``) keeps
each span's host start and end in Unix-epoch nanoseconds, mapped through
the anchor pair the scope takes (``time.time_ns()``, ``perf_counter_ns()``).
The profiler's events are on the same clock once their relative times are
added to ``prof.profiler.kineto_results.trace_start_ns()``. This module
puts the two side by side:

* ``trace_events`` reads a profile into device and host-side events on
  that clock, with the correlation id that ties a launch to its kernel;
* ``idle_by_span`` labels each idle interval between device operations by
  the innermost program span open at its middle (its path from the root,
  ``round/sample``), or ``UNSPANNED``, and gives the share of the idle time
  under no span;
* ``clock_check`` finds the host-side launches of the kernels named and
  tells how many lie inside the program's ``kernel`` spans.

The inputs are plain lists, so a fabricated trace tests it on the CPU.
"""

from __future__ import annotations

import statistics

__all__ = ["UNSPANNED", "trace_events", "span_rows", "idle_by_span",
           "clock_check"]

UNSPANNED = "(no program span)"


def trace_events(prof):
    """``(device, host)``: each a list of ``(t0_ns, t1_ns, name, corr)`` of
    the profile's device operations and host-side events, on the Unix-epoch
    clock."""
    import torch

    base = prof.profiler.kineto_results.trace_start_ns()
    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        row = (base + round(tr.start * 1e3), base + round(tr.end * 1e3),
               e.name, e.id)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if tr.end > tr.start:
                device.append(row)
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append(row)
    return device, host


def span_rows(spans) -> list:
    """A recording's spans as ``(t0_ns, t1_ns, path, depth)``, the path the
    names from the root down joined by ``/``."""
    paths, depth, out = [], [], []
    for s in spans:
        if s.parent is None:
            paths.append(s.name)
            depth.append(0)
        else:
            paths.append(paths[s.parent] + "/" + s.name)
            depth.append(depth[s.parent] + 1)
        out.append((s.t0_ns, s.t1_ns, paths[-1], depth[-1]))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(rows, t) -> str:
    inner = [r for r in rows if r[0] <= t <= r[1]]
    if not inner:
        return UNSPANNED
    return max(inner, key=lambda r: (r[3], -(r[1] - r[0])))[2]


def idle_by_span(device, rows, top: int = 10) -> dict | None:
    """The idle intervals between the device operations ``device`` (rows
    of :func:`trace_events`), each labelled by :func:`span_rows`' ``rows``:
    ``{"gaps": [[label, seconds]] (the ``top`` longest), "by_span": {label:
    seconds} (all of them), "unspanned_pct": percent of the idle time under
    no span}``, or ``None`` without device operations."""
    merged = _merge([(d[0], d[1]) for d in device])
    if not merged:
        return None
    gaps = [(s1 - e0, e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])]
    by_span: dict = {}
    labelled = []
    for gap, e0, s1 in gaps:
        label = _label(rows, 0.5 * (e0 + s1))
        by_span[label] = by_span.get(label, 0.0) + gap * 1e-9
        labelled.append((gap, label))
    total = sum(g for g, _, _ in gaps) * 1e-9
    labelled.sort(key=lambda g: -g[0])
    return {
        "gaps": [[label, gap * 1e-9] for gap, label in labelled[:top]],
        "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
        "unspanned_pct": (100.0 * by_span.get(UNSPANNED, 0.0) / total
                          if total > 0 else 0.0),
    }


def clock_check(device, host, rows, kernel_parts, span_name="kernel"):
    """The host-side launches (rows of ``host`` sharing a correlation id
    with a device operation whose name holds one of ``kernel_parts``)
    against the program's spans whose path ends in ``span_name``: ``{"n",
    "inside", "share", "lead_us_median", "lead_us_max", "margin_us_min"}``
    (lead: launch start less its span's start; margin: the least distance
    from a launch to an end of its span), or ``None`` with no launch."""
    corr = {d[3] for d in device
            if any(p in d[2] for p in kernel_parts) and d[3]}
    launches = [h for h in host if h[3] in corr]
    if not launches:
        return None
    mine = [r for r in rows if r[2].rsplit("/", 1)[-1] == span_name]
    leads, margins = [], []
    for t0, t1, _, _ in launches:
        around = [r for r in mine if r[0] <= t0 and t1 <= r[1]]
        if around:
            r = min(around, key=lambda r: r[1] - r[0])
            leads.append((t0 - r[0]) * 1e-3)
            margins.append(min(t0 - r[0], r[1] - t1) * 1e-3)
    out = {"n": len(launches), "inside": len(leads),
           "share": len(leads) / len(launches)}
    if leads:
        out.update(lead_us_median=statistics.median(leads),
                   lead_us_max=max(leads), margin_us_min=min(margins))
    return out
