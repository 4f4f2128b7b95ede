"""The comparison's arithmetic: leaf norms, the worst leaf's gap of
norms and the worst leaf's error.

A gap of norms is ``|norm_program - norm_reference|`` over the larger of
the reference's norm of that leaf and the median of the reference's leaf
norms, so that a leaf whose gradient is all but zero is not judged
against itself. Leaves whose reference norm lies under a thousandth of
the median leaf's (a gradient that is nought to rounding) move by
round-off alone and are left out.
"""

from __future__ import annotations

import math
import statistics

import torch

__all__ = ["leaf_norms", "leaf_gaps", "leaf_errs", "worst", "least", "median",
           "add_grad_checks", "rel_gap"]

NEGLIGIBLE = 1e-3


def leaf_norms(leaves) -> list:
    """float64 L2 norm of each tensor, as a Python float."""
    return [float(torch.linalg.vector_norm(t.detach().to(torch.float64)))
            for t in leaves]


def _counted(reference: list):
    med = statistics.median(reference)
    return med, [r >= NEGLIGIBLE * med for r in reference]


def leaf_gaps(program: list, reference: list) -> list:
    """Each leaf's gap of norms (``None`` for a leaf left out)."""
    if len(program) != len(reference):
        raise ValueError("trees of different leaf counts")
    med, counted = _counted(reference)
    out = []
    for p, r, ok in zip(program, reference, counted):
        gap = abs(p - r) / max(r, med, 1e-300) if ok else None
        out.append(gap if gap is None or math.isfinite(gap) else math.inf)
    return out


def _rms(leaves) -> list:
    return [n / max(t.numel(), 1) ** 0.5
            for n, t in zip(leaf_norms(leaves), leaves)]


def leaf_errs(program: list, reference: list) -> list:
    """Each leaf's root-mean-square of ``program - reference`` against the
    larger of its own reference RMS and the median leaf's (``None`` for a
    leaf left out): the norm of the difference, for leaves or for samples
    of them of any size."""
    ref = _rms(reference)
    diff = _rms([p.to(torch.float64) - r.to(torch.float64)
                 for p, r in zip(program, reference)])
    med, counted = _counted(ref)
    out = []
    for d, r, ok in zip(diff, ref, counted):
        e = d / max(r, med, 1e-300) if ok else None
        out.append(e if e is None or math.isfinite(e) else math.inf)
    return out


def worst(values: list) -> float:
    """The largest of the counted leaves' numbers."""
    return max((v for v in values if v is not None), default=0.0)


def least(values: list) -> float:
    """The smallest of the counted leaves' numbers."""
    return min((v for v in values if v is not None), default=0.0)


def median(values: list) -> float:
    """The median of the counted leaves' numbers."""
    vals = [v for v in values if v is not None]
    return statistics.median(vals) if vals else 0.0


def add_grad_checks(c, gaps: list, errs: list, names) -> None:
    """The gradients' numbers over the rounds or steps: the worst, the
    median and the best-kept leaf's gap of norms and error, each the
    largest over the rounds, with each leaf's largest kept as detail."""
    for name, per in (("grad_gap", gaps), ("grad_err", errs)):
        for suffix, pick in (("", worst), ("_med", median), ("_min", least)):
            c.add(name + suffix,
                  max(pick(v) for v in per) if per else math.inf)
        c.note(name, [(n, max((v[i] for v in per if v[i] is not None),
                              default=None)) for i, n in enumerate(names)])


def rel_gap(program: float, reference: float) -> float:
    """``|program - reference| / |reference|``."""
    if not (math.isfinite(program) and math.isfinite(reference)):
        return math.inf
    return abs(program - reference) / max(abs(reference), 1e-300)
