"""FL aggregation at the parameter server (port, part; paper eq. (5)).

Counterpart of ``repro.core.aggregation``: ``normalize_weights`` and
``fedsgd_aggregate_batch``. The batch aggregate is a client-order loop of
one float32 multiply plus one add per element
(``transport._scan_weighted_sum``), the same arithmetic as the fused K2
kernel, so the two are bit-identical. The mesh all-reduce
(``approx_allreduce``) belongs to the sharding item of the ROADMAP.
"""

from __future__ import annotations

import torch

from repro_torch.core import transport as transport_lib

__all__ = ["normalize_weights", "fedsgd_aggregate_batch"]


def normalize_weights(weights) -> torch.Tensor:
    """float32 weights scaled to sum 1 (an all-zero input passes through)."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    total = w.sum()
    return w / torch.where(total > 0, total, torch.ones_like(total))


def fedsgd_aggregate_batch(stacked: torch.Tensor, weights) -> torch.Tensor:
    """Paper eq. (5) over a stacked ``(C, ...)`` gradient batch.

    Weights are normalized to sum 1, then ``agg = agg + w[c] * g[c]`` runs
    in client order — never an fma, never reordered — through
    ``transport._scan_weighted_sum``, the loop the fused kernel is held to.
    """
    w = normalize_weights(
        torch.as_tensor(weights, dtype=torch.float32, device=stacked.device))
    return transport_lib._scan_weighted_sum(stacked, w)
