"""FL aggregation, including the distributed approximate-uplink all-reduce
(port of ``repro.core.aggregation``; paper eq. (5)).

``fedsgd_aggregate`` is the PS-side weighted sum of client gradients.
``fedsgd_aggregate_batch`` is a client-order loop of one float32 multiply
plus one add per element (``transport._scan_weighted_sum``), the same
arithmetic as the fused K2 kernel, so the two are bit-identical.

``approx_allreduce`` maps the paper's uplink onto a ``torch.distributed``
process group: each rank plays one client cohort. Its local gradient
passes through the simulated PHY with its own channel realization, keyed
``fold_in(key, rank)`` (the reference's shard index over the data axes),
and the parameter-server aggregation is an all-reduce. ``group=None`` is
a world of one: no process group is needed, and the "all-reduce" is the
local tensor.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import prng
from repro_torch.core import transport as transport_lib
from repro_torch.obs import spans

__all__ = [
    "fedsgd_aggregate",
    "normalize_weights",
    "fedsgd_aggregate_batch",
    "corrupt_local",
    "group_rank",
    "group_size",
    "approx_allreduce",
]


def fedsgd_aggregate(grads: Sequence[Any], weights: Sequence[float]):
    """Weighted aggregation ``g = sum_m (|D_m|/|D|) g_m`` (paper eq. (5))
    over client trees, with host-float weights ``w / total``."""
    total = float(sum(weights))
    scale = [w / total for w in weights]

    def comb(*leaves):
        return sum(s * l for s, l in zip(scale, leaves))

    return transport_lib.tree_map(comb, *grads)


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


def corrupt_local(grads: Any, key: torch.Tensor,
                  cfg: transport_lib.TransportConfig):
    """Pass a local gradient tree through the PHY on the gradients' device;
    returns ``(grads, stats)``."""
    leaves, _ = transport_lib.tree_flatten(grads)
    return transport_lib.transmit_pytree(grads, key, cfg,
                                         device=leaves[0].device)


def group_rank(group) -> int:
    """This process's rank in ``group`` (0 for ``None``, a world of one)."""
    return 0 if group is None else dist.get_rank(group)


def group_size(group) -> int:
    """The size of ``group`` (1 for ``None``)."""
    return 1 if group is None else dist.get_world_size(group)


def approx_allreduce(local_grads: Any, key: torch.Tensor,
                     cfg: transport_lib.TransportConfig, group=None):
    """Mean-reduce gradients over ``group`` with a noisy uplink.

    Each rank corrupts its contribution under ``fold_in(key, rank)``, then
    the float32 sum over the group is divided by its size (the
    reference's ``psum(g.astype(f32)) / mul``; a group of one returns the
    corrupted leaves cast to float32, and no copy where they are float32
    already). Returns ``(grads, stats)``: float32 leaves whatever the
    leaves' or the wire's dtype, so a caller needs no cast after it;
    ``stats`` are this rank's.
    """
    mul = group_size(group)
    with spans.span("keys"):
        # mesh-shard keyspace on a dedicated aggregation key (bounded by
        # the group size), not the round/client lane table:
        # lint: ignore[keylane]
        shard_key = prng.fold_in(key, group_rank(group))
    corrupted, stats = corrupt_local(local_grads, shard_key, cfg)

    def reduce(g):
        g = g.to(torch.float32)
        if mul == 1:  # x / 1 is x: no all-reduce and no copy
            return g
        g = g.contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return g / mul

    return transport_lib.tree_map(reduce, corrupted), stats
