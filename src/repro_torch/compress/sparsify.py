"""Gradient sparsification with error-feedback residual memory (port).

Counterpart of ``repro.compress.sparsify``. Every selection returns a
fixed-size ``(k,)`` value / index pair (``(M, k)`` batched), indices
ascending, the canonical wire order:

* ``topk`` — the ``k`` largest-|value| coordinates. The reference orders
  candidates with ``jnp.lexsort((arange, -|x|))``: equal magnitudes go to
  the lower index. ``torch.topk`` fixes no tie order, so this is a stable
  ``torch.sort`` of ``-|x|``. jax's sort treats ``-0.0`` as ``0.0`` (here
  every zero key is ``-0.0`` already) and puts every NaN last, in index
  order; the sort key here maps NaN to ``+inf``, which every other key
  (``-|x| <= 0``) precedes, so a NaN coordinate is never selected ahead of
  a finite one, on the CPU and on the card alike;
* ``randk`` — the first ``k`` of ``prng.permutation(key, dim)``, sorted;
* ``threshold`` — top-``k`` slots, with selected values under the
  magnitude floor sent as zero.

Error feedback: ``acc = residual + grad``; the new residual is ``acc``
minus the transmitter-side scatter of the sent values, so ``scatter(values)
+ residual == acc`` bit for bit, and a dropped client (``active = 0``)
keeps its whole accumulation. Batched functions are written over the
client axis directly; a batch row equals the single-client call bit for
bit.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import keylanes
from repro_torch.core import prng

__all__ = [
    "SELECT_KEY_LANE",
    "CompressionConfig",
    "resolve_k",
    "select_topk",
    "select_randk",
    "select_threshold",
    "select",
    "select_batch",
    "scatter_dense",
    "scatter_dense_batch",
    "ef_select",
    "ef_select_batch",
    "selection_keys",
]

SELECT_KEY_LANE = keylanes.SELECT_KEY_LANE


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """How a client compresses its uplink payload before the sparse wire.

    ``method`` is ``"topk"``, ``"randk"`` or ``"threshold"``; ``k`` (or
    ``max(1, round(ratio * dim))``) coordinates go out per client per
    round; ``threshold`` is the magnitude floor of ``"threshold"``;
    ``error_feedback`` keeps the untransmitted remainder; ``header`` is how
    the index header rides the wire (``"gray"``, ``"ecrt"`` or
    ``"perfect"``), priced with ``header_ecrt_expected_tx`` or the real
    chain (``header_simulate_fec``).
    """

    method: str = "topk"  # topk | randk | threshold
    ratio: float = 0.02
    k: int | None = None
    threshold: float = 0.0
    error_feedback: bool = True
    header: str = "gray"  # gray | ecrt | perfect
    header_ecrt_expected_tx: float = 1.0
    header_simulate_fec: bool = False

    def __post_init__(self):
        if self.method not in ("topk", "randk", "threshold"):
            raise ValueError(
                f"unknown compression method {self.method!r}; "
                "use topk|randk|threshold")
        if self.header not in ("gray", "ecrt", "perfect"):
            raise ValueError(
                f"unknown header protection {self.header!r}; "
                "use gray|ecrt|perfect")
        if self.k is None and not 0.0 < self.ratio <= 1.0:
            raise ValueError(f"ratio must be in (0, 1], got {self.ratio}")
        if self.k is not None and self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")


def resolve_k(cfg: CompressionConfig, dim: int) -> int:
    """The per-client slot budget for a ``dim``-coordinate payload (an
    explicit ``k`` wins; Python's half-even ``round`` otherwise)."""
    if cfg.k is not None:
        return min(int(cfg.k), dim)
    return max(1, min(dim, int(round(cfg.ratio * dim))))


def select_topk(x: torch.Tensor, k: int):
    """The ``k`` largest-|value| coordinates of ``x`` (``(..., dim)``),
    lower index first on ties, NaN last. Returns ``(values, indices)``,
    indices ascending (``int64``)."""
    key = -x.abs()
    key = torch.where(torch.isnan(key), torch.inf, key)
    order = torch.sort(key, dim=-1, stable=True).indices
    idx = torch.sort(order[..., :k], dim=-1).values
    return torch.gather(x, -1, idx), idx


def select_randk(x: torch.Tensor, k: int, key: torch.Tensor):
    """A keyed uniform ``k``-subset (without replacement): the first ``k``
    entries of ``permutation(key, dim)``, sorted; ``key`` is ``(2,)`` or
    one key per row of ``x``. Independent of the values."""
    perm = prng.permutation(key.to(x.device), x.shape[-1])
    idx = torch.sort(perm[..., :k], dim=-1).values
    return torch.gather(x, -1, idx), idx


def select_threshold(x: torch.Tensor, k: int, threshold: float):
    """Top-``k`` slots under a magnitude floor: selected values below
    ``threshold`` transmit zero (the slot stays on the wire, and error
    feedback keeps the value)."""
    vals, idx = select_topk(x, k)
    return torch.where(vals.abs() >= threshold, vals, 0.0), idx


def select(x: torch.Tensor, k: int, cfg: CompressionConfig, key=None):
    """Dispatch one client's selection by ``cfg.method`` (``key`` is needed
    by ``randk`` only; see :func:`selection_keys`)."""
    if cfg.method == "topk":
        return select_topk(x, k)
    if cfg.method == "randk":
        if key is None:
            raise ValueError("method='randk' needs a selection key")
        return select_randk(x, k, key)
    return select_threshold(x, k, cfg.threshold)


def select_batch(x: torch.Tensor, k: int, cfg: CompressionConfig, keys=None):
    """Per-client selection over a ``(M, dim)`` matrix (``keys``: ``(M, 2)``
    for ``randk``). Returns ``(values, indices)``, each ``(M, k)``."""
    if cfg.method == "randk" and keys is None:
        raise ValueError("method='randk' needs per-client selection keys")
    return select(x, k, cfg, keys)


def scatter_dense(values: torch.Tensor, indices: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """``(..., k)`` values added into zeros ``(..., dim)`` at ``indices``
    (the transmitter-side scatter; a selection never repeats an index)."""
    out = torch.zeros(values.shape[:-1] + (dim,), dtype=values.dtype,
                      device=values.device)
    return out.scatter_add_(-1, indices, values)


def scatter_dense_batch(values: torch.Tensor, indices: torch.Tensor,
                        dim: int) -> torch.Tensor:
    """Batched :func:`scatter_dense`: ``(M, k)`` pairs -> ``(M, dim)``."""
    return scatter_dense(values, indices, dim)


def ef_select(residual, grad, k: int, cfg: CompressionConfig, key=None,
              active=None):
    """One client's error-feedback step: ``(values, indices,
    new_residual)``, with ``scatter(values) + new_residual == residual +
    grad`` bit for bit (zeros when ``error_feedback`` is off). ``active``
    0 keeps the whole accumulation."""
    acc = residual + grad if cfg.error_feedback else grad
    vals, idx = select(acc, k, cfg, key)
    if not cfg.error_feedback:
        return vals, idx, torch.zeros_like(residual)
    sent = scatter_dense(vals, idx, acc.shape[-1])
    if active is not None:
        sent = sent * torch.as_tensor(active, dtype=sent.dtype).to(
            sent.device)
    return vals, idx, acc - sent


def ef_select_batch(residual, grads, k: int, cfg: CompressionConfig,
                    keys=None, active=None):
    """Batched :func:`ef_select` over ``(M, dim)`` matrices; ``active`` is
    an optional ``(M,)`` 0/1 vector. Returns ``(values (M, k), indices
    (M, k), new_residual (M, dim))``."""
    if cfg.method == "randk" and keys is None:
        raise ValueError("method='randk' needs per-client selection keys")
    if active is not None:
        active = torch.as_tensor(active, dtype=torch.float32).to(
            grads.device)[:, None]
    return ef_select(residual, grads, k, cfg, keys, active)


def selection_keys(key: torch.Tensor, num_clients: int,
                   offset: int = 0) -> torch.Tensor:
    """Per-client rand-k keys ``fold_in(fold_in(key, offset + i),
    SELECT_KEY_LANE)``: from the client transport key, so every dispatch
    selects the same subset. ``(num_clients, 2)``."""
    keylanes.check_range(offset, num_clients)
    idx = torch.arange(num_clients, dtype=torch.int64,
                       device=key.device) + offset
    return prng.fold_in(prng.fold_in(key, idx), SELECT_KEY_LANE)
