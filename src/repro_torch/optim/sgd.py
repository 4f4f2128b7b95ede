"""SGD — the paper's optimizer (FedSGD, eq. (6): w <- w - eta g).

Counterpart of ``repro.optim.sgd`` on parameter trees of tensors (dicts
and lists, as the models' trees). The update runs in float32 and casts
back to each parameter's dtype, as the reference's. ``sgd`` keeps its
step as a Python int; ``momentum_sgd`` keeps an int32 counter and a
float32 momentum tree, with ``beta`` rounded once to float32 (a jnp weak
type) and ``beta * m + g`` a multiply then an add: eager jnp rounds both,
as the port does, where jitted XLA on the CPU contracts them into an fma
(``tests/test_torch_optim.py`` states both bounds).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.transport import tree_map

__all__ = ["Optimizer", "sgd", "momentum_sgd"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An ``(init, update)`` pair; ``update(grads, state, params)``
    returns ``(new_params, new_state)``."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def sgd(lr) -> Optimizer:
    """Plain SGD with a constant or step-indexed learning rate."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"step": 0}

    def update(grads, state, params):
        eta = lr_fn(state["step"])
        new = tree_map(lambda p, g: (p.to(torch.float32)
                                     - eta * g.to(torch.float32)).to(p.dtype),
                       params, grads)
        return new, {"step": state["step"] + 1}

    return Optimizer(init, update)


def momentum_sgd(lr, beta: float = 0.9) -> Optimizer:
    """Heavy-ball SGD: ``mu <- beta * mu + g``, ``p <- p - eta * mu``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32),
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params)}

    def update(grads, state, params):
        eta = lr_fn(state["step"])
        mu = tree_map(lambda m, g: beta * m + g.to(torch.float32),
                      state["mu"], grads)
        new = tree_map(lambda p, m: (p.to(torch.float32)
                                     - eta * m).to(p.dtype), params, mu)
        return new, {"step": state["step"] + 1, "mu": mu}

    return Optimizer(init, update)
