"""SGD — the paper's optimizer (FedSGD, eq. (6): w <- w - eta g).

Counterpart of ``repro.optim.sgd.sgd`` on parameter dicts of tensors
(nested dicts allowed, as the transformer's tree). The update runs in
float32 and casts back to each parameter's dtype, as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.transport import tree_map

__all__ = ["Optimizer", "sgd"]


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
