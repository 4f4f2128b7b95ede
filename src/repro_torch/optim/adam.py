"""Adam (used by non-FL baselines; FedSGD itself is stateless SGD), port
of ``repro.optim.adam``.

The state is ``{"step": int32, "m": float32 tree, "v": float32 tree}``,
the update the reference's expression in float32, cast back to each
parameter's dtype last. Python-float constants (``b1``, ``1 - b1``,
``eps``) are rounded once to float32, as jnp's weak types are.
``b1 ** t`` is ``torch.pow`` of float32 values, which may differ from
XLA's ``pow`` in the last place (``tests/test_torch_optim.py`` states the
bound). Two shortcuts would change bits, so the update avoids them:
PyTorch divides a CUDA tensor by a CPU scalar as a multiply
by its reciprocal (the bias corrections move to the moments' device
first). And PyTorch's vectorised float32 ``sqrt`` on the CPU is not
correctly rounded, where XLA's is (but for subnormal inputs, which XLA
flushes) and the card's was on every value tried: the root is taken in
float64, whose rounding to float32 is the correctly rounded float32 root
(53 >= 2 * 24 + 2 bits), so the CPU, the card and the reference agree.
"""

from __future__ import annotations

import torch

from repro_torch.core.transport import tree_flatten, tree_map
from repro_torch.optim.sgd import Optimizer

__all__ = ["adam"]


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on any device."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam with a constant or step-indexed learning rate."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"step": torch.zeros((), dtype=torch.int32),
                "m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params):
        t = state["step"] + 1
        eta = lr_fn(state["step"])
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(
            g.to(torch.float32)), state["v"], grads)
        tf = t.to(torch.float32)
        dev = tree_flatten(grads)[0][0].device
        bc1 = (1 - torch.pow(b1, tf)).to(dev)
        bc2 = (1 - torch.pow(b2, tf)).to(dev)
        new = tree_map(
            lambda p, m_, v_: (p.to(torch.float32) - eta * (m_ / bc1)
                               / (_sqrt_rn(v_ / bc2) + eps)).to(p.dtype),
            params, m, v)
        return new, {"step": t, "m": m, "v": v}

    return Optimizer(init, update)
