"""Learning-rate schedules (step -> float32 lr), port of
``repro.optim.schedules``.

A schedule takes the step as a Python int or an integer tensor (the
optimizers' int32 counter) and returns a 0-d float32 tensor on the step's
device (the CPU for an int). The arithmetic is the reference's, with each
Python-float constant rounded once to float32 as jnp's weak types round
it: ``pi * t`` is ``float32(pi) * t``, ``1 - final_frac`` is rounded
after the subtraction in float64. ``torch.cos`` and XLA's ``cos`` may
differ in the last place (``tests/test_torch_optim.py`` states the bound).
"""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine", "warmup_cosine"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32)


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def constant(lr: float):
    """``step -> float32(lr)``."""
    return lambda step: _f32(lr, _step(step).device)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    """Cosine decay from ``lr`` to ``final_frac * lr`` over
    ``total_steps``, flat after."""

    def fn(step):
        s = _step(step)
        t = torch.minimum(s.to(torch.float32) / total_steps,
                          _f32(1.0, s.device))
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return _f32(lr, s.device) * (final_frac + (1 - final_frac) * cos)

    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then :func:`cosine` over the
    remaining ``total_steps - warmup``."""
    base = cosine(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        s = _step(step)
        w = torch.minimum(s.to(torch.float32) / max(warmup, 1),
                          _f32(1.0, s.device))
        return w * base(torch.clamp(s - warmup, min=0))

    return fn
