"""Optimizers of the port (``(init, update)`` pairs over parameter
trees), as ``repro.optim`` exports them."""

from repro_torch.optim.sgd import sgd, momentum_sgd
from repro_torch.optim.adam import adam
from repro_torch.optim.schedules import constant, cosine, warmup_cosine

__all__ = ["sgd", "momentum_sgd", "adam", "constant", "cosine",
           "warmup_cosine"]
