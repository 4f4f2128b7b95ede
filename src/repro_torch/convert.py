"""Carry parameters across from the JAX package.

The two packages draw He-init normals through different ``erfinv``
routines, so their random inits differ by a few ULP. Tests that must
start both from identical weights hand the reference's parameters over
as numpy arrays (``{name: np.asarray(leaf)}``) through
:func:`params_from_jax`. The port keeps the reference's layouts (conv
OIHW, FC ``(in, out)``), so the conversion is a copy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy"]


def params_from_jax(params: dict, device=None) -> dict:
    """``{name: numpy array}`` (the reference's CNN params) -> port params:
    float32 tensors of the same shapes on ``device`` (default: the CPU)."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in params.items()}


def params_to_numpy(params: dict) -> dict:
    """Port params -> ``{name: numpy float32 array}``."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
