"""Carry parameters across from the JAX package.

The two packages draw init normals through different ``erfinv``
routines, so their random inits can differ by a few ULP. Tests that must
start both from identical weights hand the reference's parameters over
as numpy arrays through :func:`params_from_jax`: a dict (nested dicts
allowed, as the transformer's tree) of ``np.asarray(leaf)``. The port
keeps the reference's layouts (conv OIHW, FC and projection weights
``(in, out)``, stacked layer leaves ``(L, ...)``), so the conversion is a
copy. bfloat16 leaves stay bfloat16 (through float32, which holds every
bfloat16 value exactly); every other leaf becomes float32.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_numpy"]


def _leaf_from_numpy(v, device) -> torch.Tensor:
    a = np.asarray(v)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def params_from_jax(params: dict, device=None) -> dict:
    """``{name: numpy array or nested dict}`` (the reference's params) ->
    port params of the same tree and shapes on ``device`` (default: the
    CPU)."""
    return {k: (params_from_jax(v, device) if isinstance(v, dict)
                else _leaf_from_numpy(v, device))
            for k, v in params.items()}


def params_to_numpy(params: dict) -> dict:
    """Port params -> the same tree of numpy float32 arrays (bfloat16
    leaves widened exactly)."""
    return {k: (params_to_numpy(v) if isinstance(v, dict)
                else v.detach().cpu().to(torch.float32).numpy()
                if v.dtype == torch.bfloat16 else v.detach().cpu().numpy())
            for k, v in params.items()}
