"""Carry parameters across from the JAX package.

The two packages draw init normals through different ``erfinv``
routines, so their random inits can differ by a few ULP. Tests that must
start both from identical weights hand the reference's parameters over
as numpy arrays through :func:`params_from_jax`: a tree of dicts and
lists (the hybrid transformer's ``tail`` is a list) of
``np.asarray(leaf)``. The port
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


def params_from_jax(params, device=None):
    """The reference's params as numpy arrays (dicts and lists, nested) ->
    port params of the same tree and shapes on ``device`` (default: the
    CPU)."""
    if isinstance(params, dict):
        return {k: params_from_jax(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_from_jax(v, device) for v in params]
    return _leaf_from_numpy(params, device)


def params_to_numpy(params):
    """Port params -> the same tree of numpy float32 arrays (bfloat16
    leaves widened exactly)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to_numpy(v) for v in params]
    t = params.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()
