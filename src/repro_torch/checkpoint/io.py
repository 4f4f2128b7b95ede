"""Checkpointing: param tree <-> ``arrays.npz`` + ``manifest.json`` (port
of ``repro.checkpoint.io``, the same format both ways).

``manifest["keys"]`` are the reference's flattened paths (``jax``'s
``"['layers']/['attn']/['wq']"``, ``"['tail']/[0]/['rec']/['lam']"``),
leaves in ``jax.tree_util`` order, array ``i`` stored as ``a{i}``. numpy
has no bfloat16, so the port writes a bfloat16 leaf as float32 (exact:
every bfloat16 is a float32), which the reference restores with
``astype``. It reads a bfloat16 leaf stored as
float32, or as the raw 2-byte words the reference's ``np.savez`` writes
(``|V2``, read as ``uint16`` bit patterns); both are exact.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.core import transport as transport_lib

__all__ = ["save", "restore", "tree_keys"]


def tree_keys(tree: Any) -> list:
    """The reference's manifest keys of a tree of dicts and lists: each
    leaf's path, ``['name']`` a dict key and ``[i]`` a list item, joined
    by ``/``."""
    def walk(t, prefix):
        if isinstance(t, dict):
            items = [(f"[{k!r}]", t[k]) for k in sorted(t)]
        elif isinstance(t, list):
            items = [(f"[{i}]", v) for i, v in enumerate(t)]
        else:
            return ["/".join(prefix)]
        return [key for name, v in items for key in walk(v, prefix + [name])]

    return walk(tree, [])


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def save(path: str, tree: Any, step: int = 0, extra: dict | None = None) -> None:
    """Write ``tree`` (dicts and lists of tensors, nested) to ``path/``."""
    os.makedirs(path, exist_ok=True)
    leaves, _ = transport_lib.tree_flatten(tree)
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"a{i}": _to_numpy(v) for i, v in enumerate(leaves)})
    manifest = {"step": step, "keys": tree_keys(tree), "extra": extra or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and a.dtype.kind == "V" and a.itemsize == 2:
        bits = torch.from_numpy(a.view(np.uint16).astype(np.int32))
        return (bits << 16).view(torch.float32).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.dtype)


def restore(path: str, like: Any) -> tuple[Any, int]:
    """Restore into the structure, dtypes and devices of ``like`` (shapes
    must match). Returns ``(tree, step)``."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    if manifest["keys"] != tree_keys(like):
        raise ValueError("checkpoint structure mismatch")
    leaves, spec = transport_lib.tree_flatten(like)
    out = []
    for i, v in enumerate(leaves):
        t = _from_numpy(data[f"a{i}"], v)
        if tuple(t.shape) != tuple(v.shape):
            raise ValueError(f"checkpoint leaf {manifest['keys'][i]} has shape "
                             f"{tuple(t.shape)}, expected {tuple(v.shape)}")
        out.append(t.to(v.device))
    return transport_lib.tree_unflatten(spec, out), manifest["step"]
