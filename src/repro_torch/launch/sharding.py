"""Sharding rules + the sharded multi-client uplink (port of
``repro.launch.sharding`` on ``torch.distributed``).

``shard_transmit_batch`` scales ``transport.transmit_batch`` across the
ranks of a process group: the client dim is split over the data axes,
each rank runs the batched PHY on its cohort with *globally indexed*
fold_in keys (``client_offset = rank * local_clients``), and the rows are
gathered back, so the result equals the unsharded batch bit for bit
whatever the world size.

The spec rules are pure functions of a path, a shape, the config and a
mesh description (``launch.mesh.Mesh``, or any object with
``axis_names`` and a ``shape`` mapping, such as a test's fake mesh). A
spec is a tuple with one entry per dimension: ``None`` (replicated), an
axis name, or a tuple of names — the entries of the reference's
``PartitionSpec``. Rules are path-pattern based and divisibility-checked:
an axis whose size does not divide its dim is dropped for that dim.
Strategy (the reference's):

* tensor parallelism over ``model`` on head/FFN/expert-inner dims;
* FSDP over the data axes on the other matmul dim, when ``fsdp``;
* the MoE expert dim over the data axes (expert parallelism);
* batch dims of inputs/caches over the data axes; KV-cache heads over
  ``model`` when divisible, else the sequence dim.
"""

from __future__ import annotations

import math
import re
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core import aggregation as agg_lib
from repro_torch.core import transport as transport_lib
from repro_torch.launch.mesh import data_axes

__all__ = [
    "shard_transmit_batch", "shard_transmit_batch_adaptive",
    "normalize_path", "leaf_name", "checked_spec", "param_rules",
    "tree_specs", "batch_specs", "cache_specs",
]

Axis = Any  # str | tuple[str, ...] | None


def _cohort(mesh, axis_names, num_clients: int):
    """``(rank, n_shards, local_clients)`` of this process, or ``None``
    when there is nothing to shard over."""
    axes = tuple(axis_names) if axis_names is not None else data_axes(mesh)
    n_shards = math.prod(mesh.shape[a] for a in axes) if axes else 1
    if n_shards == 1:
        return None
    if getattr(mesh, "group", None) is None:
        raise ValueError(f"a mesh of {n_shards} data shards needs a process "
                         "group")
    if num_clients % n_shards != 0:
        raise ValueError(
            f"{num_clients} clients do not shard evenly over {n_shards} ranks")
    return agg_lib.group_rank(mesh.group), n_shards, num_clients // n_shards


def _gather_rows(t, group, n_shards: int):
    """Concatenate each rank's rows of ``t`` in rank order."""
    parts = [torch.empty_like(t) for _ in range(n_shards)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def _gather(x_hat, stats, group, n_shards: int):
    x_hat = _gather_rows(x_hat, group, n_shards)
    for f in ("data_symbols", "transmissions", "bit_errors", "n_bits",
              "bits_on_air", "mode_idx"):
        v = getattr(stats, f)
        if v is not None:
            setattr(stats, f, _gather_rows(v, group, n_shards))
    return x_hat, stats


def shard_transmit_batch(x, key, cfg, mesh, *, axis_names=None, snr_db=None,
                         device=None):
    """The batched uplink with the client dim split over the ranks.

    Args:
      x: the global ``(num_clients, N)`` payload, the same on every rank;
        ``num_clients`` must divide over the data shards.
      key: base PRNG key. Client ``i`` (global index) uses
        ``fold_in(key, i)``, so sharded == unsharded bit for bit.
      cfg: ``transport.TransportConfig``.
      mesh: a ``launch.mesh.Mesh``; ``axis_names`` defaults to every axis
        except ``model``.
      snr_db: optional per-client ``(num_clients,)`` SNR or a scalar.
      device: where each rank runs; ``None`` is its GPU.

    Returns ``(x_hat, stats)`` as ``transport.transmit_batch``: the global
    ``(num_clients, N)`` outputs and per-client ``TxStats`` on every rank.
    """
    x = torch.as_tensor(x)
    cohort = _cohort(mesh, axis_names, x.shape[0])
    if cohort is None:
        return transport_lib.transmit_batch(x, key, cfg, snr_db=snr_db,
                                            device=device)
    rank, n_shards, lc = cohort
    lo, hi = rank * lc, (rank + 1) * lc
    snr_vec = transport_lib._resolve_batch_snr(cfg, x.shape[0], snr_db,
                                               x.device)
    x_hat, stats = transport_lib.transmit_batch(
        x[lo:hi], key, cfg,
        snr_db=None if snr_vec is None else snr_vec[lo:hi],
        client_offset=lo, device=device)
    return _gather(x_hat, stats, mesh.group, n_shards)


def shard_transmit_batch_adaptive(x, key, cfgs, mode_idx, mesh, *,
                                  axis_names=None, snr_db=None, device=None):
    """Sharded mixed-mode uplink: the client dim split over the ranks.

    Each rank runs ``transport.transmit_batch_adaptive`` on its cohort with
    globally indexed fold_in keys and ``dispatch="select"``, as the
    reference's traced per-shard body must. ``use_kernel`` rows are
    cleared up front, as the reference clears them, so the result equals
    the unsharded call on the kernel-cleared table bit for bit (received
    payloads and per-client ``TxStats``, ``mode_idx`` included).
    """
    cfgs = transport_lib.clear_kernel_rows(cfgs)
    x = torch.as_tensor(x)
    cohort = _cohort(mesh, axis_names, x.shape[0])
    if cohort is None:
        return transport_lib.transmit_batch_adaptive(
            x, key, cfgs, mode_idx, snr_db=snr_db, device=device)
    rank, n_shards, lc = cohort
    lo, hi = rank * lc, (rank + 1) * lc
    snr_vec = transport_lib._resolve_batch_snr(cfgs[0], x.shape[0], snr_db,
                                               x.device)
    mode = torch.as_tensor(mode_idx).reshape(-1)
    x_hat, stats = transport_lib.transmit_batch_adaptive(
        x[lo:hi], key, cfgs, mode[lo:hi],
        snr_db=None if snr_vec is None else snr_vec[lo:hi],
        client_offset=lo, dispatch="select", device=device)
    return _gather(x_hat, stats, mesh.group, n_shards)


def normalize_path(keystr: str) -> str:
    """``"['layers']['attn']['wq']"`` or ``"layers/attn/wq"`` ->
    ``"layers/attn/wq"``."""
    return "/".join(re.findall(r"[A-Za-z_0-9]+", keystr)).lower()


def leaf_name(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def _fits(shape_dim: int, axes: Axis, mesh) -> bool:
    if axes is None:
        return True
    ax = (axes,) if isinstance(axes, str) else axes
    n = math.prod(mesh.shape[a] for a in ax)
    return shape_dim % n == 0 and shape_dim >= n


def _entry(axes: Axis) -> Axis:
    """A spec entry as ``PartitionSpec`` keeps it: a one-name tuple is the
    name."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def checked_spec(shape, axes_per_dim, mesh) -> tuple:
    """Drop axes on dims where divisibility fails."""
    return tuple(_entry(axes) if _fits(dim, axes, mesh) else None
                 for dim, axes in zip(shape, axes_per_dim))


def param_rules(path: str, shape, cfg, mesh, *, fsdp: bool) -> tuple:
    """The spec of one parameter (the reference's rules, leaf by leaf)."""
    d = data_axes(mesh)
    F = d if fsdp else None  # FSDP axis group
    low = normalize_path(path)

    def spec(*axes_per_dim):
        return checked_spec(shape, axes_per_dim, mesh)

    # The embedding table is replicated (the reference works around an XLA
    # gather-partitioning crash this way); the lm_head stays sharded.
    if "pos_embed" in low:
        return spec(None, None)
    if "embed" in low:
        return spec(None, None)
    if "lm_head" in low or "vision_proj" in low:
        return spec(F, "model")
    # MoE
    if "router" in low:
        return spec(*([None] * (len(shape) - 2)), None, None)
    if "shared" in low:  # shared-expert MLP, stacked (L, D, Fs)/(L, Fs, D)
        if leaf_name(low) in ("wi", "wg"):
            return spec(None, F, "model") if len(shape) == 3 else spec(F, "model")
        return spec(None, "model", F) if len(shape) == 3 else spec("model", F)
    if "moe" in low and leaf_name(low) in ("wi", "wg"):
        # (L, E, D, F): experts over data axes (expert parallel), F over model
        return spec(None, d, None, "model") if len(shape) == 4 else spec(d, None, "model")
    if "moe" in low and leaf_name(low) == "wo":
        return spec(None, d, "model", None) if len(shape) == 4 else spec(d, "model", None)
    # attention & dense mlp (stacked (L, in, out) or flat (in, out))
    two = {"wq", "wk", "wv", "wi", "wg", "w_x", "w_gate", "w_r", "w_i",
           "in_proj", "dt_proj"}
    back = {"wo", "w_out", "out_proj"}
    leaf = leaf_name(low)
    if leaf in two:
        return spec(None, F, "model") if len(shape) == 3 else spec(F, "model")
    if leaf in back:
        return spec(None, "model", F) if len(shape) == 3 else spec("model", F)
    if leaf == "x_proj":  # (L, Di, R+2N): Di is model-sharded upstream
        return spec(None, "model", None) if len(shape) == 3 else spec("model", None)
    if leaf in ("a_log", "d_skip"):
        if len(shape) == 3:
            return spec(None, "model", None)
        return spec("model", None) if len(shape) == 2 else spec("model")
    if leaf == "conv_w":
        return spec(*([None] * (len(shape) - 1)), "model")
    if leaf in ("bq", "bk", "bv", "bi", "bo", "conv_b", "dt_bias", "lam"):
        if len(shape) == 2:
            return spec(None, "model")
        return spec("model") if _fits(shape[-1], "model", mesh) else (None,)
    # norms, biases, everything else: replicated
    return (None,) * len(shape)


def _map_with_path(fn, tree, prefix=""):
    """``fn(path, leaf)`` over a tree of dicts and lists; a path is the
    keys and list indices joined by ``/`` (``tail/0/rec/w_x``), as
    :func:`normalize_path` reads the reference's ``keystr``."""
    def sub(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, sub(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def tree_specs(tree, cfg, mesh, *, fsdp: bool):
    """The spec tree of a param(-like) tree: leaves need only ``shape``."""
    return _map_with_path(
        lambda path, leaf: param_rules(path, tuple(leaf.shape), cfg, mesh,
                                       fsdp=fsdp), tree)


def batch_specs(cfg, shape_cfg, mesh) -> dict:
    """Specs of the input batch dict."""
    d = data_axes(mesh)
    B = shape_cfg.global_batch
    bdim = _entry(d) if _fits(B, d, mesh) else None
    specs = {"tokens": (bdim, None)}
    if shape_cfg.kind == "train":
        specs["labels"] = (bdim, None)
    if cfg.family == "vlm" and shape_cfg.kind in ("train", "prefill"):
        specs["patch_embeds"] = (bdim, None, None)
    if cfg.family == "audio" and shape_cfg.kind in ("train", "prefill"):
        specs["frames"] = (bdim, None, None)
    return specs


def cache_specs(cfg, shape_cfg, mesh, cache_tree) -> Any:
    """Cache specs: batch over the data axes; heads over ``model`` if
    divisible, else the sequence/window dim; SSM inner dim over
    ``model``. Leaves need only ``shape``."""
    d = data_axes(mesh)

    def one(path, leaf):
        pstr = normalize_path(path)
        s = tuple(leaf.shape)
        if "conv" in pstr and cfg.family == "ssm":  # (L,B,K-1,Di)
            return checked_spec(s, (None, d, None, "model"), mesh)
        if pstr.endswith("/h") and len(s) == 4:  # ssm state (L,B,Di,N)
            return checked_spec(s, (None, d, "model", None), mesh)
        if pstr.endswith("/h") and len(s) == 3:  # rglru state (G,B,W)
            return checked_spec(s, (None, d, "model"), mesh)
        if pstr.endswith("/h") and len(s) == 2:  # rglru tail state (B,W)
            return checked_spec(s, (d, "model"), mesh)
        if "conv" in pstr and len(s) == 4:  # rglru conv (G,B,3,W)
            return checked_spec(s, (None, d, None, "model"), mesh)
        if "conv" in pstr and len(s) == 3:  # rglru tail conv (B,3,W)
            return checked_spec(s, (d, None, "model"), mesh)
        if len(s) == 5:  # (L,B,S,KVH,hd)
            if _fits(s[3], "model", mesh):
                return checked_spec(s, (None, d, None, "model", None), mesh)
            return checked_spec(s, (None, d, "model", None, None), mesh)
        if len(s) == 4:  # per-block (B,S,KVH,hd)
            if _fits(s[2], "model", mesh):
                return checked_spec(s, (d, None, "model", None), mesh)
            return checked_spec(s, (d, "model", None, None), mesh)
        return (None,) * len(s)

    return _map_with_path(one, cache_tree)
