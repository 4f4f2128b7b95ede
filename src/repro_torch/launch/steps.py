"""Step builders: train / train-approx (per-client uplink) / serve /
prefill (port of ``repro.launch.steps`` on ``torch.distributed``).

``make_train_step``        — plain step (baseline), with optional
                             per-shard uplink corruption of the gradient.
``make_train_step_approx`` — the paper's technique as a runtime feature:
                             each rank of the data group computes its
                             cohort's gradient, corrupts it through the
                             simulated PHY with its own channel, and the
                             PS aggregation is the all-reduce.
``make_serve_step``        — one-token greedy decode against a KV cache.
``make_prefill_step``      — full-sequence forward, last-position logits.

A train step takes the *global* batch (numpy or tensors) and each rank
takes its rows, as the reference's ``shard_map`` splits the batch over
the data axes; params and optimizer state are replicated. With
``mesh=None`` (or a world of one) a step is the whole batch on one
device, the reference's ``(1, 1)`` mesh. The plain train step and the
prefill and serve steps given a mesh run their forward inside
``models.moe.expert_group`` over the data group, so a moe config with
``moe_impl="expert_parallel"`` exchanges tokens with the expert owners
there (the reference's auto data axes); the per-client approx step does
not, as the reference's ``shard_map`` over Manual data axes takes the
dense dispatch. Inside a :func:`repro_torch.obs.spans.collect`
scope the approx step times its spans (the tree is in
``repro_torch/obs/spans.py``): the root ``step`` (id: the step's call
number) and its parts ``grad`` (forward and backward), ``uplink`` (the
wire cast and ``approx_allreduce``; its parts ``flatten``, ``keys``,
``kernel`` (K0 alone) and ``unflatten``) and ``apply``.
"""

from __future__ import annotations

import itertools

import torch
import torch.distributed as dist

from repro_torch.core import aggregation as agg_lib
from repro_torch.core import prng
from repro_torch.core import transport as transport_lib
from repro_torch.launch import sharding as sh
from repro_torch.models import moe as MOE
from repro_torch.models import registry as R
from repro_torch.obs import spans

__all__ = ["make_train_step", "corrupt_per_shard", "make_train_step_approx",
           "make_serve_step", "make_prefill_step", "value_and_grad"]


def _group(mesh):
    return None if mesh is None else getattr(mesh, "group", None)


def _device_of(params) -> torch.device:
    leaves, _ = transport_lib.tree_flatten(params)
    return leaves[0].device


def _local_batch(batch: dict, mesh, device) -> dict:
    """This rank's rows of the global batch, as tensors on ``device``."""
    group = _group(mesh)
    n, r = agg_lib.group_size(group), agg_lib.group_rank(group)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.shape[0] % n:
            raise ValueError(f"batch of {t.shape[0]} does not split over "
                             f"{n} ranks")
        b = t.shape[0] // n
        out[k] = t[r * b:(r + 1) * b].to(device)
    return out


def value_and_grad(cfg, params, batch):
    """``(loss, grads)`` of ``R.loss_fn`` at ``params``: grads in the
    params' tree and dtypes (the reference's ``jax.value_and_grad``). A
    leaf the loss does not read (the ``(0, ...)`` groups of a hybrid
    config shorter than one group) gets a zero gradient."""
    leaves, spec = transport_lib.tree_flatten(params)
    with torch.enable_grad():
        req = [l.detach().requires_grad_() for l in leaves]
        loss = R.loss_fn(transport_lib.tree_unflatten(spec, req), batch, cfg)
        grads = torch.autograd.grad(loss, req, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), transport_lib.tree_unflatten(spec, list(grads))


def _pmean(t: torch.Tensor, group) -> torch.Tensor:
    n = agg_lib.group_size(group)
    if n == 1:
        return t
    t = t.to(torch.float32).clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t / n


def make_train_step(cfg, opt, *, transport_cfg=None, mesh=None):
    """Plain step. Ranks average their gradients (the global-batch
    gradient); with ``transport_cfg`` the gradient then passes through
    :func:`corrupt_per_shard`. ``step(params, opt_state, batch, key) ->
    (params, opt_state, loss)``."""

    def step(params, opt_state, batch, key):
        group = _group(mesh)
        local = _local_batch(batch, mesh, _device_of(params))
        with MOE.expert_group(group):
            loss, grads = value_and_grad(cfg, params, local)
        loss = _pmean(loss, group)
        if agg_lib.group_size(group) > 1:
            grads = transport_lib.tree_map(
                lambda g: _pmean(g, group).to(g.dtype), grads)
        if transport_cfg is not None:
            grads = corrupt_per_shard(grads, key, transport_cfg, mesh)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return step


def _coords(mesh, rank: int) -> dict:
    """Mesh coordinates of ``rank`` (row-major over ``axis_names``)."""
    out = {}
    for a in reversed(mesh.axis_names):
        out[a] = rank % mesh.shape[a]
        rank //= mesh.shape[a]
    return out


def _block(shape, spec, mesh, rank: int) -> tuple:
    """The slices of a leaf that ``rank`` owns under ``spec``."""
    coords = _coords(mesh, rank)
    out = []
    for dim, axes in zip(shape, spec):
        if axes is None:
            out.append(slice(None))
            continue
        ax = (axes,) if isinstance(axes, str) else tuple(axes)
        idx, n = 0, 1
        for a in ax:
            idx = idx * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        b = dim // n
        out.append(slice(idx * b, (idx + 1) * b))
    return tuple(out)


def corrupt_per_shard(grads, key, transport_cfg, mesh):
    """Elementwise PHY corruption of each rank's gradient shard.

    On a world of one the whole tree is one shard: every leaf, flattened
    in sorted-key order into one payload under ``fold_in(key, 0)``. On a
    larger world rank ``r`` sends, under ``fold_in(key, r)``, the blocks
    of each leaf that ``param_rules(fsdp=True)`` gives it, in leaf order;
    the blocks are then gathered. A leaf that no data axis splits is
    corrupted on every rank, as every chip holding a copy does in the
    reference, and rank 0's copy is kept, so the ranks agree.
    """
    group = _group(mesh)
    n = agg_lib.group_size(group)
    dev = _device_of(grads)
    if n == 1:
        # mesh-shard keyspace on a dedicated per-shard key (bounded by
        # the mesh size), not the lane table: lint: ignore[keylane]
        return transport_lib.transmit_pytree(grads, prng.fold_in(key, 0),
                                             transport_cfg, device=dev)[0]
    rank = agg_lib.group_rank(group)
    leaves, spec = transport_lib.tree_flatten(grads)
    specs, _ = transport_lib.tree_flatten(
        sh.tree_specs(grads, None, mesh, fsdp=True))
    mine = [l[_block(l.shape, s, mesh, rank)] for l, s in zip(leaves, specs)]
    row, d = transport_lib.pack(mine, 0, transport_lib._pad_to(transport_cfg))
    # per-shard key, bounded by the mesh size: lint: ignore[keylane]
    shard_key = prng.fold_in(key, rank)
    row_hat, _ = transport_lib._transmit_row(row, d, shard_key,
                                             transport_cfg)
    out = []
    for leaf, s, part in zip(leaves, specs,
                             transport_lib.unpack(row_hat, mine)):
        parts = [torch.empty_like(part) for _ in range(n)]
        dist.all_gather(parts, part.contiguous(), group=group)
        full = torch.empty_like(leaf)
        for r in reversed(range(n)):  # rank 0 written last: its copy stays
            full[_block(leaf.shape, s, mesh, r)] = parts[r]
        out.append(full)
    return transport_lib.tree_unflatten(spec, out)


def make_train_step_approx(cfg, opt, transport_cfg, mesh=None):
    """Paper-faithful per-client uplink: each rank is one client cohort.

    ``step(params, opt_state, batch, key) -> (params, opt_state, loss,
    stats)``: value and grad on this rank's rows, the gradient cast to the
    wire dtype, :func:`aggregation.approx_allreduce` over the data group
    (rank ``r`` keyed ``fold_in(key, r)``; it returns float32 leaves),
    then ``opt.update``. The loss and the stats are averaged over the group.
    """
    wire = (torch.bfloat16 if transport_cfg.wire_dtype == "bfloat16"
            else torch.float32)

    calls = itertools.count()

    def step(params, opt_state, batch, key):
        with spans.span("step", device=True, id=next(calls)):
            return _step(params, opt_state, batch, key)

    def _step(params, opt_state, batch, key):
        group = _group(mesh)
        local = _local_batch(batch, mesh, _device_of(params))
        # the dense dispatch, as under the reference's Manual data axes
        with spans.span("grad", device=True), MOE.expert_group(None):
            loss, grads = value_and_grad(cfg, params, local)
        with spans.span("uplink", device=True):
            # grads travel (and all-reduce) in the wire dtype
            with spans.span("flatten", device=True):
                grads = transport_lib.tree_map(lambda g: g.to(wire), grads)
            grads, stats = agg_lib.approx_allreduce(grads, key,
                                                    transport_cfg, group)
        loss = _pmean(loss, group)
        for f in ("data_symbols", "transmissions", "bit_errors", "n_bits",
                  "bits_on_air"):
            v = getattr(stats, f)
            if v is not None:
                setattr(stats, f, _pmean(v, group))
        with spans.span("apply", device=True):
            params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss, stats

    return step


def make_serve_step(cfg, *, ring: bool = False, mesh=None):
    """``serve_step(params, cache, tokens, pos) -> (next_tok (B, 1) int32,
    cache)``: one decode step and its greedy token. With a ``mesh`` every
    rank of its group calls the step together on its own rows and cache,
    and expert-parallel moe layers exchange tokens over the group."""

    def serve_step(params, cache, tokens, pos):
        with MOE.expert_group(_group(mesh)):
            logits, cache = R.decode_step(params, cache, tokens, pos, cfg,
                                          ring=ring)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        return next_tok, cache

    return serve_step


def make_prefill_step(cfg, mesh=None):
    """``prefill_step(params, batch) -> last-position logits (B, V)``.
    With a ``mesh`` every rank of its group calls the step together on its
    own rows, and expert-parallel moe layers exchange tokens over the
    group."""

    @torch.no_grad()
    def prefill_step(params, batch):
        with MOE.expert_group(_group(mesh)):
            logits, _ = R.forward(params, batch, cfg)
        return logits[:, -1]

    return prefill_step

