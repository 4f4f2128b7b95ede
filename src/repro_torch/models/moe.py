"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro.models.moe``, its dense dispatch).

The reference's steps, each kept:

  1. route: float32 softmax router, the top ``K`` experts of each token
     and their weights renormalised to sum to 1;
  2. sort the ``T * K`` assignments by expert id (stable);
  3. the position of each assignment in its expert's run, by a running
     max of the run starts (the reference's associative max-scan);
  4. scatter the tokens into an ``(E, C + 1, D)`` buffer; assignments past
     the capacity ``C`` land in column ``C``, a trash slot that is dropped;
  5. batched expert matmuls over ``(E, C, D)``;
  6. gather back, weight and sum into each token (dropped slots add 0).

A Switch-style load-balance auxiliary loss is returned beside the output.

Where the two packages' arithmetic meets:

* ``lax.top_k`` breaks ties toward the lower expert index; the port takes
  the first ``K`` of a stable descending ``torch.sort``, so equal
  probabilities route alike. ``jnp.argsort`` is stable, and so is the
  port's. Given the same probabilities the routing (``se``, ``st``,
  ``slot_c``, the drops) is the reference's bit for bit; the router
  matmul and softmax themselves agree only to rounding, so two experts
  whose probabilities nearly tie may be picked in the other order.
* XLA turns the aux loss's means (a division by the token count) into a
  multiply by the float32 reciprocal; the port multiplies by it too. The
  weights' ``topv / sum(topv)`` stays a division in both.
* The combine: the reference scatter-adds ``y[se, slot_c] * sw`` into
  zeros of ``x.dtype`` in update order, which is expert order. The port
  gathers each token's ``K`` contributions in that same order and sums
  them with ``K`` elementwise adds from zero, each rounded to
  ``x.dtype``: no atomics, so the sum and its backward (gathers and the
  sort-based accumulate of ``index_put``) are the same on every run
  under deterministic algorithms.

``moe_impl="expert_parallel"`` is :func:`moe_ffn_shardmap`, the
reference's expert-parallel dispatch over a ``torch.distributed`` group:
each rank routes its own tokens, a pair of ``all_to_all`` exchanges carries
the ``(E, C, D)`` buffers to and from the ranks that own the experts, and
each rank runs ``E / n`` experts. The group comes from the
:func:`expert_group` scope that the data-parallel steps open
(``launch/steps.py``): the reference's auto data axes. Outside such a
scope, in a world of one, or where ``E`` does not split over the ranks,
it is the dense dispatch, as in the reference.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models import layers as L

__all__ = ["init_moe", "capacity", "moe_ffn", "moe_ffn_shardmap",
           "expert_group", "current_expert_group"]


def init_moe(key, cfg, dtype):
    """Router (float32), stacked expert weights ``(E, D, F)`` / ``(E, F,
    D)`` and, with ``n_shared_experts``, the shared expert's SwiGLU, in the
    reference's draw order."""
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    ks = prng.split(key, 5)
    p = {
        "router": L.dense_init(ks[0], (D, E), dtype=torch.float32),
        "wi": L.dense_init(ks[1], (E, D, Fd), in_axis=-2, dtype=dtype),
        "wg": L.dense_init(ks[2], (E, D, Fd), in_axis=-2, dtype=dtype),
        "wo": L.dense_init(ks[3], (E, Fd, D), in_axis=-2, dtype=dtype),
    }
    if cfg.n_shared_experts:
        Fs = cfg.moe_d_ff * cfg.n_shared_experts
        kk = prng.split(ks[4], 3)
        p["shared"] = {
            "wi": L.dense_init(kk[0], (D, Fs), dtype=dtype),
            "wg": L.dense_init(kk[1], (D, Fs), dtype=dtype),
            "wo": L.dense_init(kk[2], (Fs, D), dtype=dtype),
        }
    return p


def capacity(n_tokens: int, cfg) -> int:
    """Slots per expert: ``T * K * capacity_factor / E + 1``, at least 8,
    never above the token count."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return min(max(c, 8), n_tokens)


def _local_dispatch(x2: torch.Tensor, p, cfg, C: int):
    """Route ``(T, D)`` tokens and scatter them into an ``(E, C, D)``
    buffer. Returns ``(buf, se, slot_c, st, sw, aux)``: the assignments in
    expert order (expert, capacity slot with ``C`` for a drop, token,
    weight) and the float32 aux loss."""
    T, D = x2.shape
    E, K = cfg.n_experts, cfg.top_k
    dev = x2.device
    logits = torch.matmul(x2.to(torch.float32), p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :K], topi[:, :K]
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)

    inv_t = 1.0 / T  # XLA's mean: a multiply by the float32 reciprocal
    density = torch.sum(F.one_hot(topi[:, 0], E).to(torch.float32),
                        dim=0) * inv_t
    mean_prob = torch.sum(probs, dim=0) * inv_t
    aux = E * torch.sum(density * mean_prob)

    flat_e = topi.reshape(-1)
    flat_t = torch.arange(T, dtype=torch.int64, device=dev).repeat_interleave(K)
    flat_w = topv.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]

    ar = torch.arange(T * K, dtype=torch.int64, device=dev)
    change = torch.ones_like(se, dtype=torch.bool)
    change[1:] = se[1:] != se[:-1]
    run_start = torch.cummax(torch.where(change, ar, 0), dim=0).values
    pos = ar - run_start
    slot_c = torch.where(pos < C, pos, C)
    buf = x2.new_zeros((E, C + 1, D)).index_put((se, slot_c), x2[st])
    return buf[:, :C], se, slot_c, st, sw, aux


def _combine(contrib: torch.Tensor, st: torch.Tensor, T: int, K: int,
             dtype) -> torch.Tensor:
    """``zeros((T, D), dtype).at[st].add(contrib)`` in update order.

    ``contrib`` is in expert order, so a token's rows, ascending, are its
    experts in ascending order; a stable ``argsort`` of ``st`` lists them
    so. Each token's ``K`` rows are summed from zero in that order, one
    elementwise add at a time, each rounded to ``dtype``."""
    rows = torch.argsort(st, stable=True).reshape(T, K)
    out = contrib.new_zeros((T, contrib.shape[1]), dtype=dtype)
    for j in range(K):
        out = out + contrib[rows[:, j]].to(dtype)
    return out


def moe_ffn(x: torch.Tensor, p, cfg):
    """``x (..., D) -> (out (..., D), aux_loss float32 scalar)``."""
    orig_shape = x.shape
    D = orig_shape[-1]
    x2 = x.reshape(-1, D)
    T = x2.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg)
    h, se, slot_c, st, sw, aux = _local_dispatch(x2, p, cfg, C)

    hi = torch.matmul(h, p["wi"])
    hg = torch.matmul(h, p["wg"])
    act = F.silu(hg.to(torch.float32)).to(hi.dtype) * hi
    y = torch.matmul(act, p["wo"])
    y = torch.cat([y, y.new_zeros((E, 1, D))], dim=1)

    contrib = y[se, slot_c] * sw[:, None].to(y.dtype)
    out = _combine(contrib, st, T, K, x.dtype)

    if cfg.n_shared_experts:
        s = p["shared"]
        out = out + L.swiglu(x2, s["wi"], s["wg"], s["wo"])
    return out.reshape(orig_shape), aux


# ------------------------------------------------------------------------
# Expert-parallel dispatch via all_to_all (the reference's
# ``moe_ffn_shardmap``): tokens are routed locally on each data rank,
# exchanged with the expert-owner ranks by a pair of all_to_alls, and each
# rank runs only its E / n experts. The port holds every parameter whole
# on each rank, so rank r uses the slice [r E / n, (r + 1) E / n) of the
# stacked expert weights.
# ------------------------------------------------------------------------

_GROUP = contextvars.ContextVar("repro_torch_expert_group", default=None)


@contextlib.contextmanager
def expert_group(group):
    """Within this scope the moe layers of ``moe_impl="expert_parallel"``
    exchange tokens over ``group`` (the data ranks; ``None`` is a world of
    one). The train, prefill and serve steps open it; the per-client
    approx step does not, as the reference's per-client ``shard_map``
    makes its data axes Manual and so takes the dense dispatch."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def current_expert_group():
    """The group of the innermost :func:`expert_group` scope, or ``None``.
    The transformer reads it when a forward starts and hands it to each
    layer, so a layer's recomputation under ``checkpoint`` (during the
    backward pass, outside the scope) takes the same dispatch."""
    return _GROUP.get()


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` on equal chunks of dim 0: chunk ``j`` goes to
    rank ``j``, and chunk ``j`` of the result came from rank ``j``. The
    exchange is its own transpose, so the backward pass sends the
    gradients back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def _all_to_all(x, group):
    # contiguous first: empty_like keeps a permuted input's strides, and
    # the collective reads and writes both buffers as contiguous
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _PMean(torch.autograd.Function):
    """The mean over the group (the reference's ``pmean``); its gradient is
    passed to the local value unchanged, because the data-parallel step
    averages the ranks' gradients, which is ``pmean``'s own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().to(torch.float32).clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def moe_ffn_shardmap(x: torch.Tensor, p, cfg, group=None):
    """Expert-parallel MoE over ``group``: ``(B, S, D)`` of this rank's
    rows -> ``(out, aux)``, ``aux`` the mean over the ranks. The dense
    dispatch (:func:`moe_ffn`) where the reference takes it: no group, a
    group of one rank, ``n_experts`` not a multiple of the group's size,
    or an input that is not ``(B, S, D)``.

    Per rank: route its ``T = B * S`` tokens at the local capacity
    ``capacity(T)``; send expert block ``j`` of the ``(E, C, D)`` buffer to
    rank ``j`` and receive its tokens for this rank's experts, ``(E / n,
    n * C, D)``; the expert matmuls and the SiLU gate in float32, cast
    back to the model dtype; the reverse exchange; the combine through the
    trash column. The shared expert stays outside the exchange.
    """
    nd = 1 if group is None else dist.get_world_size(group)
    E = cfg.n_experts
    if nd == 1 or E % nd != 0 or x.ndim != 3:
        return moe_ffn(x, p, cfg)
    B, S, D = x.shape
    E_loc = E // nd
    r = dist.get_rank(group)
    x2 = x.reshape(-1, D)
    T, K = x2.shape[0], cfg.top_k
    C = capacity(T, cfg)
    buf, se, slot_c, st, sw, aux = _local_dispatch(
        x2, {"router": p["router"]}, cfg, C)
    # to the expert owners: (E, C, D) -> (E / n, n * C, D), rank j's
    # tokens for expert e at [e, j * C:(j + 1) * C]
    h = _AllToAll.apply(buf.reshape(nd, E_loc, C, D), group)
    h = h.permute(1, 0, 2, 3).reshape(E_loc, nd * C, D)
    mine = slice(r * E_loc, (r + 1) * E_loc)
    h32 = h.to(torch.float32)
    hi = torch.matmul(h32, p["wi"][mine].to(torch.float32))
    hg = torch.matmul(h32, p["wg"][mine].to(torch.float32))
    act = F.silu(hg) * hi
    y = torch.matmul(act, p["wo"][mine].to(torch.float32)).to(h.dtype)
    # back to the token owners: (E / n, n * C, D) -> (E, C, D)
    y = y.reshape(E_loc, nd, C, D).permute(1, 0, 2, 3)
    y_loc = _AllToAll.apply(y, group).reshape(E, C, D)
    y_pad = torch.cat([y_loc, y_loc.new_zeros((E, 1, D))], dim=1)
    contrib = y_pad[se, slot_c] * sw[:, None].to(y_loc.dtype)
    out = _combine(contrib, st, T, K, x.dtype)
    aux = _PMean.apply(aux, group)
    if cfg.n_shared_experts:
        s_ = p["shared"]
        out = out + L.swiglu(x2, s_["wi"], s_["wg"], s_["wo"])
    return out.reshape(B, S, D), aux
