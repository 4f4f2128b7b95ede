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

A config with ``n_experts_held`` (``configs/kimi_k2_instruct.py``; no
counterpart in the reference) takes :func:`moe_ffn_held` instead: the
sigmoid ``noaux_tc`` router over all ``n_experts``, the sequence-wise
balance loss, and only the held experts' part of the result, dropless.

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
import itertools

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models import layers as L
from repro_torch.obs import spans

__all__ = ["init_moe", "capacity", "moe_ffn", "moe_ffn_shardmap",
           "expert_group", "current_expert_group", "init_moe_held",
           "correction_bias", "route_noaux_tc", "seq_balance_loss",
           "moe_ffn_held"]


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


# ------------------------------------------------------------------------
# One expert-parallel rank's share (Kimi K2 / DeepSeek-V3): the router
# keeps all ``n_experts`` outputs; this chip computes the part of the
# result that its experts [expert_offset, expert_offset + n_experts_held)
# give, for every token routed to them, and the shared expert whole.
# ------------------------------------------------------------------------


def init_moe_held(key, cfg, dtype) -> dict:
    """Router (float32, ``(D, n_experts)``), the held experts' stacked
    SwiGLUs ``(Eh, D, F)`` / ``(Eh, F, D)`` and the shared expert's, in
    draw order ``split(key, 3)``: router ``<- ks[0]``; expert ``e``
    (of all ``n_experts``) ``<- split(ks[1], n_experts)[e] -> split(., 3)``
    for ``wi, wg, wo``, so a share holds the whole layer's experts;
    shared ``<- split(ks[2], 3)``."""
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    Eh, off = cfg.n_experts_held, cfg.expert_offset
    ks = prng.split(key, 3)
    ek = prng.split(ks[1], E)
    held = [prng.split(ek[off + j], 3) for j in range(Eh)]

    def stack(i, shape):
        return torch.stack([L.dense_init(k[i], shape, dtype=dtype)
                            for k in held])

    p = {
        "router": L.dense_init(ks[0], (D, E), dtype=torch.float32),
        "wi": stack(0, (D, Fd)),
        "wg": stack(1, (D, Fd)),
        "wo": stack(2, (Fd, D)),
    }
    if cfg.n_shared_experts:
        Fs = cfg.moe_d_ff * cfg.n_shared_experts
        kk = prng.split(ks[2], 3)
        p["shared"] = {
            "wi": L.dense_init(kk[0], (D, Fs), dtype=dtype),
            "wg": L.dense_init(kk[1], (D, Fs), dtype=dtype),
            "wo": L.dense_init(kk[2], (Fs, D), dtype=dtype),
        }
    return p


_BIAS_TAG = 0xB1A5
_BIAS_CACHE: dict = {}


def correction_bias(cfg, n_layers: int, device) -> torch.Tensor:
    """The router's correction bias ``(n_layers, n_experts)`` float32:
    ``normal(fold_in(PRNGKey(router_bias_seed), 0xB1A5)) *
    router_bias_std``, held fixed (its load-based update is no gradient
    and not on the uplink); made once a device."""
    k = (cfg.router_bias_seed, cfg.router_bias_std, n_layers, cfg.n_experts,
         str(device))
    if k not in _BIAS_CACHE:
        # a key of its own seed, outside the round and step key schedule:
        # lint: ignore[keylane]
        key = prng.fold_in(prng.PRNGKey(cfg.router_bias_seed,
                                        device=device), _BIAS_TAG)
        _BIAS_CACHE.clear()
        _BIAS_CACHE[k] = (prng.normal(key, (n_layers, cfg.n_experts))
                          * cfg.router_bias_std)
    return _BIAS_CACHE[k]


def route_noaux_tc(x2: torch.Tensor, router: torch.Tensor,
                   bias: torch.Tensor, cfg):
    """``(scores (T, E), sel (T, K), weights (T, K))``, float32: ``s =
    sigmoid(x W_r)`` (``scoring_func`` "softmax": a softmax), the top
    ``K`` of ``s + bias`` (one group: ``n_group = topk_group = 1``), and
    ``s[sel] / sum(s[sel]) * routed_scaling_factor``."""
    logits = torch.matmul(x2.to(torch.float32), router)
    if cfg.scoring_func == "sigmoid":
        s = torch.sigmoid(logits)
    else:
        s = torch.softmax(logits, dim=-1)
    sel = torch.topk(s + bias, cfg.top_k, dim=-1).indices
    ws = torch.gather(s, 1, sel)
    w = ws / ws.sum(dim=-1, keepdim=True) * cfg.routed_scaling_factor
    return s, sel, w


def seq_balance_loss(s: torch.Tensor, sel: torch.Tensor, B: int, S: int,
                     E: int) -> torch.Tensor:
    """The sequence-wise balance loss over all ``E`` experts, without its
    weight alpha: per sequence ``f_i = E / (K S) * sum_t 1[i in sel_t]``
    and ``P_i = 1/S * sum_t s_it / sum_j s_jt``; ``sum_i f_i P_i``, the
    mean over the ``B`` sequences."""
    K = sel.shape[-1]
    hits = torch.zeros((B, E), dtype=torch.float32, device=s.device)
    hits.scatter_add_(1, sel.reshape(B, S * K),
                      torch.ones((B, S * K), dtype=torch.float32,
                                 device=s.device))
    f = hits * (E / (K * S))
    P = (s / s.sum(dim=-1, keepdim=True)).reshape(B, S, E).mean(dim=1)
    return (f * P).sum(dim=-1).mean()


def _held_rows(sel: torch.Tensor, cfg, T: int):
    """The assignments to the held experts, grouped by expert and in token
    order within each: ``(rows into the flat (T * K) assignments, the
    groups' ends as a device int32 tensor, loads per held expert as Python
    ints)``. The loads are the layer's one host read: they size the rows.
    Past ``capacity`` an expert's assignments are dropped unless
    ``dropless``."""
    Eh, off = cfg.n_experts_held, cfg.expert_offset
    local = sel.reshape(-1) - off
    held = (local >= 0) & (local < Eh)
    key = torch.where(held, local, Eh)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=Eh + 1)[:Eh]
    loads = counts.tolist()
    if cfg.dropless:
        ends = torch.cumsum(counts, 0).to(torch.int32)
        return order[:sum(loads)], ends, loads
    C = capacity(T, cfg)
    kept = [min(n, C) for n in loads]
    starts = itertools.accumulate(loads, initial=0)
    rows = torch.cat([order[a:a + n] for a, n in zip(starts, kept)])
    ends = torch.cumsum(torch.clamp(counts, max=C), 0).to(torch.int32)
    return rows, ends, kept


def _held_experts(xs: torch.Tensor, p, ends: torch.Tensor) -> torch.Tensor:
    """The held experts' SwiGLUs on their rows of ``xs`` (grouped by
    expert, group ``e`` ending at row ``ends[e]``): three grouped GEMMs
    over the stacked weights, the gate's SiLU in float32."""
    h = torch._grouped_mm(xs, p["wi"], offs=ends)
    g = torch._grouped_mm(xs, p["wg"], offs=ends)
    act = F.silu(g.to(torch.float32)).to(h.dtype) * h
    return torch._grouped_mm(act, p["wo"], offs=ends)


def moe_ffn_held(x: torch.Tensor, p, cfg, bias: torch.Tensor, *,
                 obs=None, index: int = 0):
    """The held experts' part of a routed layer, plus the shared expert:
    ``x (B, S, D) -> (out (B, S, D), balance loss float32)``.

    Route every token over all ``n_experts`` (:func:`route_noaux_tc`),
    keep the assignments to the held experts, run their SwiGLUs on their
    tokens grouped by expert (dropless) as grouped GEMMs whose group ends
    stay on the device, weight them, sum them into their tokens in
    float32, and add the shared expert's SwiGLU on every token. The held
    experts' loads are read on the host once, to size the grouped rows:
    one synchronise a call, so two a layer and step under a checkpoint
    (carrying all ``T * K`` assignments instead, with no read, would move
    about 48 times the rows through the gather and the combine at Kimi
    K2's 8 of 384). ``obs`` (``obs.spans.capture()``) times the experts as
    span ``experts`` and counts ``moe_assignments_held`` and
    ``moe_max_expert_load`` at layer ``index``."""
    B, S, D = x.shape
    x2 = x.reshape(-1, D)
    T, K = x2.shape[0], cfg.top_k
    s, sel, w = route_noaux_tc(x2, p["router"], bias, cfg)
    aux = seq_balance_loss(s, sel, B, S, cfg.n_experts)
    rows, ends, loads = _held_rows(sel, cfg, T)
    spans.count("moe_assignments_held", index, sum(loads), obs)
    spans.count("moe_max_expert_load", index, max(loads), obs)
    tok = torch.div(rows, K, rounding_mode="floor")
    y = spans.traced("experts", _held_experts, x2[tok], p, ends, state=obs)
    contrib = y.to(torch.float32) * w.reshape(-1)[rows][:, None]
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    out = out.index_add(0, tok, contrib).to(x.dtype)
    if cfg.n_shared_experts:
        sh = p["shared"]
        out = out + L.swiglu(x2, sh["wi"], sh["wg"], sh["wo"])
    return out.reshape(B, S, D), aux
