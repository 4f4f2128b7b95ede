"""Decoder-only transformer, dense and moe families (port of
``repro.models.transformer``).

* ``dense`` is llama-style: RMSNorm, RoPE (optionally partial), GQA,
  SwiGLU; optional QKV bias (qwen2, chatglm), optional sliding window.
* ``moe`` has the same attention with the FFN replaced by top-k expert
  routing (``repro_torch.models.moe``, the dense dispatch), after
  ``first_dense_layers`` dense layers at ``dense_d_ff``; the aux loss is
  summed over the moe layers. ``moe_impl="expert_parallel"`` raises
  ``NotImplementedError``.

Layer leaves are stacked ``(L, ...)`` as in the reference; where the
reference scans over them, the port loops over the layers, each under
``torch.utils.checkpoint`` when gradients are on (the reference's
``jax.checkpoint``). The other families of the reference's module
(``vlm``, ``hybrid``) raise ``NotImplementedError``.

API (used by the launchers and tests):

    init_params(key, cfg)                        -> params
    forward(params, batch, cfg)                  -> (logits, aux_loss)
    loss_fn(params, batch, cfg)                  -> scalar loss
    init_cache(cfg, batch, cache_len)            -> cache
    decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)

Everything is made on the device of the key (``init_params``) or of the
params (the rest).
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "decode_step",
           "check_family"]

Params = Any

_LATER = {
    "vlm": "ROADMAP Queue 1, item 10 (the vlm model)",
    "hybrid": "ROADMAP Queue 1, item 10 (the hybrid model)",
}


def check_family(cfg) -> None:
    """Raise for a family this module does not run yet."""
    if cfg.family == "dense":
        return
    if cfg.family == "moe":
        if cfg.moe_impl == "expert_parallel":
            raise NotImplementedError(
                f"moe_impl='expert_parallel' ({cfg.name}) is not ported yet: "
                "ROADMAP Queue 1, item 10a (moe_ffn_shardmap, expert "
                "parallelism over all_to_all)")
        return
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_LATER[cfg.family]}")
    raise ValueError(cfg.family)


# ---------------------------------------------------------------- params


def _init_attn(key, cfg, dtype):
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    ks = prng.split(key, 4)
    p = {
        "wq": L.dense_init(ks[0], (D, H * hd), dtype=dtype),
        "wk": L.dense_init(ks[1], (D, KVH * hd), dtype=dtype),
        "wv": L.dense_init(ks[2], (D, KVH * hd), dtype=dtype),
        "wo": L.dense_init(ks[3], (H * hd, D), dtype=dtype),
    }
    if cfg.qkv_bias:
        dev = key.device
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((KVH * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((KVH * hd,), dtype=dtype, device=dev)
    return p


def _init_mlp(key, cfg, dtype, d_ff):
    D = cfg.d_model
    ks = prng.split(key, 3)
    return {
        "wi": L.dense_init(ks[0], (D, d_ff), dtype=dtype),
        "wg": L.dense_init(ks[1], (D, d_ff), dtype=dtype),
        "wo": L.dense_init(ks[2], (d_ff, D), dtype=dtype),
    }


def _init_dense_layer(key, cfg, dtype, d_ff=None):
    k1, k2 = prng.split(key)
    dev = key.device
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "attn": _init_attn(k1, cfg, dtype),
        "mlp": _init_mlp(k2, cfg, dtype, d_ff or cfg.d_ff),
    }


def _init_moe_layer(key, cfg, dtype):
    k1, k2 = prng.split(key)
    dev = key.device
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
        "attn": _init_attn(k1, cfg, dtype),
        "moe": MOE.init_moe(k2, cfg, dtype),
    }


def _stack(keys, fn):
    """``fn`` per key, leaves stacked on a new leading axis (the
    reference's ``vmap`` over the keys). Each leaf is written into its
    stacked tensor as the layers are made, so at most one layer's leaves
    exist twice."""
    out = None

    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        else:
            dst[i] = src

    def alloc(src):
        if isinstance(src, dict):
            return {k: alloc(v) for k, v in src.items()}
        return torch.empty((len(keys),) + tuple(src.shape), dtype=src.dtype,
                           device=src.device)

    for i in range(len(keys)):
        one = fn(keys[i])
        if out is None:
            out = alloc(one)
        put(out, one, i)
    return out


def init_params(key, cfg) -> Params:
    """Random params of ``cfg`` from ``key``, on the key's device, in the
    reference's tree and draw order."""
    check_family(cfg)
    dtype = L.dtype_of(cfg)
    dev = key.device
    ks = prng.split(key, 8)
    params: dict = {
        "embed": L.embed_init(ks[0], (cfg.vocab_size, cfg.d_model), dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(ks[1], (cfg.d_model, cfg.vocab_size),
                                         dtype=dtype)
    if cfg.family == "dense":
        lk = prng.split(ks[2], cfg.n_layers)
        params["layers"] = _stack(lk, lambda k: _init_dense_layer(k, cfg,
                                                                 dtype))
    else:  # moe
        nd = cfg.first_dense_layers
        if nd:
            dk = prng.split(ks[3], nd)
            params["dense_layers"] = _stack(dk, lambda k: _init_dense_layer(
                k, cfg, dtype, cfg.dense_d_ff))
        mk = prng.split(ks[4], cfg.n_layers - nd)
        params["layers"] = _stack(mk, lambda k: _init_moe_layer(k, cfg,
                                                               dtype))
    return params


def _unstack_layers(stacked: dict, n: int) -> list:
    """Per-layer views of the stacked leaves, made with one ``unbind`` a
    leaf, so the backward stacks each leaf's layer gradients once."""
    def views(t):
        if isinstance(t, dict):
            return {k: views(v) for k, v in t.items()}
        return torch.unbind(t, 0)

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return t[i]

    v = views(stacked)
    return [pick(v, i) for i in range(n)]


# ---------------------------------------------------------------- forward


def _project_qkv(x, p, cfg, positions):
    B, S, D = x.shape
    hd = cfg.resolved_head_dim
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    q = L.apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q, k, v


def _attn_block(x, p, cfg, positions, window):
    h = L.rmsnorm(x, p["ln1"])
    q, k, v = _project_qkv(h, p["attn"], cfg, positions)
    o = A.attend(q, k, v, causal=True, window=window, impl=cfg.attn_impl)
    o = torch.matmul(o.reshape(o.shape[0], o.shape[1], -1), p["attn"]["wo"])
    return x + o.to(x.dtype)


def _mlp_block(x, p, cfg):
    h = L.rmsnorm(x, p["ln2"])
    return x + L.swiglu(h, p["mlp"]["wi"], p["mlp"]["wg"], p["mlp"]["wo"])


def _moe_block(x, p, cfg):
    h = L.rmsnorm(x, p["ln2"])
    out, aux = MOE.moe_ffn(h, p["moe"], cfg)
    return x + out, aux


def _embed_tokens(params, tokens, cfg):
    return params["embed"][tokens.long()]


def _layer(x, pl, cfg, positions, window):
    h = _attn_block(x, pl, cfg, positions, window)
    return _mlp_block(h, pl, cfg)


def _moe_layer(x, pl, cfg, positions, window):
    h = _attn_block(x, pl, cfg, positions, window)
    return _moe_block(h, pl, cfg)


def _run(fn, x, pl, cfg, positions, window):
    """One layer, under ``torch.utils.checkpoint`` when gradients are on."""
    if torch.is_grad_enabled():
        return checkpoint(fn, x, pl, cfg, positions, window,
                          use_reentrant=False)
    return fn(x, pl, cfg, positions, window)


def forward(params: Params, batch: dict, cfg):
    """Training / prefill forward. Returns ``(logits float32 (B, S, V),
    aux_loss)``; ``aux_loss`` is the float32 sum of the moe layers' aux
    losses from 0, a float32 zero for the dense family."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    window = cfg.sliding_window
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "dense":
        for pl in _unstack_layers(params["layers"], cfg.n_layers):
            x = _run(_layer, x, pl, cfg, positions, window)
    else:  # moe
        nd = cfg.first_dense_layers
        if nd:
            for pl in _unstack_layers(params["dense_layers"], nd):
                x = _run(_layer, x, pl, cfg, positions, window)
        for pl in _unstack_layers(params["layers"], cfg.n_layers - nd):
            x, a = _run(_moe_layer, x, pl, cfg, positions, window)
            aux_total = aux_total + a
    x = L.rmsnorm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x, head).to(torch.float32)
    return logits, aux_total


def _gold_logit(logits, labels):
    """``sum(where(v == label, logits, 0))`` over the vocab: the
    reference's iota-compare reduce, not a gather."""
    vocab_iota = torch.arange(logits.shape[-1], dtype=torch.int32,
                              device=logits.device)
    mask = vocab_iota == labels[..., None].to(torch.int32)
    return torch.sum(torch.where(mask, logits, 0.0), dim=-1)


def loss_fn(params: Params, batch: dict, cfg):
    """Mean next-token cross-entropy (plus ``aux_loss_coef * aux``)."""
    logits, aux = forward(params, batch, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    nll = torch.mean(lse - _gold_logit(logits, batch["labels"]))
    return nll + cfg.aux_loss_coef * aux


# ----------------------------------------------------------------- decode


def init_cache(cfg, batch_size: int, cache_len: int, dtype=None,
               device=None) -> dict:
    """Zero KV cache ``{"k", "v"}`` of ``(L, B, cache_len, KVH, hd)``;
    ``cache_len`` is the window for ring (sliding) caches. A moe config's
    ``k`` / ``v`` cover its moe layers, and ``dk`` / ``dv`` its
    ``first_dense_layers``."""
    check_family(cfg)
    dtype = dtype or L.dtype_of(cfg)
    nd = cfg.first_dense_layers if cfg.family == "moe" else 0

    def zeros(n):
        return torch.zeros((n, batch_size, cache_len, cfg.n_kv_heads,
                            cfg.resolved_head_dim), dtype=dtype, device=device)

    cache = {"k": zeros(cfg.n_layers - nd), "v": zeros(cfg.n_layers - nd)}
    if nd:
        cache["dk"], cache["dv"] = zeros(nd), zeros(nd)
    return cache


def _decode_attn(x, p, cfg, kc, vc, pos, ring: bool):
    """One-token attention for a single layer. x: ``(B, 1, D)``."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    h = L.rmsnorm(x, p["ln1"])
    q = torch.matmul(h, p["attn"]["wq"])
    k = torch.matmul(h, p["attn"]["wk"])
    v = torch.matmul(h, p["attn"]["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["attn"]["bq"], k + p["attn"]["bk"], v + p["attn"]["bv"]
    q = q.reshape(B, 1, cfg.n_heads, hd)
    k = k.reshape(B, 1, cfg.n_kv_heads, hd)
    v = v.reshape(B, 1, cfg.n_kv_heads, hd)
    posb = torch.full((1, 1), int(pos), dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, posb, cfg.rope_fraction, cfg.rope_theta)
    k = L.apply_rope(k, posb, cfg.rope_fraction, cfg.rope_theta)
    if ring:
        kc, vc = A.update_cache_ring(kc, vc, k, v, pos)
        o = A.decode_attend_ring(q, kc, vc, pos)
    else:
        kc, vc = A.update_cache_full(kc, vc, k, v, pos)
        o = A.decode_attend_full(q, kc, vc, pos)
    o = torch.matmul(o.reshape(B, 1, -1), p["attn"]["wo"])
    return x + o.to(x.dtype), kc, vc


def _decode_layers(x, stacked, n, kcache, vcache, pos, cfg, ring, moe):
    """Decode through ``n`` stacked layers (moe FFNs when ``moe``);
    returns ``x`` and the layers' new caches, stacked."""
    ks, vs = [], []
    for i, pl in enumerate(_unstack_layers(stacked, n)):
        x, kc, vc = _decode_attn(x, pl, cfg, kcache[i], vcache[i], pos, ring)
        x = _moe_block(x, pl, cfg)[0] if moe else _mlp_block(x, pl, cfg)
        ks.append(kc)
        vs.append(vc)
    return x, torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def decode_step(params, cache, tokens, pos, cfg, *, ring: bool = False):
    """One decode step. tokens: ``(B, 1)`` ints; pos: int.

    ``ring=True`` uses sliding-window ring caches. Returns ``(logits
    (B, 1, V) float32, new cache)``; the input cache is left as it is.
    """
    check_family(cfg)
    x = _embed_tokens(params, tokens, cfg)
    moe = cfg.family == "moe"
    nd = cfg.first_dense_layers if moe else 0
    if nd:
        x, dk, dv = _decode_layers(x, params["dense_layers"], nd, cache["dk"],
                                   cache["dv"], pos, cfg, ring, False)
        cache = dict(cache, dk=dk, dv=dv)
    x, k, v = _decode_layers(x, params["layers"], cfg.n_layers - nd,
                             cache["k"], cache["v"], pos, cfg, ring, moe)
    cache = dict(cache, k=k, v=v)
    x = L.rmsnorm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x, head).to(torch.float32)
    return logits, cache
