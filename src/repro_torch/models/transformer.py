"""Decoder-only transformer families: dense, moe, vlm, hybrid (port of
``repro.models.transformer``).

* ``dense`` is llama-style: RMSNorm, RoPE (optionally partial), GQA,
  SwiGLU; optional QKV bias (qwen2, chatglm), optional sliding window.
* ``moe`` has the same attention with the FFN replaced by top-k expert
  routing (``repro_torch.models.moe``, the dense dispatch), after
  ``first_dense_layers`` dense layers at ``dense_d_ff``; the aux loss is
  summed over the moe layers. ``moe_impl="expert_parallel"`` exchanges
  tokens with the expert owners over the group of the enclosing
  ``moe.expert_group`` scope (``moe.moe_ffn_shardmap``). A config with
  latent attention (``configs/kimi_k2_instruct.py``, port-only) takes
  ``models/mla.py``'s MLA in every layer and ``moe.moe_ffn_held`` (its
  held share of the routed experts) in the moe layers, each block traced
  as span ``mla`` / ``moe`` (forward, recomputation and backward); it
  trains and prefills, and has no decode.
* ``vlm`` is the dense decoder behind a projected patch-embedding prefix
  (``batch["patch_embeds"]``; the vision encoder is a stub, as in the
  reference). The prefix is cut after the final norm; decode sees no
  image.
* ``hybrid`` is Griffin / RecurrentGemma: RG-LRU recurrent blocks with a
  local-window attention block every ``attn_period`` layers, in stacked
  ``(rec, ..., rec, attn)`` groups and a list ``tail`` of recurrent
  blocks for the remainder. The RG-LRU's linear recurrence runs jax's
  odd/even ``associative_scan`` recursion (:func:`_assoc_scan`).

Layer leaves are stacked ``(L, ...)`` as in the reference; where the
reference scans over them, the port loops over the layers (or groups,
or tail blocks), each under ``torch.utils.checkpoint`` when gradients are
on (the reference's ``jax.checkpoint``).

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
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.core.transport import tree_map
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.obs import spans

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "decode_step",
           "check_family"]

Params = Any


def check_family(cfg) -> None:
    """Raise for a family this module does not run."""
    if cfg.family not in ("dense", "moe", "vlm", "hybrid"):
        raise ValueError(cfg.family)


# ---------------------------------------------------------------- params


def _init_attn(key, cfg, dtype):
    if MLA.is_mla(cfg):
        return MLA.init_mla(key, cfg, dtype)
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
        # the MLA moe config holds a share of the routed experts
        "moe": (MOE.init_moe_held if MLA.is_mla(cfg)
                else MOE.init_moe)(k2, cfg, dtype),
    }


def _init_rglru_block(key, cfg, dtype):
    D = cfg.d_model
    W = cfg.lru_width or D
    ks = prng.split(key, 7)
    dev = key.device
    return {
        "ln1": torch.zeros((D,), dtype=dtype, device=dev),
        "ln2": torch.zeros((D,), dtype=dtype, device=dev),
        "rec": {
            "w_x": L.dense_init(ks[0], (D, W), dtype=dtype),
            "w_gate": L.dense_init(ks[1], (D, W), dtype=dtype),
            "conv_w": (prng.normal(ks[2], (4, W)) * 0.1).to(dtype),
            "w_r": L.dense_init(ks[3], (W, W), dtype=dtype),
            "w_i": L.dense_init(ks[4], (W, W), dtype=dtype),
            # the softplus parameter of the decay, float32 in any dtype
            "lam": torch.full((W,), 2.0, dtype=torch.float32, device=dev),
            "w_out": L.dense_init(ks[5], (W, D), dtype=dtype),
        },
        "mlp": _init_mlp(ks[6], cfg, dtype, cfg.d_ff),
    }


def _stack(keys, fn):
    """``fn`` per key, leaves stacked on a new leading axis (the
    reference's ``vmap`` over the keys). Each leaf is written into its
    stacked tensor as the layers are made, so at most one layer's leaves
    exist twice. With no keys the leaves are ``(0, ...)`` on the keys'
    device, their shapes and dtypes from ``fn`` on a meta key, as the
    reference's ``vmap`` over no keys gives them."""
    if len(keys) == 0:
        like = fn(prng.PRNGKey(0, device="meta"))
        return tree_map(lambda t: torch.empty((0,) + tuple(t.shape),
                                              dtype=t.dtype,
                                              device=keys.device), like)
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
    if cfg.family in ("dense", "vlm"):
        lk = prng.split(ks[2], cfg.n_layers)
        params["layers"] = _stack(lk, lambda k: _init_dense_layer(k, cfg,
                                                                 dtype))
    elif cfg.family == "moe":
        nd = cfg.first_dense_layers
        if nd:
            dk = prng.split(ks[3], nd)
            params["dense_layers"] = _stack(dk, lambda k: _init_dense_layer(
                k, cfg, dtype, cfg.dense_d_ff))
        mk = prng.split(ks[4], cfg.n_layers - nd)
        params["layers"] = _stack(mk, lambda k: _init_moe_layer(k, cfg,
                                                               dtype))
    else:  # hybrid: G stacked groups of (p - 1) rec blocks + 1 attn layer
        p = cfg.attn_period
        G, tail_n = divmod(cfg.n_layers, p)

        def group(k):
            gk = prng.split(k, p)
            g = {f"rec{i}": _init_rglru_block(gk[i], cfg, dtype)
                 for i in range(p - 1)}
            g["attn"] = _init_dense_layer(gk[p - 1], cfg, dtype)
            return g

        params["groups"] = _stack(prng.split(ks[5], G), group)
        tk = prng.split(ks[7], max(tail_n, 1))
        params["tail"] = [_init_rglru_block(tk[i], cfg, dtype)
                          for i in range(tail_n)]
    if cfg.family == "vlm":
        params["vision_proj"] = L.dense_init(
            ks[6], (cfg.vision_dim, cfg.d_model), dtype=dtype)
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


def _moe_block(x, p, cfg, group=None):
    h = L.rmsnorm(x, p["ln2"])
    if cfg.moe_impl == "expert_parallel":
        out, aux = MOE.moe_ffn_shardmap(h, p["moe"], cfg, group)
    else:
        out, aux = MOE.moe_ffn(h, p["moe"], cfg)
    return x + out, aux


def _softplus(x):
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)`` (torch's
    ``softplus`` turns into the identity above its ``threshold``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _comb(a1, b1, a2, b2):
    """The RG-LRU's combine of an earlier ``(a1, b1)`` and a later
    ``(a2, b2)``: ``(a1 a2, a2 b1 + b2)``, the product rounded before the
    add (XLA on the CPU contracts it into an fma; ROADMAP Queue 3)."""
    return a1 * a2, a2 * b1 + b2


def _interleave(a, b):
    """``a[0], b[0], a[1], b[1], ...`` along axis 1 (``a`` as long as
    ``b`` or one longer), as jax's ``_interleave`` builds it: the sum of
    the two zero-padded inputs."""
    shape = (a.shape[0], a.shape[1] + b.shape[1]) + tuple(a.shape[2:])
    za, zb = a.new_zeros(shape), b.new_zeros(shape)
    za[:, 0::2] = a
    zb[:, 1::2] = b
    return za + zb


def _assoc_scan(a, b):
    """``lax.associative_scan(comb, (a, b), axis=1)`` by jax's own odd/even
    recursion, so each element sees the reference's operations in the
    reference's order: combine adjacent pairs, scan those, then combine
    each odd result with the next even element."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _assoc_scan(*_comb(a[:, 0:n - 1:2], b[:, 0:n - 1:2],
                                a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ea, eb = _comb(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _comb(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _rglru_scan(xg, rec):
    """RG-LRU over a sequence from a zero state (the reference's ``h0``
    argument, which no caller passes, is left out). xg: ``(B, S, W)``
    post-conv activations.

    Returns ``(y (B, S, W) float32, h_last (B, W))`` of
    ``h_t = a_t h_{t-1} + sqrt(1 - a_t**2) (i_t x_t)``.
    """
    r = torch.sigmoid(torch.matmul(xg, rec["w_r"]).to(torch.float32))
    i = torch.sigmoid(torch.matmul(xg, rec["w_i"]).to(torch.float32))
    log_a = -8.0 * _softplus(rec["lam"]) * r
    a = torch.exp(log_a)
    gated = i * xg.to(torch.float32)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated
    _, y = _assoc_scan(a, b)
    return y, y[:, -1]


def _causal_conv(x, w):
    """Depthwise causal conv over the sequence, in float32, the taps summed
    in order ``j = 0 .. K-1``. x: ``(B, S, W)``; w: ``(K, W)``."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x.to(torch.float32), (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0].to(torch.float32)
    for j in range(1, K):
        out = out + pad[:, j:j + S] * w[j].to(torch.float32)
    return out.to(x.dtype)


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh form."""
    return F.gelu(x, approximate="tanh")


def _rglru_block_fwd(x, p, cfg):
    h = L.rmsnorm(x, p["ln1"])
    rec = p["rec"]
    xb = torch.matmul(h, rec["w_x"])
    gate = _gelu(torch.matmul(h, rec["w_gate"]).to(torch.float32))
    xb = _causal_conv(xb, rec["conv_w"])
    y, _ = _rglru_scan(xb, rec)
    y = (y * gate).to(x.dtype)
    x = x + torch.matmul(y, rec["w_out"])
    return _mlp_block(x, p, cfg)


def _embed_tokens(params, tokens, cfg):
    return params["embed"][tokens.long()]


def _layer(x, pl, cfg, positions, window):
    h = _attn_block(x, pl, cfg, positions, window)
    return _mlp_block(h, pl, cfg)


def _moe_layer(x, pl, cfg, positions, window, group):
    h = _attn_block(x, pl, cfg, positions, window)
    return _moe_block(h, pl, cfg, group)


def _mla_block(x, p, cfg, positions, tables):
    h = L.rmsnorm(x, p["ln1"])
    return x + MLA.attention(h, p["attn"], cfg, positions, tables).to(x.dtype)


def _held_moe_block(x, p, cfg, bias, obs, index):
    h = L.rmsnorm(x, p["ln2"])
    out, aux = MOE.moe_ffn_held(h, p["moe"], cfg, bias, obs=obs, index=index)
    return x + out, aux


def _mla_dense_layer(x, pl, cfg, positions, tables, obs):
    x = spans.traced("mla", _mla_block, x, pl, cfg, positions, tables,
                     state=obs)
    return _mlp_block(x, pl, cfg)


def _mla_moe_layer(x, pl, cfg, positions, tables, bias, obs, index):
    x = spans.traced("mla", _mla_block, x, pl, cfg, positions, tables,
                     state=obs)
    return spans.traced("moe", _held_moe_block, x, pl, cfg, bias, obs, index,
                        state=obs)


def _mla_moe_stack(params, x, cfg, positions):
    """The layers of an MLA moe config: ``(x, aux)``. The span scope is
    captured here, where the forward's context is set, and handed to every
    layer, since a layer's recomputation and its backward run on
    autograd's thread."""
    obs = spans.capture()
    tables = MLA.rope_tables(cfg, x.device)
    nd = cfg.first_dense_layers
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if nd:
        for pl in _unstack_layers(params["dense_layers"], nd):
            x = _run(_mla_dense_layer, x, pl, cfg, positions, tables, obs)
    bias = MOE.correction_bias(cfg, cfg.n_layers - nd, x.device)
    for i, pl in enumerate(_unstack_layers(params["layers"],
                                           cfg.n_layers - nd)):
        x, a = _run(_mla_moe_layer, x, pl, cfg, positions, tables, bias[i],
                    obs, i)
        aux_total = aux_total + a
    return x, aux_total


def _hybrid_group(x, gp, cfg, positions, window):
    for i in range(cfg.attn_period - 1):
        x = _rglru_block_fwd(x, gp[f"rec{i}"], cfg)
    return _layer(x, gp["attn"], cfg, positions, window)


def _rec_block(x, blk, cfg, positions, window):
    return _rglru_block_fwd(x, blk, cfg)


def _run(fn, *args):
    """One layer, ``fn(*args)``, under ``torch.utils.checkpoint`` when
    gradients are on."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def forward(params: Params, batch: dict, cfg):
    """Training / prefill forward. Returns ``(logits float32 (B, S, V),
    aux_loss)``; ``aux_loss`` is the float32 sum of the moe layers' aux
    losses from 0, a float32 zero for the other families. A vlm batch
    carries ``patch_embeds`` ``(B, P, vision_dim)``; its logits cover the
    tokens only."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens, cfg)
    prefix = 0
    if cfg.family == "vlm":
        patches = batch["patch_embeds"].to(x.dtype)
        proj = torch.matmul(patches, params["vision_proj"])
        x = torch.cat([proj, x], dim=1)
        prefix = patches.shape[1]
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    window = cfg.sliding_window
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "vlm"):
        for pl in _unstack_layers(params["layers"], cfg.n_layers):
            x = _run(_layer, x, pl, cfg, positions, window)
    elif cfg.family == "hybrid":
        G = cfg.n_layers // cfg.attn_period
        for gp in _unstack_layers(params["groups"], G):
            x = _run(_hybrid_group, x, gp, cfg, positions, cfg.local_window)
        for blk in params["tail"]:
            x = _run(_rec_block, x, blk, cfg, positions, window)
    elif MLA.is_mla(cfg):
        x, aux_total = _mla_moe_stack(params, x, cfg, positions)
    else:  # moe
        nd = cfg.first_dense_layers
        if nd:
            for pl in _unstack_layers(params["dense_layers"], nd):
                x = _run(_layer, x, pl, cfg, positions, window)
        # read here, not in the layer: a recomputation runs outside the scope
        group = MOE.current_expert_group()
        for pl in _unstack_layers(params["layers"], cfg.n_layers - nd):
            x, a = _run(_moe_layer, x, pl, cfg, positions, window, group)
            aux_total = aux_total + a
    x = L.rmsnorm(x, params["final_norm"])
    if prefix:
        x = x[:, prefix:]
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


def _no_mla_decode(cfg) -> None:
    if MLA.is_mla(cfg):
        raise NotImplementedError(
            f"{cfg.name}: MLA decode (the latent cache) is not implemented; "
            "the config trains and prefills only")


def init_cache(cfg, batch_size: int, cache_len: int, dtype=None,
               device=None) -> dict:
    """Zero KV cache ``{"k", "v"}`` of ``(L, B, cache_len, KVH, hd)``;
    ``cache_len`` is the window for ring (sliding) caches. A moe config's
    ``k`` / ``v`` cover its moe layers, and ``dk`` / ``dv`` its
    ``first_dense_layers``. A hybrid config's cache is ``{"groups":
    {"rec{i}": {"h", "conv"}, "attn": {"k", "v"}}, "tail": [{"h",
    "conv"}, ...]}``: RG-LRU states ``h`` in float32, the conv's last
    three inputs, and ring caches of ``min(cache_len, local_window)``
    slots."""
    check_family(cfg)
    _no_mla_decode(cfg)
    dtype = dtype or L.dtype_of(cfg)
    nd = cfg.first_dense_layers if cfg.family == "moe" else 0

    def zeros(n, length=cache_len):
        return torch.zeros((n, batch_size, length, cfg.n_kv_heads,
                            cfg.resolved_head_dim), dtype=dtype, device=device)

    if cfg.family == "hybrid":
        W = cfg.lru_width or cfg.d_model
        p = cfg.attn_period
        G, tail_n = divmod(cfg.n_layers, p)
        wlen = min(cache_len, cfg.local_window)

        def rec_cache(lead=()):
            return {"h": torch.zeros((*lead, batch_size, W),
                                     dtype=torch.float32, device=device),
                    "conv": torch.zeros((*lead, batch_size, 3, W),
                                        dtype=dtype, device=device)}

        groups = {f"rec{i}": rec_cache((G,)) for i in range(p - 1)}
        groups["attn"] = {"k": zeros(G, wlen), "v": zeros(G, wlen)}
        return {"groups": groups, "tail": [rec_cache() for _ in range(tail_n)]}
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
        x = (_moe_block(x, pl, cfg, MOE.current_expert_group())[0] if moe
             else _mlp_block(x, pl, cfg))
        ks.append(kc)
        vs.append(vc)
    return x, torch.stack(ks), torch.stack(vs)


def _rglru_decode(x, p, cfg, c):
    """Single-step RG-LRU. x: ``(B, 1, D)``; cache ``{"h" (B, W) float32,
    "conv" (B, 3, W)}``."""
    rec = p["rec"]
    h = L.rmsnorm(x, p["ln1"])
    xb = torch.matmul(h, rec["w_x"])[:, 0]  # (B, W)
    gate = _gelu(torch.matmul(h, rec["w_gate"]).to(torch.float32))[:, 0]
    # causal conv with kernel 4: the state holds the previous 3 inputs
    win = torch.cat([c["conv"], xb[:, None]], dim=1)  # (B, 4, W)
    w = rec["conv_w"].to(torch.float32)
    xc = torch.sum(win.to(torch.float32) * w[None], dim=1).to(x.dtype)
    r = torch.sigmoid(torch.matmul(xc, rec["w_r"]).to(torch.float32))
    i = torch.sigmoid(torch.matmul(xc, rec["w_i"]).to(torch.float32))
    a = torch.exp(-8.0 * _softplus(rec["lam"]) * r)
    hnew = a * c["h"] + torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * (
        i * xc.to(torch.float32))
    y = (hnew * gate).to(x.dtype)
    x = x + torch.matmul(y, rec["w_out"])[:, None]
    x = _mlp_block(x, p, cfg)
    return x, {"h": hnew, "conv": win[:, 1:]}


def _decode_hybrid(x, params, cache, pos, cfg):
    """Decode through the hybrid groups (their attention on ring caches
    always) and the tail; returns ``x`` and the new cache."""
    p = cfg.attn_period
    G = cfg.n_layers // p
    new = []
    for gp, gc in zip(_unstack_layers(params["groups"], G),
                      _unstack_layers(cache["groups"], G)):
        nc = {}
        for i in range(p - 1):
            x, nc[f"rec{i}"] = _rglru_decode(x, gp[f"rec{i}"], cfg,
                                             gc[f"rec{i}"])
        x, kc, vc = _decode_attn(x, gp["attn"], cfg, gc["attn"]["k"],
                                 gc["attn"]["v"], pos, True)
        x = _mlp_block(x, gp["attn"], cfg)
        nc["attn"] = {"k": kc, "v": vc}
        new.append(nc)
    groups = (tree_map(lambda *ts: torch.stack(ts), *new) if new
              else cache["groups"])
    tail = []
    for blk, c in zip(params["tail"], cache["tail"]):
        x, rc = _rglru_decode(x, blk, cfg, c)
        tail.append(rc)
    return x, {"groups": groups, "tail": tail}


@torch.no_grad()
def decode_step(params, cache, tokens, pos, cfg, *, ring: bool = False):
    """One decode step. tokens: ``(B, 1)`` ints; pos: int.

    ``ring=True`` uses sliding-window ring caches (a hybrid config's
    attention always does). Returns ``(logits (B, 1, V) float32, new
    cache)``; the input cache is left as it is.
    """
    check_family(cfg)
    _no_mla_decode(cfg)
    x = _embed_tokens(params, tokens, cfg)
    if cfg.family == "hybrid":
        x, cache = _decode_hybrid(x, params, cache, pos, cfg)
        return _decode_logits(x, params, cfg), cache
    moe = cfg.family == "moe"
    nd = cfg.first_dense_layers if moe else 0
    if nd:
        x, dk, dv = _decode_layers(x, params["dense_layers"], nd, cache["dk"],
                                   cache["dv"], pos, cfg, ring, False)
        cache = dict(cache, dk=dk, dv=dv)
    x, k, v = _decode_layers(x, params["layers"], cfg.n_layers - nd,
                             cache["k"], cache["v"], pos, cfg, ring, moe)
    return _decode_logits(x, params, cfg), dict(cache, k=k, v=v)


def _decode_logits(x, params, cfg):
    x = L.rmsnorm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, head).to(torch.float32)
