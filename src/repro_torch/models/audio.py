"""Whisper-style encoder-decoder backbone, the audio family (port of
``repro.models.audio``).

The mel-spectrogram and conv front end is a stub, as in the reference:
``input_specs`` supplies precomputed frame embeddings ``(B, encoder_seq,
d_model)``. The backbone is a pre-LN encoder (bidirectional attention,
sinusoidal positions) and decoder (causal self-attention, cross-attention
to the encoder output, learned positions, GELU MLPs, biased projections;
``wk`` has no bias), with the head tied to the token embedding.

Types follow ``jnp``'s promotion, as in the reference: float32 frames
against bf16 weights run the whole encoder in float32 (the weights are
upcast, :func:`layers.dot`), and the cross-attention's keys and values are
float32; the decoder's residual stays in the model dtype, as attention
returns its query's dtype.

Decode caches: each layer's self-attention K/V (full or ring) and the
cross-attention ``xk`` / ``xv`` of ``(L, B, encoder_seq, H, hd)``. As in
the reference, nothing fills ``xk`` / ``xv`` (``init_cache`` makes them
zero and ``serve`` calls nothing else), so decode's cross-attention is
uniform over zero keys and adds the output bias ``bo``.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["init_params", "encode", "forward", "loss_fn", "init_cache",
           "decode_step"]


def _init_ln(d, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def _ln(x, p):
    return L.layernorm(x, p["scale"], p["bias"])


def _init_mha(key, cfg, dtype):
    D = cfg.d_model
    HD = cfg.n_heads * cfg.resolved_head_dim
    ks = prng.split(key, 4)
    dev = key.device
    return {
        "wq": L.dense_init(ks[0], (D, HD), dtype=dtype),
        "bq": torch.zeros((HD,), dtype=dtype, device=dev),
        "wk": L.dense_init(ks[1], (D, HD), dtype=dtype),
        "wv": L.dense_init(ks[2], (D, HD), dtype=dtype),
        "bv": torch.zeros((HD,), dtype=dtype, device=dev),
        "wo": L.dense_init(ks[3], (HD, D), dtype=dtype),
        "bo": torch.zeros((D,), dtype=dtype, device=dev),
    }


def _init_mlp(key, cfg, dtype):
    D, F = cfg.d_model, cfg.d_ff
    k1, k2 = prng.split(key)
    dev = key.device
    return {
        "wi": L.dense_init(k1, (D, F), dtype=dtype),
        "bi": torch.zeros((F,), dtype=dtype, device=dev),
        "wo": L.dense_init(k2, (F, D), dtype=dtype),
        "bo": torch.zeros((D,), dtype=dtype, device=dev),
    }


def init_params(key, cfg):
    """Random params of ``cfg`` from ``key``, on the key's device, in the
    reference's tree and draw order (the key split 6 ways, ``ks[0..3]``
    used)."""
    dtype = L.dtype_of(cfg)
    D = cfg.d_model
    dev = key.device
    ks = prng.split(key, 6)

    def enc_layer(k):
        k1, k2 = prng.split(k)
        return {
            "ln1": _init_ln(D, dtype, dev),
            "attn": _init_mha(k1, cfg, dtype),
            "ln2": _init_ln(D, dtype, dev),
            "mlp": _init_mlp(k2, cfg, dtype),
        }

    def dec_layer(k):
        k1, k2, k3 = prng.split(k, 3)
        return {
            "ln1": _init_ln(D, dtype, dev),
            "self_attn": _init_mha(k1, cfg, dtype),
            "ln_x": _init_ln(D, dtype, dev),
            "cross_attn": _init_mha(k2, cfg, dtype),
            "ln2": _init_ln(D, dtype, dev),
            "mlp": _init_mlp(k3, cfg, dtype),
        }

    return {
        "embed": L.embed_init(ks[0], (cfg.vocab_size, D), dtype),
        "pos_embed": L.embed_init(ks[1], (cfg.max_position, D), dtype),
        "enc_layers": T._stack(prng.split(ks[2], cfg.encoder_layers),
                               enc_layer),
        "enc_norm": _init_ln(D, dtype, dev),
        "dec_layers": T._stack(prng.split(ks[3], cfg.n_layers), dec_layer),
        "dec_norm": _init_ln(D, dtype, dev),
    }


def _mha(x, kv, p, cfg, causal):
    """x: ``(B, Sq, D)`` queries; kv: ``(B, Sk, D)`` the keys' and values'
    source."""
    B, Sq, _ = x.shape
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    Sk = kv.shape[1]
    q = (L.dot(x, p["wq"]) + p["bq"]).reshape(B, Sq, H, hd)
    k = L.dot(kv, p["wk"]).reshape(B, Sk, H, hd)
    v = (L.dot(kv, p["wv"]) + p["bv"]).reshape(B, Sk, H, hd)
    o = A.attend(q, k, v, causal=causal, impl=cfg.attn_impl)
    return L.dot(o.reshape(B, Sq, -1), p["wo"]) + p["bo"]


def _mlp(h, p):
    m = p["mlp"]
    return L.gelu_mlp(_ln(h, p["ln2"]), m["wi"], m["bi"], m["wo"], m["bo"])


def _enc_layer(h, pl, cfg):
    hn = _ln(h, pl["ln1"])
    h = h + _mha(hn, hn, pl["attn"], cfg, causal=False)
    return h + _mlp(h, pl)


def _dec_layer(h, pl, enc, cfg):
    hn = _ln(h, pl["ln1"])
    h = h + _mha(hn, hn, pl["self_attn"], cfg, causal=True)
    h = h + _mha(_ln(h, pl["ln_x"]), enc, pl["cross_attn"], cfg,
                 causal=False)
    return h + _mlp(h, pl)


def encode(params, frames, cfg):
    """frames: ``(B, encoder_seq, D)`` stub front-end embeddings; the
    encoder runs in their dtype (float32 from ``make_batch``)."""
    pos = L.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                 device=frames.device).to(frames.dtype)
    x = frames + pos[None]
    for pl in T._unstack_layers(params["enc_layers"], cfg.encoder_layers):
        x = T._run(_enc_layer, x, pl, cfg)
    return _ln(x, params["enc_norm"])


def _logits(x, params):
    """The tied head, ``x @ embed.T``, in float32."""
    return torch.matmul(x, params["embed"].T).to(torch.float32)


def forward(params, batch, cfg):
    """batch: ``frames (B, encoder_seq, D)`` and ``tokens`` ``(B, S)``.
    Returns ``(logits float32 (B, S, V), aux)``, the aux loss a float32
    zero."""
    enc = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"].long()
    S = tokens.shape[1]
    x = params["embed"][tokens] + params["pos_embed"][:S][None]
    for pl in T._unstack_layers(params["dec_layers"], cfg.n_layers):
        x = T._run(_dec_layer, x, pl, enc, cfg)
    x = _ln(x, params["dec_norm"])
    return _logits(x, params), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy of the decoder."""
    logits, _ = forward(params, batch, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    return torch.mean(lse - T._gold_logit(logits, batch["labels"]))


def init_cache(cfg, batch_size: int, cache_len: int, dtype=None,
               device=None) -> dict:
    """Zero caches ``{"k", "v"}`` of ``(L, B, cache_len, H, hd)`` and
    ``{"xk", "xv"}`` of ``(L, B, encoder_seq, H, hd)``."""
    dtype = dtype or L.dtype_of(cfg)
    lead = (cfg.n_layers, batch_size)
    tail = (cfg.n_heads, cfg.resolved_head_dim)

    def zeros(length):
        return torch.zeros(lead + (length,) + tail, dtype=dtype,
                           device=device)

    return {"k": zeros(cache_len), "v": zeros(cache_len),
            "xk": zeros(cfg.encoder_seq), "xv": zeros(cfg.encoder_seq)}


def _decode_layer(h, pl, kc, vc, xk, xv, pos, cfg, ring):
    """One token through one decoder layer. h: ``(B, 1, D)``."""
    B = h.shape[0]
    hd, H = cfg.resolved_head_dim, cfg.n_heads
    hn = _ln(h, pl["ln1"])
    sa = pl["self_attn"]
    q = (L.dot(hn, sa["wq"]) + sa["bq"]).reshape(B, 1, H, hd)
    k = L.dot(hn, sa["wk"]).reshape(B, 1, H, hd)
    v = (L.dot(hn, sa["wv"]) + sa["bv"]).reshape(B, 1, H, hd)
    if ring:
        kc, vc = A.update_cache_ring(kc, vc, k, v, pos)
        o = A.decode_attend_ring(q, kc, vc, pos)
    else:
        kc, vc = A.update_cache_full(kc, vc, k, v, pos)
        o = A.decode_attend_full(q, kc, vc, pos)
    h = h + (L.dot(o.reshape(B, 1, -1), sa["wo"]) + sa["bo"]).to(h.dtype)
    hx = _ln(h, pl["ln_x"])
    ca = pl["cross_attn"]
    qx = (L.dot(hx, ca["wq"]) + ca["bq"]).reshape(B, 1, H, hd)
    ox = A.attend_train(qx, xk, xv, causal=False)
    h = h + (L.dot(ox.reshape(B, 1, -1), ca["wo"]) + ca["bo"]).to(h.dtype)
    return h + _mlp(h, pl), kc, vc


@torch.no_grad()
def decode_step(params, cache, tokens, pos, cfg, *, ring: bool = False):
    """One decode step. tokens: ``(B, 1)`` ints; pos: int. Returns
    ``(logits (B, 1, V) float32, new cache)``; the input cache is left as
    it is."""
    pos = int(pos)
    x = params["embed"][tokens.long()] + params["pos_embed"][pos][None, None]
    ks, vs = [], []
    for i, pl in enumerate(T._unstack_layers(params["dec_layers"],
                                             cfg.n_layers)):
        x, kc, vc = _decode_layer(x, pl, cache["k"][i], cache["v"][i],
                                  cache["xk"][i], cache["xv"][i], pos, cfg,
                                  ring)
        ks.append(kc)
        vs.append(vc)
    x = _ln(x, params["dec_norm"])
    return _logits(x, params), dict(cache, k=torch.stack(ks),
                                    v=torch.stack(vs))
