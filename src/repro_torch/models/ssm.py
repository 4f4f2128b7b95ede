"""Mamba-1 selective SSM (the falcon-mamba family), an attention-free
decoder (port of ``repro.models.ssm``).

Block: RMSNorm -> in_proj (D -> 2 Di) -> [x: causal depthwise conv (K taps)
-> SiLU -> selective scan] * SiLU(z) -> out_proj (Di -> D).

Selective scan, per token t and channel c (a state of N per channel):

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t
    y_t = C_t . h_t + D_skip x_t

over the sequence by jax's odd/even ``associative_scan`` recursion
(``transformer._assoc_scan``, the RG-LRU's), multiply then add. Decode
keeps a constant-size state ``(B, Di, N)`` float32 and the conv's last
``K - 1`` inputs.

As in the reference, forward casts the conv's output and SiLU's output to
the model dtype before the scan, and decode keeps both in float32, so in
bf16 decode is not forward one token at a time.

API: ``init_params``, ``forward``, ``loss_fn``, ``init_cache``,
``decode_step``, as ``models/transformer.py``; the layers are stacked
``(L, ...)`` and run one at a time, each under ``torch.utils.checkpoint``
when gradients are on.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "decode_step"]


def _dt_rank(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def _init_layer(key, cfg, dtype):
    D = cfg.d_model
    Di = cfg.expand * D
    N = cfg.ssm_state
    R = _dt_rank(cfg)
    K = cfg.ssm_conv
    dev = key.device
    ks = prng.split(key, 8)  # the reference splits 8 and uses ks[0..4]
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev)[None].repeat(
        Di, 1)
    return {
        "ln": torch.zeros((D,), dtype=dtype, device=dev),
        "in_proj": L.dense_init(ks[0], (D, 2 * Di), dtype=dtype),
        "conv_w": (prng.normal(ks[1], (K, Di)) * 0.1).to(dtype),
        "conv_b": torch.zeros((Di,), dtype=dtype, device=dev),
        "x_proj": L.dense_init(ks[2], (Di, R + 2 * N), dtype=dtype),
        "dt_proj": L.dense_init(ks[3], (R, Di), dtype=dtype),
        # float32 in any dtype: softplus(-4) ~ 0.018
        "dt_bias": torch.full((Di,), -4.0, dtype=torch.float32, device=dev),
        "A_log": torch.log(A),
        "D_skip": torch.ones((Di,), dtype=torch.float32, device=dev),
        "out_proj": L.dense_init(ks[4], (Di, D), dtype=dtype),
    }


def init_params(key, cfg):
    """Random params of ``cfg`` from ``key``, on the key's device, in the
    reference's tree and draw order."""
    dtype = L.dtype_of(cfg)
    D = cfg.d_model
    ks = prng.split(key, 3)
    lk = prng.split(ks[0], cfg.n_layers)
    return {
        "embed": L.embed_init(ks[1], (cfg.vocab_size, D), dtype),
        "layers": T._stack(lk, lambda k: _init_layer(k, cfg, dtype)),
        "final_norm": torch.zeros((D,), dtype=dtype, device=key.device),
        "lm_head": L.dense_init(ks[2], (D, cfg.vocab_size), dtype=dtype),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv with a bias. x: ``(B, S, Di)``; w: ``(K, Di)``.
    The taps' float32 products summed in order ``j = 0 .. K-1``, then the
    bias, then one cast to ``x.dtype``."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:S].to(torch.float32) * w[0].to(torch.float32)
    for j in range(1, K):
        out = out + pad[:, j:j + S].to(torch.float32) * w[j].to(torch.float32)
    return (out + b.to(torch.float32)).to(x.dtype)


def _ssm_scan(xc, p, cfg):
    """Selective scan from a zero state (the reference's ``h0`` argument,
    which no caller passes, is left out). xc: ``(B, S, Di)`` post-conv.

    Returns ``(y (B, S, Di) in xc's dtype, h_last (B, Di, N) float32)``.
    """
    N = cfg.ssm_state
    R = _dt_rank(cfg)
    proj = torch.matmul(xc, p["x_proj"]).to(torch.float32)
    dt = T._softplus(torch.matmul(proj[..., :R],
                                  p["dt_proj"].to(torch.float32))
                     + p["dt_bias"])  # (B, S, Di)
    Bm = proj[..., R:R + N]  # (B, S, N)
    Cm = proj[..., R + N:]  # (B, S, N)
    A = -torch.exp(p["A_log"])  # (Di, N)
    xf = xc.to(torch.float32)
    a = torch.exp(dt[..., None] * A)  # (B, S, Di, N)
    b = (dt * xf)[..., None] * Bm[..., None, :]  # (B, S, Di, N)
    _, hs = T._assoc_scan(a, b)
    y = torch.einsum("bsdn,bsn->bsd", hs, Cm) + p["D_skip"] * xf
    return y.to(xc.dtype), hs[:, -1]


def _block(x, p, cfg):
    h = L.rmsnorm(x, p["ln"])
    Di = cfg.expand * cfg.d_model
    xz = torch.matmul(h, p["in_proj"])
    xb, z = xz[..., :Di], xz[..., Di:]
    xb = _causal_conv(xb, p["conv_w"], p["conv_b"])
    xb = F.silu(xb.to(torch.float32)).to(x.dtype)
    y, _ = _ssm_scan(xb, p, cfg)
    y = y * F.silu(z.to(torch.float32)).to(x.dtype)
    return x + torch.matmul(y, p["out_proj"])


def forward(params, batch, cfg):
    """Training / prefill forward: ``(logits float32 (B, S, V), aux)``,
    the aux loss a float32 zero."""
    x = params["embed"][batch["tokens"].long()]
    for pl in T._unstack_layers(params["layers"], cfg.n_layers):
        x = T._run(_block, x, pl, cfg)
    x = L.rmsnorm(x, params["final_norm"])
    logits = torch.matmul(x, params["lm_head"]).to(torch.float32)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, batch, cfg):
    """Mean next-token cross-entropy."""
    logits, _ = forward(params, batch, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    return torch.mean(lse - T._gold_logit(logits, batch["labels"]))


def init_cache(cfg, batch_size: int, cache_len: int = 0, dtype=None,
               device=None) -> dict:
    """Constant-size state ``{"h" (L, B, Di, N) float32, "conv" (L, B,
    K-1, Di)}``; ``cache_len`` is ignored (kept for the API)."""
    dtype = dtype or L.dtype_of(cfg)
    Di = cfg.expand * cfg.d_model
    return {
        "h": torch.zeros((cfg.n_layers, batch_size, Di, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch_size, cfg.ssm_conv - 1, Di),
                            dtype=dtype, device=device),
    }


def _decode_layer(x, pl, hstate, conv, cfg):
    """One token through one layer. x: ``(B, 1, D)``; hstate ``(B, Di, N)``
    float32; conv ``(B, K-1, Di)``. The conv and SiLU stay in float32."""
    Di = cfg.expand * cfg.d_model
    N = cfg.ssm_state
    R = _dt_rank(cfg)
    f32 = torch.float32
    hh = L.rmsnorm(x, pl["ln"])
    xz = torch.matmul(hh, pl["in_proj"])[:, 0]
    xb, z = xz[..., :Di], xz[..., Di:]
    win = torch.cat([conv, xb[:, None]], dim=1)  # (B, K, Di)
    w = pl["conv_w"].to(f32)
    xc = (torch.sum(win.to(f32) * w[None], dim=1)
          + pl["conv_b"].to(f32))
    xc = F.silu(xc)
    proj = torch.matmul(xc, pl["x_proj"].to(f32))
    dt = T._softplus(torch.matmul(proj[..., :R], pl["dt_proj"].to(f32))
                     + pl["dt_bias"])
    Bm = proj[..., R:R + N]
    Cm = proj[..., R + N:]
    A = -torch.exp(pl["A_log"])
    a = torch.exp(dt[..., None] * A)  # (B, Di, N)
    hnew = a * hstate + (dt * xc)[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", hnew, Cm) + pl["D_skip"] * xc
    y = y * F.silu(z.to(f32))
    out = torch.matmul(y.to(x.dtype), pl["out_proj"])
    return x + out[:, None], hnew, win[:, 1:]


@torch.no_grad()
def decode_step(params, cache, tokens, pos, cfg, *, ring: bool = False):
    """One decode step (``pos`` and ``ring`` are unused: the state is
    constant-size). Returns ``(logits (B, 1, V) float32, new cache)``; the
    input cache is left as it is."""
    x = params["embed"][tokens.long()]  # (B, 1, D)
    hs, convs = [], []
    for i, pl in enumerate(T._unstack_layers(params["layers"], cfg.n_layers)):
        x, h, c = _decode_layer(x, pl, cache["h"][i], cache["conv"][i], cfg)
        hs.append(h)
        convs.append(c)
    x = L.rmsnorm(x, params["final_norm"])
    logits = torch.matmul(x, params["lm_head"]).to(torch.float32)
    return logits, {"h": torch.stack(hs), "conv": torch.stack(convs)}
