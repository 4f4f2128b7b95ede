"""Multi-head latent attention (MLA), the training form, with YaRN rotary
positions: the attention of DeepSeek-V3 and Kimi K2 (no counterpart in
the reference package; the config is ``configs/kimi_k2_instruct.py``).

For ``x (B, S, D)`` (already normed), per token::

    c_q = RMSNorm(x W_dq)                  D -> q_lora_rank
    q = c_q W_uq                           per head [q_nope | q_rope]
    [c_kv, k_rope] = x W_dkv               D -> kv_lora_rank + d_rope
    c_kv = RMSNorm(c_kv)
    [k_nope, v] = c_kv W_ukv               per head [k_nope | v]
    q_rope, k_rope <- YaRN RoPE            k_rope: one key a token, shared
                                           by every head
    o = softmax(scale [q_nope | q_rope] [k_nope | k_rope]^T + causal) v
    out = o W_o                            H * d_v -> D

The cache-absorbed decode form is out of scope: a config with MLA trains
and prefills, and ``decode_step`` / ``init_cache`` raise.

The attention is one fused call whose backward keeps no ``(S, S)``
matrix: ``scaled_dot_product_attention`` with ``d_qk`` 192 against
``d_v`` 128, restricted on the card to the backends that take unequal
head sizes without materialising the scores (:func:`_sdpa`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models import layers as L

__all__ = ["is_mla", "init_mla", "rope_tables", "attention"]


def is_mla(cfg) -> bool:
    """Whether ``cfg`` has latent attention (``kv_lora_rank`` > 0)."""
    return getattr(cfg, "kv_lora_rank", 0) > 0


def init_mla(key, cfg, dtype) -> dict:
    """MLA's weights in draw order ``split(key, 5)``: ``wq_a`` (D,
    q_lora_rank), ``wq_b`` (q_lora_rank, H (d_nope + d_rope)), ``wkv_a`` (D,
    kv_lora_rank + d_rope), ``wkv_b`` (kv_lora_rank, H (d_nope + d_v)),
    ``wo`` (H d_v, D), LeCun-normal; the two norm scales zeros."""
    D, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    ks = prng.split(key, 5)
    dev = key.device
    return {
        "wq_a": L.dense_init(ks[0], (D, qr), dtype=dtype),
        "q_norm": torch.zeros((qr,), dtype=dtype, device=dev),
        "wq_b": L.dense_init(ks[1], (qr, H * (dn + dr)), dtype=dtype),
        "wkv_a": L.dense_init(ks[2], (D, kvr + dr), dtype=dtype),
        "kv_norm": torch.zeros((kvr,), dtype=dtype, device=dev),
        "wkv_b": L.dense_init(ks[3], (kvr, H * (dn + dv)), dtype=dtype),
        "wo": L.dense_init(ks[4], (H * dv, D), dtype=dtype),
    }


def rope_tables(cfg, device) -> tuple:
    """``(inv_freq, rotary magnitude, softmax scale)`` of ``cfg``'s YaRN:
    the magnitude ``m(s, mscale) / m(s, mscale_all_dim)`` multiplies the
    rotated parts (1 for Kimi K2); the scale is ``qk_head_dim^-0.5 m(s,
    mscale_all_dim)^2``."""
    s = cfg.rope_factor
    inv = L.yarn_freqs(cfg.qk_rope_head_dim, cfg.rope_theta, s,
                       cfg.rope_original_max_position, cfg.rope_beta_fast,
                       cfg.rope_beta_slow, device)
    mag = L.yarn_mscale(s, cfg.rope_mscale) / L.yarn_mscale(
        s, cfg.rope_mscale_all_dim)
    scale = L.yarn_softmax_scale(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                                 s, cfg.rope_mscale_all_dim)
    return inv, mag, scale


def _sdpa(q, k, v, scale):
    """Causal attention in one fused call. On the card cuDNN's fused
    attention, else the memory-efficient kernel, never the math backend
    (which builds the ``(S, S)`` scores): at ``(4, 64, 4096)`` with
    ``d_qk`` 192 and ``d_v`` 128 in bf16, forward and backward took 10.3
    ms with cuDNN, 24 ms with flash on ``v`` zero-padded to 192 and 80 ms
    with the memory-efficient kernel (PERF.md); flash itself refuses
    unequal head sizes."""
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION], set_priority=True):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=scale)
    return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          scale=scale)


def attention(x, p, cfg, positions, tables):
    """MLA over ``x (B, S, D)``: ``(B, S, D)`` in ``x``'s dtype. ``tables``
    is :func:`rope_tables`'s, made once a forward."""
    B, S, _ = x.shape
    H = cfg.n_heads
    kvr = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    inv, mag, scale = tables
    cq = L.rmsnorm(torch.matmul(x, p["wq_a"]), p["q_norm"])
    q = torch.matmul(cq, p["wq_b"]).reshape(B, S, H, dn + dr)
    kv = torch.matmul(x, p["wkv_a"])
    ckv = L.rmsnorm(kv[..., :kvr], p["kv_norm"])
    k_rope = kv[..., kvr:].reshape(B, S, 1, dr)
    kvb = torch.matmul(ckv, p["wkv_b"]).reshape(B, S, H, dn + dv)
    q_rope = L.rotate(q[..., dn:], positions, inv)
    k_rope = L.rotate(k_rope, positions, inv)
    if mag != 1.0:
        q_rope, k_rope = q_rope * mag, k_rope * mag
    q = torch.cat([q[..., :dn], q_rope], dim=-1)
    k = torch.cat([kvb[..., :dn], k_rope.expand(B, S, H, dr)], dim=-1)
    v = kvb[..., dn:]
    o = _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale)
    o = o.transpose(1, 2).reshape(B, S, H * dv)
    return torch.matmul(o, p["wo"])
