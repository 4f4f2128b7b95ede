"""GQA attention: training (full / sliding-window) and cached decode
(port of ``repro.models.attention``).

* ``attend_train``: full causal, sliding-window causal, or non-causal
  attention over ``(B, S, H, hd)`` projections, the score matrix
  materialized.
* ``attend_train_blockwise``: the same with an online softmax over
  key/value blocks (never the whole ``(Sq, Sk)`` matrix).
* ``decode_attend_full`` / ``decode_attend_ring``: one-token decode
  against a KV cache. Full caches are ``(B, S_max, KVH, hd)`` with
  positions ``<= pos`` valid; sliding-window caches are ring buffers
  ``(B, W, KVH, hd)`` indexed ``pos % W``.

Plain tensor operations, as the reference's are plain ``jnp``: the
reference's mask (``NEG_INF``, not ``-inf``) and float32 softmax are kept,
so no fused attention call stands in for them. Scores are scaled by
``1/sqrt(hd)``. Decode positions are Python ints (or 0-d tensors).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "NEG_INF", "attend_train", "attend_train_blockwise", "attend",
    "decode_attend_full", "decode_attend_ring", "update_cache_full",
    "update_cache_ring",
]

NEG_INF = -1e30


def _scores(q, k):  # q (B,Sq,H,hd) k (B,Sk,KVH,hd) -> (B,H,Sq,Sk)
    B, Sq, H, hd = q.shape
    KVH = k.shape[2]
    rep = H // KVH
    qg = q.reshape(B, Sq, KVH, rep, hd)
    s = torch.einsum("bqgrh,bkgh->bgrqk", qg.to(torch.float32),
                     k.to(torch.float32))
    return s.reshape(B, KVH * rep, Sq, k.shape[1]) / math.sqrt(hd)


def _combine(p, v, H):  # p (B,H,Sq,Sk), v (B,Sk,KVH,hd) -> (B,Sq,H,hd)
    B, _, Sq, Sk = p.shape
    KVH = v.shape[2]
    rep = H // KVH
    pg = p.reshape(B, KVH, rep, Sq, Sk)
    o = torch.einsum("bgrqk,bkgh->bqgrh", pg, v.to(torch.float32))
    return o.reshape(B, Sq, H, v.shape[-1])


def _mask(qpos, kpos, causal: bool, window: int):
    mask = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                      dtype=torch.bool, device=qpos.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def attend_train(q, k, v, *, causal: bool = True, window: int = 0):
    """Full-materialized attention. ``window > 0`` adds a sliding-window
    mask."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    s = _scores(q, k)
    if causal or window:
        dev = q.device
        qpos = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk, device=dev)[None, :]
        mask = _mask(qpos, kpos, causal, window)
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _combine(p, v, H).to(q.dtype)


def attend_train_blockwise(q, k, v, *, causal: bool = True, window: int = 0,
                           block_q: int = 512, block_kv: int = 1024):
    """Flash-style blockwise attention with an online softmax.

    Peak live set per layer is ``O(block_q x block_kv)`` scores plus
    ``O(Sq x hd)`` accumulators. Masked blocks are still computed, as in
    the reference's scan.
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    KVH = k.shape[2]
    rep = H // KVH
    assert Sq % block_q == 0 and Sk % block_kv == 0, (Sq, Sk, block_q, block_kv)
    nq, nk = Sq // block_q, Sk // block_kv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qb = q.reshape(B, nq, block_q, KVH, rep, hd)
    kb = k.reshape(B, nk, block_kv, KVH, hd)
    vb = v.reshape(B, nk, block_kv, KVH, hd)
    offs = Sk - Sq  # query positions offset (prefill: 0)

    outs = []
    for i in range(nq):
        qi = qb[:, i].to(torch.float32)  # (B, bq, KVH, rep, hd)
        qpos = i * block_q + torch.arange(block_q, device=dev)[:, None] + offs
        m = torch.full((B, KVH, rep, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KVH, rep, block_q), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((B, KVH, rep, block_q, hd), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            kpos = j * block_kv + torch.arange(block_kv, device=dev)[None, :]
            s = torch.einsum("bqgrh,bkgh->bgrqk", qi,
                             kb[:, j].to(torch.float32)) * scale
            mask = _mask(qpos, kpos, causal, window)
            s = torch.where(mask[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgh->bgrqh", p, vb[:, j].to(torch.float32))
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)  # (B,KVH,rep,bq,hd)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B,bq,KVH,rep,hd)
    ob = torch.stack(outs, dim=1)  # (B,nq,bq,KVH,rep,hd)
    return ob.reshape(B, Sq, H, hd).to(q.dtype)


def _pick_block(seq: int, target: int) -> int:
    """Largest power-of-two-ish divisor of ``seq`` not above ``target``."""
    for b in (target, target // 2, target // 4, target // 8, 64, 32):
        if b and seq % b == 0:
            return b
    return 0


def attend(q, k, v, *, causal=True, window=0, impl="naive", block_q=512,
           block_kv=1024):
    """``attend_train`` or, with ``impl="blockwise"`` and block sizes that
    divide the sequence, ``attend_train_blockwise``."""
    if impl == "blockwise":
        bq = _pick_block(q.shape[1], block_q)
        bk = _pick_block(k.shape[1], block_kv)
        if bq and bk:
            return attend_train_blockwise(q, k, v, causal=causal,
                                          window=window, block_q=bq,
                                          block_kv=bk)
    return attend_train(q, k, v, causal=causal, window=window)


def decode_attend_full(q, k_cache, v_cache, pos):
    """One query ``(B, 1, H, hd)`` against a full cache; slots ``<= pos``
    are live."""
    s = _scores(q, k_cache)  # (B,H,1,S_max)
    pos = int(pos)
    valid = torch.arange(k_cache.shape[1], device=q.device) <= pos
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _combine(p, v_cache, q.shape[2]).to(q.dtype)


def decode_attend_ring(q, k_ring, v_ring, pos):
    """Sliding-window decode: slots holding positions in
    ``(pos - W, pos]`` are live."""
    W = k_ring.shape[1]
    pos = int(pos)
    s = _scores(q, k_ring)  # (B,H,1,W)
    slot = torch.arange(W, device=q.device)
    # absolute position currently stored in each slot
    cycle = (pos // W) * W
    abs_pos = torch.where(slot <= (pos % W), cycle + slot, cycle - W + slot)
    valid = (abs_pos >= 0) & (abs_pos >= pos - W + 1) & (abs_pos <= pos)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _combine(p, v_ring, q.shape[2]).to(q.dtype)


def _updated(cache, new, slot: int):
    out = cache.clone()
    out[:, slot:slot + 1] = new.to(cache.dtype)
    return out


def update_cache_full(k_cache, v_cache, k_new, v_new, pos):
    """New caches with one token's K/V ``(B, 1, KVH, hd)`` at ``pos`` (the
    inputs are left as they are, as the reference's functional update)."""
    pos = int(pos)
    return _updated(k_cache, k_new, pos), _updated(v_cache, v_new, pos)


def update_cache_ring(k_ring, v_ring, k_new, v_new, pos):
    """New ring caches with one token's K/V at slot ``pos % W``."""
    slot = int(pos) % k_ring.shape[1]
    return _updated(k_ring, k_new, slot), _updated(v_ring, v_new, slot)
