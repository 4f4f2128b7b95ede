"""Plain PyTorch reference of a Qwen2 dense decoder (arXiv:2407.10671):
RMSNorm, rotary positions (theta 1e6), grouped-query attention with a
bias on Q, K and V, SwiGLU, the output head tied to the embedding (or
a head of its own where the configuration says ``tie_embeddings:
false``), mean next-token cross-entropy. Float32 throughout, TF32 off;
it imports nothing of the program.

It follows the port's parameter conventions, since it is held against
the port's own weights and the bits it sends:

* a norm's scale is zero-centred (``x * rsqrt(mean(x^2) + 1e-6) * (1 +
  scale)``, zeros at init, where the published model keeps ``scale``
  itself, ones at init);
* rotary embedding turns adjacent pairs ``(x[2i], x[2i+1])`` of each head
  (the published code rotates the two halves of the head);
* layer leaves are stacked ``(L, ...)`` and the tree's leaves, in sorted
  key order, are the uplink's payload order;
* weights are drawn with the threefry schedule, LeCun-normal in float32
  (``std = 1/sqrt(fan_in)``; embedding ``0.02``), cast to bfloat16 as the
  configuration states: ``split(key, 8)``, ``embed <- ks[0]``,
  ``lm_head <- ks[1]`` (untied only), layer
  ``i <- split(ks[2], L)[i] -> (attn, mlp)``, ``attn -> split(., 4)`` for
  ``wq, wk, wv, wo``, ``mlp -> split(., 3)`` for ``wi, wg, wo``; biases
  and norm scales zeros.

``precision="fp8"`` is the comparison's control: every matmul's operands
rounded to float8 e4m3 under a per-tensor scale (``amax / 448``), the
step below the configuration's bfloat16.

The loss and the gradient are taken one sequence at a time and the
gradients summed, so that the float32 activations of a 1,024-token
sequence fit beside the model.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import threefry as prng

__all__ = ["init_params", "structure", "loss_and_grads", "loss_only",
           "leaf_names", "flat_leaves"]

_F8_MAX = 448.0


def _dense(key, shape, dtype):
    return (prng.normal(key, shape) * (1.0 / math.sqrt(shape[-2]))).to(dtype)


def init_params(key, cfg: dict) -> dict:
    """bfloat16 weights of ``cfg`` from ``key``, made on the key's device."""
    dt = torch.bfloat16
    D, V, L = cfg["d_model"], cfg["vocab_size"], cfg["n_layers"]
    H, KVH, Fd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    hd = cfg.get("head_dim") or D // H
    dev = key.device
    ks = prng.split(key, 8)
    params = {
        "embed": (prng.normal(ks[0], (V, D)) * 0.02).to(dt),
        "final_norm": torch.zeros((D,), dtype=dt, device=dev),
    }
    if not cfg.get("tie_embeddings", False):
        params["lm_head"] = _dense(ks[1], (D, V), dt)
    shapes = {"wq": (D, H * hd), "wk": (D, KVH * hd), "wv": (D, KVH * hd),
              "wo": (H * hd, D)}
    mlp_shapes = {"wi": (D, Fd), "wg": (D, Fd), "wo": (Fd, D)}
    layers = {
        "ln1": torch.zeros((L, D), dtype=dt, device=dev),
        "ln2": torch.zeros((L, D), dtype=dt, device=dev),
        "attn": {k: torch.empty((L,) + s, dtype=dt, device=dev)
                 for k, s in shapes.items()},
        "mlp": {k: torch.empty((L,) + s, dtype=dt, device=dev)
                for k, s in mlp_shapes.items()},
    }
    for b, n in (("bq", H * hd), ("bk", KVH * hd), ("bv", KVH * hd)):
        layers["attn"][b] = torch.zeros((L, n), dtype=dt, device=dev)
    lk = prng.split(ks[2], L)
    for i in range(L):
        k1, k2 = prng.split(lk[i])
        ka = prng.split(k1, 4)
        for j, name in enumerate(("wq", "wk", "wv", "wo")):
            layers["attn"][name][i] = _dense(ka[j], shapes[name], dt)
        km = prng.split(k2, 3)
        for j, name in enumerate(("wi", "wg", "wo")):
            layers["mlp"][name][i] = _dense(km[j], mlp_shapes[name], dt)
    params["layers"] = layers
    return params


def structure(cfg: dict) -> dict:
    """The tree of ``init_params``, with ``None`` for each leaf."""
    tree = {"embed": None, "final_norm": None,
            "layers": {"ln1": None, "ln2": None,
                       "attn": dict.fromkeys(("wq", "wk", "wv", "wo",
                                              "bq", "bk", "bv")),
                       "mlp": dict.fromkeys(("wi", "wg", "wo"))}}
    if not cfg.get("tie_embeddings", False):
        tree["lm_head"] = None
    return tree


def leaf_names(tree, prefix="") -> list:
    """Leaf paths in sorted-key order (the uplink's payload order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaf_names(tree[k], f"{prefix}{k}.")
        return out
    return [prefix[:-1]]


def flat_leaves(tree) -> list:
    """Leaves in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flat_leaves(tree[k])
        return out
    return [tree]


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / _F8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32)
    return x + (q * scale - x).detach()


def _mm(x, w, fp8: bool):
    if fp8:
        return _fp8(x) @ _fp8(w)
    return x @ w


def _rms(x, scale):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * (1.0 + scale)


def _rope(x, theta: float):
    """Adjacent-pair rotary embedding of ``(S, H, hd)``."""
    S, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def _unbind(tree):
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return tree.unbind(0)


def _seq_loss(p, tokens, labels, cfg, fp8):
    """Mean cross-entropy of one sequence ``(S,)`` under float32 ``p``."""
    D, H, KVH = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or D // H
    S = tokens.shape[0]
    x = p["embed"][tokens]
    # one unbind a leaf: the backward stacks each leaf's layer gradients once
    lay = _unbind(p["layers"])
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    for i in range(cfg["n_layers"]):
        a = lay["attn"]
        h = _rms(x, lay["ln1"][i])
        q = (_mm(h, a["wq"][i], fp8) + a["bq"][i]).reshape(S, H, hd)
        k = (_mm(h, a["wk"][i], fp8) + a["bk"][i]).reshape(S, KVH, hd)
        v = (_mm(h, a["wv"][i], fp8) + a["bv"][i]).reshape(S, KVH, hd)
        q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
        k = k.repeat_interleave(H // KVH, dim=1)
        v = v.repeat_interleave(H // KVH, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
        x = x + _mm(o.reshape(S, H * hd), a["wo"][i], fp8)
        m = lay["mlp"]
        h = _rms(x, lay["ln2"][i])
        g = F.silu(_mm(h, m["wg"][i], fp8)) * _mm(h, m["wi"][i], fp8)
        x = x + _mm(g, m["wo"][i], fp8)
    head = p["lm_head"] if "lm_head" in p else p["embed"].T
    logits = _mm(_rms(x, p["final_norm"]), head, fp8)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def _f32_tree(tree, grad: bool):
    if isinstance(tree, dict):
        return {k: _f32_tree(v, grad) for k, v in tree.items()}
    t = tree.to(torch.float32)
    return t.requires_grad_() if grad else t


def loss_and_grads(params, tokens, labels, cfg: dict, *,
                   precision: str = "fp32", rows=None):
    """``(loss, grads)``: the mean next-token loss over the batch and its
    float32 gradient leaves in sorted-key order. ``rows`` limits the batch
    to its first rows (the benchmark's "half of the batch" fault)."""
    fp8 = precision == "fp8"
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"precision {precision!r}")
    p = _f32_tree(params, True)
    leaves = flat_leaves(p)
    B = tokens.shape[0] if rows is None else rows
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    grads = None
    for b in range(B):
        loss = _seq_loss(p, tokens[b].long(), labels[b].long(), cfg, fp8) / B
        g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
        grads = list(g) if grads is None else [a + c for a, c in zip(grads, g)]
        total += loss.detach().double()
    return float(total), grads


@torch.no_grad()
def loss_only(params, tokens, labels, cfg: dict) -> float:
    """The mean next-token loss of float32 ``params``."""
    p = _f32_tree(params, False)
    B = tokens.shape[0]
    total = 0.0
    for b in range(B):
        total += float(_seq_loss(p, tokens[b].long(), labels[b].long(), cfg,
                                 False).double()) / B
    return total
