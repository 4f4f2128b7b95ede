"""Plain PyTorch reference of Kimi K2 (Kimi-K2-Instruct, arXiv:2507.20534;
the DeepSeek-V3 design) on one expert-parallel rank's share, for training:
the forward, the mean next-token loss with the sequence-wise balance loss,
and the gradients. Float32 throughout, TF32 off; it imports nothing of the
program. The configuration is read under the published config's own keys
(``portbench/configs/kimi-k2-instruct.json``).

Written out here:

* multi-head latent attention, the training form: ``c_q = RMSNorm(x
  W_dq)``, ``q = c_q W_uq`` split per head into ``q_nope`` and ``q_rope``;
  ``[c_kv, k_rope] = x W_dkv``, ``c_kv = RMSNorm(c_kv)``, ``[k_nope, v] =
  c_kv W_ukv``; one ``k_rope`` a token for all heads; explicit scores
  ``(H, S, S)`` with a causal mask, softmax, ``o W_o``;
* YaRN: ``f_e = theta^(-2i/d)``, ``f_i = f_e / s``, ``corr(b) = d ln(L0 /
  (2 pi b)) / (2 ln theta)``, ``low = floor(corr(beta_fast))``, ``high =
  ceil(corr(beta_slow))``, ``ramp = clip((i - low) / (high - low), 0,
  1)``, ``inv = f_i ramp + f_e (1 - ramp)``; cos and sin times ``m(s,
  mscale) / m(s, mscale_all_dim)``, ``m(s, a) = 0.1 a ln s + 1``; the
  softmax scale ``(d_nope + d_rope)^-0.5 m(s, mscale_all_dim)^2``;
* the router (``noaux_tc``, one group): ``s = sigmoid(h W_r)`` over all
  ``n_routed_experts``, the top ``num_experts_per_tok`` of ``s + b``, the
  weights ``s[sel] / sum s[sel] * routed_scaling_factor``; the balance
  loss per sequence ``alpha * sum_i f_i P_i``, ``f_i = E / (K S) * #{t: i
  in sel_t}``, ``P_i = mean_t s_it / sum_j s_jt``, the mean over
  sequences, summed over the MoE layers;
* the held experts ``[expert_offset, expert_offset + n_experts_held)`` in
  a plain loop, dropless: each on every token routed to it, weighted and
  added into its tokens; the shared expert on every token; the dense
  first layer; the head over the held vocabulary slice.

Departures from the published model, as in the program
(``src/repro_torch/configs/kimi_k2_instruct.py``): the correction bias is
drawn from the seed (``normal(fold_in(PRNGKey(seed), 0xB1A5), (L, E)) *
router_bias_std``) and held fixed; alpha = 1e-4 is assumed (DeepSeek-V3's);
no multi-token prediction (``num_nextn_predict_layers`` 0); norm scales
are zero-centred (``1 + scale``, zeros at init) and the rotary embedding
turns adjacent pairs, the port's conventions (the published code's
de-interleave then rotate-half gives the same scores).

The weights follow the program's tree and draw order (threefry,
LeCun-normal in float32, ``std = 1/sqrt(fan_in)``, the embedding 0.02,
cast to bfloat16; the router kept in float32): ``split(key, 8)``,
``embed <- ks[0]``, ``lm_head <- ks[1]``, dense layer ``i <- split(ks[3],
n_dense)[i]``, MoE layer ``i <- split(ks[4], n_moe)[i]``; a layer ``->
split(., 2)`` = (attention, FFN); attention ``-> split(., 5)`` for
``wq_a, wq_b, wkv_a, wkv_b, wo``; the dense FFN ``-> split(., 3)`` for
``wi, wg, wo``; the MoE FFN ``-> split(., 3)`` = (router, experts,
shared), expert ``e`` of all ``E`` ``<- split(experts, E)[e] -> split(.,
3)``, shared ``-> split(., 3)``.

``precision="fp8"`` is the comparison's control: every weight matmul's
operands rounded to float8 e4m3 under a per-tensor scale. The loss and the
gradients are taken one sequence at a time, each layer under
``torch.utils.checkpoint`` and the scores 16 heads at a time, the
gradients accumulated in place, so that the float32 scores of a
4,096-token sequence fit beside the model (and, for the control, beside
the program) on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import threefry as prng
from portbench.reference.qwen2 import _fp8, flat_leaves, leaf_names

__all__ = ["init_params", "correction_bias", "loss_and_grads",
           "yarn_inv_freq", "softmax_scale", "route", "balance",
           "routing_notes",
           "leaf_names", "flat_leaves", "shapes"]

_BIAS_TAG = 0xB1A5
# heads whose (S, S) scores are made at once (16 x 4,096^2 float32: 1 GiB)
_HEADS = 16


def shapes(cfg: dict) -> dict:
    """The widths the reference reads, by the published keys."""
    H = cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    return dict(
        D=cfg["hidden_size"], V=cfg["vocab_size"],
        L=cfg["num_hidden_layers"], nd=cfg["first_k_dense_replace"], H=H,
        qr=cfg["q_lora_rank"], kvr=cfg["kv_lora_rank"], dn=dn, dr=dr,
        dv=cfg["v_head_dim"], Fd=cfg["intermediate_size"],
        Fe=cfg["moe_intermediate_size"], E=cfg["n_routed_experts"],
        K=cfg["num_experts_per_tok"], Eh=cfg["n_experts_held"],
        off=cfg.get("expert_offset", 0), Fs=cfg["moe_intermediate_size"]
        * cfg["n_shared_experts"])


def _dense(key, shape, dtype):
    return (prng.normal(key, shape) * (1.0 / math.sqrt(shape[-2]))).to(dtype)


def _mla(key, w, dt):
    ks = prng.split(key, 5)
    dev = key.device
    D, H, qr, kvr = w["D"], w["H"], w["qr"], w["kvr"]
    dn, dr, dv = w["dn"], w["dr"], w["dv"]
    return {"wq_a": _dense(ks[0], (D, qr), dt),
            "q_norm": torch.zeros((qr,), dtype=dt, device=dev),
            "wq_b": _dense(ks[1], (qr, H * (dn + dr)), dt),
            "wkv_a": _dense(ks[2], (D, kvr + dr), dt),
            "kv_norm": torch.zeros((kvr,), dtype=dt, device=dev),
            "wkv_b": _dense(ks[3], (kvr, H * (dn + dv)), dt),
            "wo": _dense(ks[4], (H * dv, D), dt)}


def _swiglu_init(key, D, F_, dt):
    ks = prng.split(key, 3)
    return {"wi": _dense(ks[0], (D, F_), dt), "wg": _dense(ks[1], (D, F_), dt),
            "wo": _dense(ks[2], (F_, D), dt)}


def _moe(key, w, dt):
    ks = prng.split(key, 3)
    ek = prng.split(ks[1], w["E"])
    experts = [_swiglu_init(ek[w["off"] + j], w["D"], w["Fe"], dt)
               for j in range(w["Eh"])]
    p = {"router": (prng.normal(ks[0], (w["D"], w["E"]))
                    * (1.0 / math.sqrt(w["D"]))),
         "shared": _swiglu_init(ks[2], w["D"], w["Fs"], dt)}
    for name in ("wi", "wg", "wo"):
        p[name] = torch.stack([e[name] for e in experts])
    return p


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([l[k] for l in layers]) for k in layers[0]}
    return torch.stack(layers)


def init_params(key, cfg: dict) -> dict:
    """Weights of ``cfg`` in its ``dtype`` (bfloat16 as published; the
    router float32) from ``key``, made on the key's device."""
    w = shapes(cfg)
    D, V, L, nd = w["D"], w["V"], w["L"], w["nd"]
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    dev = key.device
    ks = prng.split(key, 8)

    def norms():
        return {"ln1": torch.zeros((D,), dtype=dt, device=dev),
                "ln2": torch.zeros((D,), dtype=dt, device=dev)}

    dense = []
    for k in prng.split(ks[3], nd):
        k1, k2 = prng.split(k)
        dense.append({**norms(), "attn": _mla(k1, w, dt),
                      "mlp": _swiglu_init(k2, D, w["Fd"], dt)})
    moe = []
    for k in prng.split(ks[4], L - nd):
        k1, k2 = prng.split(k)
        moe.append({**norms(), "attn": _mla(k1, w, dt),
                    "moe": _moe(k2, w, dt)})
    return {"embed": (prng.normal(ks[0], (V, D)) * 0.02).to(dt),
            "final_norm": torch.zeros((D,), dtype=dt, device=dev),
            "lm_head": _dense(ks[1], (D, V), dt),
            "dense_layers": _stack(dense), "layers": _stack(moe)}


def correction_bias(seed: int, cfg: dict, device=None) -> torch.Tensor:
    """The seeded, fixed correction bias ``(n_moe_layers, E)`` float32."""
    w = shapes(cfg)
    key = prng.fold_in(prng.PRNGKey(seed, device=device), _BIAS_TAG)
    return prng.normal(key, (w["L"] - w["nd"], w["E"])) * cfg["router_bias_std"]


def _mscale(s: float, a: float) -> float:
    return 0.1 * a * math.log(s) + 1.0 if s > 1 else 1.0


def yarn_inv_freq(cfg: dict, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies of the rotary part, written out."""
    r = cfg["rope_scaling"]
    d, theta, s = cfg["qk_rope_head_dim"], float(cfg["rope_theta"]), r["factor"]
    i = torch.arange(d // 2, dtype=torch.float64, device=device)
    f_e = theta ** (-2.0 * i / d)
    f_i = f_e / s
    L0 = r["original_max_position_embeddings"]

    def corr(b):
        return d * math.log(L0 / (2 * math.pi * b)) / (2 * math.log(theta))

    low = max(math.floor(corr(r["beta_fast"])), 0)
    high = min(math.ceil(corr(r["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((i - low) / (high - low), 0, 1)
    return (f_i * ramp + f_e * (1 - ramp)).to(torch.float32)


def softmax_scale(cfg: dict) -> float:
    r = cfg["rope_scaling"]
    m = _mscale(r["factor"], r["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def _rope(x, inv, mag):
    """Adjacent-pair rotary embedding of ``(S, H, d)``."""
    S = x.shape[0]
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = (torch.cos(ang) * mag)[:, None, :]
    sin = (torch.sin(ang) * mag)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def _rms(x, scale):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * (1.0 + scale)


def _mm(x, w, fp8: bool):
    return _fp8(x) @ _fp8(w) if fp8 else x @ w


def _swiglu(x, p, fp8, j=None):
    g = (lambda n: p[n]) if j is None else (lambda n: p[n][j])
    return _mm(F.silu(_mm(x, g("wg"), fp8)) * _mm(x, g("wi"), fp8), g("wo"),
               fp8)


def _attention(x, a, w, rope, fp8):
    S = x.shape[0]
    H, kvr, dn, dr, dv = w["H"], w["kvr"], w["dn"], w["dr"], w["dv"]
    inv, mag, scale = rope
    q = _mm(_rms(_mm(x, a["wq_a"], fp8), a["q_norm"]), a["wq_b"],
            fp8).reshape(S, H, dn + dr)
    kv = _mm(x, a["wkv_a"], fp8)
    kvb = _mm(_rms(kv[:, :kvr], a["kv_norm"]), a["wkv_b"],
              fp8).reshape(S, H, dn + dv)
    k_rope = _rope(kv[:, kvr:].reshape(S, 1, dr), inv, mag).expand(S, H, dr)
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], inv, mag)], dim=-1)
    k = torch.cat([kvb[..., :dn], k_rope], dim=-1)
    v = kvb[..., dn:]
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    o = []
    for h in range(0, H, _HEADS):  # explicit scores, a block of heads at once
        hs = slice(h, h + _HEADS)
        scores = torch.einsum("qhd,khd->hqk", q[:, hs], k[:, hs]) * scale
        scores = scores.masked_fill(~causal, float("-inf"))
        o.append(torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1),
                              v[:, hs]))
    return _mm(torch.cat(o, dim=1).reshape(S, H * dv), a["wo"], fp8)


def route(h, router, bias, cfg: dict):
    """``(s, sel, weights)`` of one sequence's ``(S, D)`` float32 inputs."""
    s = torch.sigmoid(h @ router)
    sel = torch.topk(s + bias, cfg["num_experts_per_tok"], dim=-1).indices
    top = torch.gather(s, 1, sel)
    return s, sel, top / top.sum(-1, keepdim=True) * cfg["routed_scaling_factor"]


def balance(s, sel, E: int):
    """One sequence's ``sum_i f_i P_i`` (without alpha)."""
    S, K = sel.shape
    f = torch.bincount(sel.reshape(-1), minlength=E).to(s.dtype) * (E / (K * S))
    P = (s / s.sum(-1, keepdim=True)).mean(0)
    return (f * P).sum()


def _moe_ffn(h, m, bias, w, cfg, fp8):
    s, sel, wts = route(h, m["router"], bias, cfg)
    out = torch.zeros_like(h)
    for j in range(w["Eh"]):
        tok, slot = torch.nonzero(sel == w["off"] + j, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(h[tok], m, fp8, j)
        out = out.index_add(0, tok, y * wts[tok, slot][:, None])
    return out + _swiglu(h, m["shared"], fp8), balance(s, sel, w["E"])


def _dense_layer(x, p, w, rope, fp8):
    x = x + _attention(_rms(x, p["ln1"]), p["attn"], w, rope, fp8)
    return x + _swiglu(_rms(x, p["ln2"]), p["mlp"], fp8)


def _moe_layer(x, p, bias, w, cfg, rope, fp8):
    x = x + _attention(_rms(x, p["ln1"]), p["attn"], w, rope, fp8)
    out, bal = _moe_ffn(_rms(x, p["ln2"]), p["moe"], bias, w, cfg, fp8)
    return x + out, bal


def _unbind(tree):
    if isinstance(tree, dict):
        return {k: _unbind(v) for k, v in tree.items()}
    return tree.unbind(0)


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def _rope_tables(cfg: dict, device):
    r = cfg["rope_scaling"]
    return (yarn_inv_freq(cfg, device),
            _mscale(r["factor"], r["mscale"])
            / _mscale(r["factor"], r["mscale_all_dim"]),
            softmax_scale(cfg))


def _seq_loss(p, tokens, labels, bias, cfg, fp8):
    """One sequence's mean cross-entropy plus ``alpha`` times its balance
    losses, under float32 ``p``."""
    w = shapes(cfg)
    dev = tokens.device
    rope = _rope_tables(cfg, dev)
    x = p["embed"][tokens]
    dense, moe = _unbind(p["dense_layers"]), _unbind(p["layers"])
    for i in range(w["nd"]):
        x = checkpoint(_dense_layer, x, _pick(dense, i), w, rope, fp8,
                       use_reentrant=False)
    bal = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(w["L"] - w["nd"]):
        x, b = checkpoint(_moe_layer, x, _pick(moe, i), bias[i], w, cfg, rope,
                          fp8, use_reentrant=False)
        bal = bal + b
    logits = _mm(_rms(x, p["final_norm"]), p["lm_head"], fp8)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    nll = (torch.logsumexp(logits, dim=-1) - gold).mean()
    return nll + cfg["seq_aux_alpha"] * bal


def _f32_tree(tree):
    """Float32 copies of the leaves, each a leaf that takes gradients (a
    copy also of a float32 leaf: the caller's tensors are left as they
    are)."""
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    return tree.detach().to(torch.float32, copy=True).requires_grad_()


def loss_and_grads(params, tokens, labels, bias, cfg: dict, *,
                   precision: str = "fp32", rows=None):
    """``(loss, grads)``: the mean loss over the batch (balance loss
    included) and its float32 gradient leaves in sorted-key order.
    ``rows`` limits the batch to its first rows."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"precision {precision!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fp8 = precision == "fp8"
    p = _f32_tree(params)
    leaves = flat_leaves(p)
    B = tokens.shape[0] if rows is None else rows
    total = 0.0
    for b in range(B):
        # each sequence's gradients accumulate into the leaves' .grad
        loss = _seq_loss(p, tokens[b].long(), labels[b].long(), bias, cfg,
                         fp8) / B
        loss.backward()
        total += float(loss.detach().double())
        del loss
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in leaves]
    for t in leaves:
        t.grad = None
    return total, grads


@torch.no_grad()
def routing_notes(params, tokens, bias, cfg: dict) -> dict:
    """Of one sequence's forward: the share of the routed selections that
    the correction bias changes (against the top ``K`` of the scores
    alone), the mean over the MoE layers; and the busiest held expert's
    load over the capacity a router that drops would give it
    (``int(S K 1.5 / E) + 1``), the largest over the layers."""
    w = shapes(cfg)
    S, K, E = tokens.shape[0], w["K"], w["E"]
    C = min(max(int(S * K * 1.5 / E) + 1, 8), S)
    p = _f32_tree(params)
    rope = _rope_tables(cfg, tokens.device)
    x = p["embed"][tokens]
    dense, moe = _unbind(p["dense_layers"]), _unbind(p["layers"])
    for i in range(w["nd"]):
        x = _dense_layer(x, _pick(dense, i), w, rope, False)
    changed, over = [], []
    for i in range(w["L"] - w["nd"]):
        pl = _pick(moe, i)
        x = x + _attention(_rms(x, pl["ln1"]), pl["attn"], w, rope, False)
        h = _rms(x, pl["ln2"])
        s, sel, _ = route(h, pl["moe"]["router"], bias[i], cfg)
        plain = torch.topk(s, K, dim=-1).indices
        same = (sel[:, :, None] == plain[:, None, :]).any(-1)
        changed.append(1.0 - float(same.float().mean()))
        loads = torch.bincount(sel.reshape(-1), minlength=E)
        over.append(float(loads[w["off"]:w["off"] + w["Eh"]].max()) / C)
        out, _ = _moe_ffn(h, pl["moe"], bias[i], w, cfg, False)
        x = x + out
    return {"bias_changed_share": sum(changed) / len(changed),
            "held_load_over_capacity": max(over)}
