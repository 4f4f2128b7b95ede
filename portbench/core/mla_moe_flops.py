"""The MLA moe cells' yardstick arithmetic, from the configuration's
published keys (``configs/kimi-k2-instruct.json``): parameters,
``6 * N_active * tokens`` of a training step, and the held experts' FLOPs
an assignment.

``N_active`` counts every matrix and norm scale a token's forward
multiplies, as ``roofline.dense_param_counts`` does for the dense family:
per layer the two norm scales and MLA (its two latent norms included);
the dense layer's SwiGLU; per MoE layer the router (all routed outputs)
and the shared expert whole, and each held expert at the expected
``top_k / n_routed_experts`` evaluations a token; the final norm and the
head. The embedding table is gathered, not multiplied: not active. The
fixed correction bias is no parameter. Attention's score and value
products are not in ``6 N``.
"""

from __future__ import annotations

__all__ = ["param_counts", "train_flops", "expert_flops_per_assignment"]


def _mla(c: dict) -> int:
    D, H = c["hidden_size"], c["num_attention_heads"]
    qr, kvr = c["q_lora_rank"], c["kv_lora_rank"]
    dn, dr, dv = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    return (D * qr + qr + qr * H * (dn + dr) + D * (kvr + dr) + kvr
            + kvr * H * (dn + dv) + H * dv * D)


def param_counts(c: dict) -> tuple[float, float]:
    """``(active, total)`` parameters of the configuration as held."""
    D, V = c["hidden_size"], c["vocab_size"]
    L, nd = c["num_hidden_layers"], c["first_k_dense_replace"]
    E, Eh, K = c["n_routed_experts"], c["n_experts_held"], \
        c["num_experts_per_tok"]
    expert = 3 * D * c["moe_intermediate_size"]
    shared = expert * c["n_shared_experts"]
    attn = 2 * D + _mla(c)
    dense = attn + 3 * D * c["intermediate_size"]
    moe_fixed = attn + D * E + shared
    head = D + D * V
    active = nd * dense + (L - nd) * (moe_fixed + Eh * expert * K / E) + head
    total = nd * dense + (L - nd) * (moe_fixed + Eh * expert) + head + V * D
    return float(active), float(total)


def train_flops(c: dict, tokens: int) -> float:
    """``6 * N_active * tokens`` of one training step."""
    return 6.0 * param_counts(c)[0] * tokens


def expert_flops_per_assignment(c: dict) -> float:
    """A held expert's SwiGLU on one token, forward and backward: ``6 * 3
    * D * moe_intermediate_size``."""
    return 6.0 * 3 * c["hidden_size"] * c["moe_intermediate_size"]
