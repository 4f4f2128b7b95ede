"""Kimi K2's name on the reference package's table config, mirrored field
for field (``source`` included, which the parity tests compare).

It is not Kimi K2 as published: 61 layers, d_model 7168, 64 heads with
grouped-query attention (8 KV heads, head_dim 128), a softmax router with
capacity drops over 384 experts top-8 (expert d_ff 2048) + 1 shared
expert, every expert held; the first layer is dense (d_ff 18432). Vocab
163840. The published model (multi-head latent attention, YaRN, the
sigmoid ``noaux_tc`` router, dropless) is the port-only
``kimi-k2-instruct`` (``configs/kimi_k2_instruct.py``).
"""

from repro_torch.configs.base import ModelConfig, register


@register("kimi-k2-1t-a32b")
def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=0,
        vocab_size=163840,
        n_experts=384,
        top_k=8,
        moe_d_ff=2048,
        n_shared_experts=1,
        dense_d_ff=18432,
        first_dense_layers=1,
        rope_theta=5e4,
        source="arXiv:2501.kimi2",
    )
