"""Kimi K2 — trillion-parameter MoE (paper-table config) [arXiv:2501.kimi2].

61 layers, d_model 7168, 64 heads (GQA kv=8, head_dim 128), MoE with 384
experts top-8 (expert d_ff 2048) + 1 shared expert; the first layer is dense
(d_ff 18432, the DeepSeek-V3-style warm dense layer). Vocab 163840.
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
