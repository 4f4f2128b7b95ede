"""RecurrentGemma-2B — Griffin: RG-LRU + local attention 1:2
[arXiv:2402.19427].

26 layers, pattern (rec, rec, attn) repeating; d_model 2560, 10 heads
(MQA kv=1), GeGLU d_ff 7680, local window 2048, vocab 256000.
"""

from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        attn_period=3,
        local_window=2048,
        lru_width=2560,
        source="arXiv:2402.19427",
    )
