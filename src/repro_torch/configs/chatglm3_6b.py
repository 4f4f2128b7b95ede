"""ChatGLM3-6B — dense decoder, 2D-RoPE (partial rotary, fraction 0.5),
GQA kv=2, QKV bias [arXiv:2406.12793]."""

from repro_torch.configs.base import ModelConfig, register


@register("chatglm3-6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        rope_fraction=0.5,
        qkv_bias=True,
        source="arXiv:2406.12793",
    )
