"""Yi-6B — llama-architecture dense decoder with GQA [arXiv:2403.04652]."""

from repro_torch.configs.base import ModelConfig, register


@register("yi-6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5e6,
        source="arXiv:2403.04652",
    )
