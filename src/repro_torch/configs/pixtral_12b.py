"""Pixtral-12B — ViT frontend (STUB) + Mistral-Nemo-style decoder
[hf:mistralai/Pixtral-12B-2409].

The vision encoder is a stub per the brief: ``input_specs()`` supplies
precomputed patch embeddings (n_patches x vision_dim); the framework
implements the projector + 40-layer language decoder (GQA kv=8).
"""

from repro_torch.configs.base import ModelConfig, register


@register("pixtral-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        n_patches=256,
        vision_dim=1024,
        rope_theta=1e6,
        source="hf:mistralai/Pixtral-12B-2409",
    )
