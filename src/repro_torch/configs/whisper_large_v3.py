"""Whisper-large-v3 — encoder-decoder transformer [arXiv:2212.04356].

Conv/mel frontend is a STUB per the brief: ``input_specs()`` provides
precomputed frame embeddings (encoder_seq=1500 x d_model). We implement the
32+32 layer enc-dec backbone (d_model 1280, 20 heads, full attention,
learned positions). long_500k is SKIPPED (enc-dec full attention; see
DESIGN.md Sec. 4).
"""

from repro_torch.configs.base import ModelConfig, register


@register("whisper-large-v3")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        encoder_layers=32,
        encoder_seq=1500,
        max_position=40960,
        source="arXiv:2212.04356",
    )
