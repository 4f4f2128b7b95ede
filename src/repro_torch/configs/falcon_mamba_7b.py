"""Falcon-Mamba-7B — attention-free Mamba-1 SSM [arXiv:2410.05355].

64 layers, d_model 4096, expand 2 (inner 8192), ssm_state 16, conv 4.
Constant-size recurrent state => runs long_500k decode natively.
"""

from repro_torch.configs.base import ModelConfig, register


@register("falcon-mamba-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        vocab_size=65024,
        ssm_state=16,
        ssm_conv=4,
        expand=2,
        source="arXiv:2410.05355",
    )
