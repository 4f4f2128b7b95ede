"""Config registry of the port: one module per assigned architecture (+ the
paper's CNN).

Counterpart of ``repro.configs``. Importing this package registers every
architecture, and the port-only ``kimi-k2-instruct``
(``configs/kimi_k2_instruct.py``, which ``get_config`` finds and
``list_configs`` does not list); ``--arch <id>`` in the launchers resolves through
:func:`repro_torch.configs.get_config`.
"""

from repro_torch.configs.base import (
    ModelConfig,
    InputShape,
    INPUT_SHAPES,
    get_config,
    list_configs,
    register,
)

# architecture modules (registration side effects)
from repro_torch.configs import kimi_k2_1t_a32b  # noqa: F401
from repro_torch.configs import yi_6b  # noqa: F401
from repro_torch.configs import pixtral_12b  # noqa: F401
from repro_torch.configs import chatglm3_6b  # noqa: F401
from repro_torch.configs import falcon_mamba_7b  # noqa: F401
from repro_torch.configs import recurrentgemma_2b  # noqa: F401
from repro_torch.configs import whisper_large_v3  # noqa: F401
from repro_torch.configs import phi35_moe_42b_a66b  # noqa: F401
from repro_torch.configs import qwen2_1_5b  # noqa: F401
from repro_torch.configs import deepseek_coder_33b  # noqa: F401
from repro_torch.configs import mnist_cnn  # noqa: F401
# port-only (not in list_configs / ARCH_IDS)
from repro_torch.configs import kimi_k2_instruct  # noqa: F401

__all__ = ["ModelConfig", "InputShape", "INPUT_SHAPES", "get_config",
           "list_configs", "register", "ARCH_IDS"]

ARCH_IDS = [
    "kimi-k2-1t-a32b",
    "yi-6b",
    "pixtral-12b",
    "chatglm3-6b",
    "falcon-mamba-7b",
    "recurrentgemma-2b",
    "whisper-large-v3",
    "phi3.5-moe-42b-a6.6b",
    "qwen2-1.5b",
    "deepseek-coder-33b",
]
