"""Models of the port: every family of the reference (``transformer``:
dense, moe, vlm, hybrid, with the expert FFN in ``moe``; ``ssm``; ``audio``),
their building blocks and the family registry."""

from repro_torch.models import audio, ssm  # noqa: F401
