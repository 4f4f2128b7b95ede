"""PyTorch/CUDA port of the approximate-wireless-communication FL system.

The package mirrors the layout of the JAX package ``repro`` module for
module (``repro_torch.core.transport`` is the counterpart of
``repro.core.transport`` and so on) and imports neither ``jax`` nor
``repro``. The two hand-written CUDA kernels of the uplink live in
``repro_torch.kernels``; everything else is plain PyTorch.

Device policy. Every entry point (``run_fl``, ``run_fedavg``,
``RoundEngine``, the ``transmit_*`` functions) runs on the GPU unless the caller passes
``device="cpu"``. Without a GPU, a call that did not ask for the CPU
raises: nothing falls back to the CPU silently. Resolving a CUDA device
also switches TF32 off for matmuls and cuDNN convolutions, so float32
means float32 on the card.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device. ``"cpu"`` (or a CPU
    ``torch.device``) is honoured as given. A CUDA device without a GPU
    raises ``RuntimeError``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
