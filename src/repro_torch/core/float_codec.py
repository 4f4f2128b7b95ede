"""Float <-> word bitcasts and the receiver's exponent clamp (port).

Counterpart of ``repro.core.float_codec`` for the slice of it the kernel
path needs: f32/bf16 <-> word bitcasts and the certified exponent masks
(``exponent_clamp_mask``, ``exponent_clamp_mask16``). Words are ``int64``
tensors holding ``uint32`` values (``uint16`` for the bf16 wire), because
PyTorch has no ``uint32`` shift on the CPU. ``words_to_symbols`` and the
stream interleaver belong to the layered PHY, which is not ported yet.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "f32_to_bits",
    "bits_to_f32",
    "bf16_to_bits",
    "bits_to_bf16",
    "exponent_clamp_mask",
    "exponent_clamp_mask16",
]


def f32_to_bits(x: torch.Tensor) -> torch.Tensor:
    """Bitcast float32 -> ``uint32`` words held in ``int64`` (same shape)."""
    w = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return w & 0xFFFFFFFF


def bits_to_f32(u: torch.Tensor) -> torch.Tensor:
    """Bitcast ``uint32`` words (any integer dtype) -> float32."""
    u = u.to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def bf16_to_bits(x: torch.Tensor) -> torch.Tensor:
    """Bitcast bfloat16 -> ``uint16`` words held in ``int64``."""
    w = x.to(torch.bfloat16).contiguous().view(torch.int16).to(torch.int64)
    return w & 0xFFFF


def bits_to_bf16(u: torch.Tensor) -> torch.Tensor:
    """Bitcast ``uint16`` words (any integer dtype) -> bfloat16."""
    u = u.to(torch.int64) & 0xFFFF
    u = torch.where(u >= 1 << 15, u - (1 << 16), u)
    return u.to(torch.int16).view(torch.bfloat16)


def exponent_clamp_mask(bound: float) -> int:
    """AND-mask forcing exponent bits that are provably 0 for |g| < bound.

    The paper's scheme (bound <= 2) clears only bit 30; tighter bounds
    clear the top ``j`` exponent bits such that the largest biased exponent
    ``E_max = 127 + ceil(log2(bound)) - 1`` fits in ``8 - j`` bits.
    """
    if bound <= 0:
        raise ValueError("bound must be positive")
    e_max = 127 + math.ceil(math.log2(bound)) - 1
    e_max = max(0, min(254, e_max))
    j = 8 - max(1, e_max.bit_length())  # leading exponent bits that must be 0
    mask = 0xFFFFFFFF
    for b in range(j):
        mask &= ~(1 << (30 - b))
    return mask


def exponent_clamp_mask16(bound: float) -> int:
    """bf16 analogue of :func:`exponent_clamp_mask` (exponent bits 14..7)."""
    return (exponent_clamp_mask(bound) >> 16) & 0xFFFF
