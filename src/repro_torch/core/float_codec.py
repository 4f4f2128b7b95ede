"""Float <-> word bitcasts, symbol packing and the receiver's clamp (port).

Counterpart of ``repro.core.float_codec`` (paper Sec. IV-A): f32/bf16 <->
word bitcasts, MSB-first k-bit symbols (``words_to_symbols`` and its
inverse), the row-column symbol interleaver, and the certified exponent
clamp. Words are ``int64`` tensors holding ``uint32`` values (``uint16``
for the bf16 wire), because PyTorch has no ``uint32`` shift on the CPU;
everything here is integer work and matches the reference exactly.

The packing and interleave functions take any leading batch dimensions
(the reference's take one payload; its batch path vmaps them).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "f32_to_bits",
    "bits_to_f32",
    "bf16_to_bits",
    "bits_to_bf16",
    "words_to_symbols",
    "symbols_to_words",
    "interleave",
    "deinterleave",
    "exponent_clamp_mask",
    "exponent_clamp_mask16",
    "clamp_exponent_bits",
    "clamp_exponent_bits16",
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


def _symbol_shifts(bits_per_symbol: int, word_bits: int, device):
    k = bits_per_symbol
    if word_bits % k != 0:
        raise ValueError(f"bits_per_symbol={k} must divide {word_bits}")
    s = torch.arange(word_bits // k, dtype=torch.int64, device=device)
    return word_bits - k * (s + 1)


def words_to_symbols(u: torch.Tensor, bits_per_symbol: int,
                     word_bits: int = 32) -> torch.Tensor:
    """Split words ``(..., N)`` into symbol indices ``(..., N, word_bits/k)``,
    MSB-first: the more significant float bit lands in the higher bit of
    the symbol index."""
    shifts = _symbol_shifts(bits_per_symbol, word_bits, u.device)
    return (u.to(torch.int64)[..., None] >> shifts) & ((1 << bits_per_symbol) - 1)


def symbols_to_words(sym: torch.Tensor, bits_per_symbol: int,
                     word_bits: int = 32) -> torch.Tensor:
    """Inverse of :func:`words_to_symbols`: ``(..., N, S) -> (..., N)``.

    The reference sums the shifted fields in ``uint32``; the fields are
    disjoint, so the ``int64`` sum here is the same OR of them."""
    shifts = _symbol_shifts(bits_per_symbol, word_bits, sym.device)
    fields = (sym.to(torch.int64) & ((1 << bits_per_symbol) - 1)) << shifts
    return fields.sum(dim=-1) & 0xFFFFFFFF


def interleave(sym: torch.Tensor) -> torch.Tensor:
    """Row-column symbol interleaver: ``(..., N, S)`` symbols of N words
    read column-major into the stream ``(..., S*N)``, so adjacent airtime
    symbols come from different words."""
    return sym.transpose(-1, -2).reshape(sym.shape[:-2] + (-1,))


def deinterleave(stream: torch.Tensor, n_words: int,
                 s_per_word: int) -> torch.Tensor:
    """Inverse of :func:`interleave`: ``(..., S*N) -> (..., N, S)``."""
    lead = stream.shape[:-1]
    return stream.reshape(lead + (s_per_word, n_words)).transpose(-1, -2)


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


def clamp_exponent_bits(u: torch.Tensor, bound: float = 2.0) -> torch.Tensor:
    """Force provably-zero exponent bits to 0 in received f32 words
    (paper Fig. 1)."""
    return u & exponent_clamp_mask(bound)


def clamp_exponent_bits16(u: torch.Tensor, bound: float = 2.0) -> torch.Tensor:
    """bf16 receiver clamp: force provably-zero exponent bits to 0."""
    return u & exponent_clamp_mask16(bound)
