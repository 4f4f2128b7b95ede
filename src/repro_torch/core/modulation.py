"""Gray-coded square-QAM schemes (port, part).

Counterpart of ``repro.core.modulation`` for what the kernel path needs:
the scheme table and the Gray maps. Symbol index bits alternate between
the I and Q axes MSB-first (b0 -> I Gray MSB, b1 -> Q Gray MSB, ...), so
the float's sign and exponent bits ride the best-protected positions.
``modulate``/``demod_*``/``bit_llrs`` belong to the layered PHY, which is
not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "ModScheme",
    "MOD_SCHEMES",
    "scheme_for_bits",
    "gray_encode",
    "gray_decode",
]


@dataclasses.dataclass(frozen=True)
class ModScheme:
    """Static description of a square-QAM scheme."""

    name: str
    bits_per_symbol: int  # k

    @property
    def bits_per_axis(self) -> int:
        """Bits per I/Q axis (``k / 2`` for square QAM)."""
        return self.bits_per_symbol // 2

    @property
    def levels(self) -> int:
        """``L``: PAM levels per axis."""
        return 1 << self.bits_per_axis

    @property
    def points(self) -> int:
        """``M = L^2`` constellation points."""
        return 1 << self.bits_per_symbol

    @property
    def amp_norm(self) -> float:
        """Scale so the constellation has unit average symbol energy."""
        L = self.levels
        return math.sqrt(3.0 / (2.0 * (L * L - 1)))


MOD_SCHEMES = {
    "qpsk": ModScheme("qpsk", 2),
    "16qam": ModScheme("16qam", 4),
    "64qam": ModScheme("64qam", 6),
    "256qam": ModScheme("256qam", 8),
}


def scheme_for_bits(k: int) -> ModScheme:
    """The registered square-QAM scheme with ``bits_per_symbol == k``."""
    for s in MOD_SCHEMES.values():
        if s.bits_per_symbol == k:
            return s
    raise ValueError(f"unsupported bits_per_symbol={k}")


def gray_encode(n: torch.Tensor) -> torch.Tensor:
    """Binary-reflected Gray code of a level index (integer tensor)."""
    return n ^ (n >> 1)


def gray_decode(g: torch.Tensor) -> torch.Tensor:
    """Inverse Gray code for values below 2**32 (integer tensor)."""
    for shift in (1, 2, 4, 8, 16):
        g = g ^ (g >> shift)
    return g
