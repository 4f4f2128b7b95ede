"""Gray-coded square-QAM modulation with unequal bit protection (port).

Counterpart of ``repro.core.modulation``. Symbol index bits alternate
between the I and Q axes MSB-first (b0 -> I Gray MSB, b1 -> Q Gray MSB,
...), so the float's sign and exponent bits ride the best-protected
positions (paper Table I). ``demod_hard`` is the closed-form ML detector on
equalized symbols; ``demod_ml`` the brute-force oracle.

Arithmetic contract: every float operation is the reference's, in its
order, as separate IEEE-rounded float32 operations on the real and
imaginary parts (no complex kernels, whose vectorised and scalar forms
round differently), so the results do not depend on a tensor's layout or
device. ``modulate`` and ``demod_hard`` match the reference exactly on
equal inputs. ``demod_ml`` and ``bit_llrs`` square distances as
``re*re + im*im`` where the reference takes ``abs(.)**2``: equal to an ULP
or two.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import channel as channel_lib
from repro_torch.core import prng

__all__ = [
    "ModScheme",
    "MOD_SCHEMES",
    "scheme_for_bits",
    "gray_encode",
    "gray_decode",
    "constellation",
    "modulate",
    "demod_hard",
    "demod_ml",
    "decision_margin",
    "bit_llrs",
    "rayleigh_qpsk_ber",
    "measure_ber",
    "popcount",
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


def _f32(v: float) -> float:
    """``v`` rounded to float32: tensor-by-scalar products use that value."""
    return float(np.float32(v))


def _split_axes(sym: torch.Tensor, scheme: ModScheme):
    """Symbol index -> (I Gray bits, Q Gray bits), alternating allocation."""
    p, k = scheme.bits_per_axis, scheme.bits_per_symbol
    sym = sym.to(torch.int64)
    gi = torch.zeros_like(sym)
    gq = torch.zeros_like(sym)
    for j in range(p):
        # bit positions within the symbol index, MSB-first: even -> I, odd -> Q
        gi = gi | (((sym >> (k - 1 - 2 * j)) & 1) << (p - 1 - j))
        gq = gq | (((sym >> (k - 2 - 2 * j)) & 1) << (p - 1 - j))
    return gi, gq


def _merge_axes(gi: torch.Tensor, gq: torch.Tensor,
                scheme: ModScheme) -> torch.Tensor:
    """Inverse of :func:`_split_axes`."""
    p, k = scheme.bits_per_axis, scheme.bits_per_symbol
    sym = torch.zeros_like(gi)
    for j in range(p):
        sym = sym | (((gi >> (p - 1 - j)) & 1) << (k - 1 - 2 * j))
        sym = sym | (((gq >> (p - 1 - j)) & 1) << (k - 2 - 2 * j))
    return sym


def _points(sym: torch.Tensor, scheme: ModScheme):
    """(I, Q) float32 amplitudes of symbol indices."""
    L, amp = scheme.levels, _f32(scheme.amp_norm)
    gi, gq = _split_axes(sym, scheme)
    li = gray_decode(gi).to(torch.float32)
    lq = gray_decode(gq).to(torch.float32)
    return (2.0 * li - (L - 1)) * amp, (2.0 * lq - (L - 1)) * amp


def modulate(sym: torch.Tensor, scheme: ModScheme) -> torch.Tensor:
    """Symbol indices -> complex64 constellation points (unit avg energy)."""
    return torch.complex(*_points(sym, scheme))


def constellation(scheme: ModScheme, device=None) -> torch.Tensor:
    """The full constellation, indexed by symbol value: ``(M,)`` complex64."""
    return modulate(torch.arange(scheme.points, device=device), scheme)


def _pre_round(x: torch.Tensor, scheme: ModScheme) -> torch.Tensor:
    """The demod's value before rounding: ``(x * inv + (L-1)) * 0.5``."""
    inv = _f32(1.0 / scheme.amp_norm)
    return (x * inv + (scheme.levels - 1)) * 0.5


def demod_hard(y_eq: torch.Tensor, scheme: ModScheme) -> torch.Tensor:
    """Closed-form ML detection on equalized symbols -> symbol indices.

    Per axis: round half to even, clip to the PAM grid (a NaN lands on
    level 0, as XLA's float -> uint32 conversion puts it), Gray-encode."""
    L = scheme.levels

    def axis_level(x):
        lvl = torch.round(_pre_round(x, scheme)).clamp(0, L - 1)
        return torch.nan_to_num(lvl, nan=0.0).to(torch.int64)

    gi = gray_encode(axis_level(y_eq.real))
    gq = gray_encode(axis_level(y_eq.imag))
    return _merge_axes(gi, gq, scheme)


def decision_margin(y_eq: torch.Tensor, scheme: ModScheme) -> torch.Tensor:
    """Distance of each symbol's demod pre-round values (the nearer of I
    and Q) to the nearest decision edge, a half-integer inside the PAM
    grid, where :func:`demod_hard` changes its mind.
    An input this close to an edge may decide differently under another
    implementation's last-ULP rounding; tests use it to excuse exactly
    those symbols."""
    def edge(x):
        v = _pre_round(x, scheme)
        vc = v.clamp(0, scheme.levels - 1)  # beyond the grid: no edge
        return (vc - torch.floor(vc) - 0.5).abs() + (v - vc).abs()

    return torch.minimum(edge(y_eq.real), edge(y_eq.imag))


def _dist2(y_eq: torch.Tensor, scheme: ModScheme) -> torch.Tensor:
    """Squared distance of each symbol to every constellation point,
    ``(..., M)``."""
    pr, pi = _points(torch.arange(scheme.points, device=y_eq.device), scheme)
    dr = y_eq.real[..., None] - pr
    di = y_eq.imag[..., None] - pi
    return dr * dr + di * di


def demod_ml(y_eq: torch.Tensor, scheme: ModScheme) -> torch.Tensor:
    """Brute-force nearest-point ML detection (oracle; paper eq. (8))."""
    return torch.argmin(_dist2(y_eq, scheme), dim=-1)


def bit_llrs(y_eq: torch.Tensor, noise_var: torch.Tensor,
             scheme: ModScheme) -> torch.Tensor:
    """Per-bit max-log LLRs ``(..., k)`` for soft decoding (ECRT path):
    ``LLR(b) = min_{b=1} d2 - min_{b=0} d2`` with ``d2 = |y - p|^2 / nv``."""
    k = scheme.bits_per_symbol
    nv = torch.clamp_min(noise_var, _f32(1e-12))
    d2 = _dist2(y_eq, scheme) / nv[..., None]
    idx = torch.arange(scheme.points, device=y_eq.device)
    llrs = []
    for j in range(k):
        bit = (idx >> (k - 1 - j)) & 1
        m0 = torch.where(bit == 0, d2, math.inf).amin(dim=-1)
        m1 = torch.where(bit == 1, d2, math.inf).amin(dim=-1)
        llrs.append(m1 - m0)
    return torch.stack(llrs, dim=-1)


def rayleigh_qpsk_ber(snr_db: float) -> float:
    """Closed-form QPSK BER over flat Rayleigh fading, coherent detection.

    ``snr_db`` is the average received symbol SNR Es/N0 (the paper quotes
    4e-2 @ 10 dB and 5e-3 @ 20 dB): with gamma_b = Es/N0 / 2,
    Pb = 1/2 (1 - sqrt(gamma_b / (1 + gamma_b))).
    """
    gamma_b = 10.0 ** (snr_db / 10.0) / 2.0
    return 0.5 * (1.0 - math.sqrt(gamma_b / (1.0 + gamma_b)))


def measure_ber(key: torch.Tensor, scheme: ModScheme, snr_db: float,
                n_symbols: int = 1 << 17, fading: str = "rayleigh",
                device=None) -> torch.Tensor:
    """Empirical BER of the full mod/channel/demod chain (no coding), on
    ``device`` (``None`` is the GPU); a float32 scalar tensor."""
    key = key.to(resolve_device(device))
    k_sym, k_ch = prng.split(key)
    sym = prng.randint(k_sym, (n_symbols,), 0, scheme.points)
    cfg = channel_lib.ChannelConfig(snr_db=snr_db, fading=fading)
    r, c = channel_lib.transmit(modulate(sym, scheme), k_ch, cfg)
    rx = demod_hard(channel_lib.equalize(r, c), scheme)
    nbits = popcount(sym ^ rx).sum().to(torch.float32)
    # XLA turns the reference's division by this constant into a multiply
    # by its float32 reciprocal: so does this.
    return nbits * (1.0 / (n_symbols * scheme.bits_per_symbol))


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of ``uint32`` values held in ``int64``."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24
