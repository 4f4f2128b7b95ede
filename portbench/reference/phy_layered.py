"""Frozen copy of the port's layered PHY for one uncoded batch, as the
paper's driverless rounds run it with ``use_kernel=False``
(``src/repro_torch/core/transport.py::_uncoded`` over
``core/float_codec.py``, ``core/modulation.py`` and ``core/channel.py``):

    float32 words -> MSB-first k-bit symbols -> row-column interleave
    -> Gray square-QAM -> Rayleigh fading and noise drawn with threefry
    normals (``key -> (k_h, k_n)``, each ``-> (re, im)``) -> zero-forcing
    equalisation (Smith's algorithm) -> closed-form ML demod
    -> deinterleave -> words -> exponent clamp -> popcount bit errors.

The operations are the port's, one by one and in its order, on real and
imaginary parts held apart (the port builds complex tensors and reads
their parts back, which leaves the values as they are). Only the path
this benchmark drives is kept: a scalar SNR, Rayleigh or AWGN fading,
no chunking, a float32 wire.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import phy_tile
from portbench.reference import threefry as prng

__all__ = ["uncoded_batch"]


def _f32(v: float) -> float:
    return float(np.float32(v))


def _split_axes(sym, k):
    p = k // 2
    gi = torch.zeros_like(sym)
    gq = torch.zeros_like(sym)
    for j in range(p):
        gi = gi | (((sym >> (k - 1 - 2 * j)) & 1) << (p - 1 - j))
        gq = gq | (((sym >> (k - 2 - 2 * j)) & 1) << (p - 1 - j))
    return gi, gq


def _merge_axes(gi, gq, k):
    p = k // 2
    sym = torch.zeros_like(gi)
    for j in range(p):
        sym = sym | (((gi >> (p - 1 - j)) & 1) << (k - 1 - 2 * j))
        sym = sym | (((gq >> (p - 1 - j)) & 1) << (k - 2 - 2 * j))
    return sym


def _gray_decode(g):
    for shift in (1, 2, 4, 8, 16):
        g = g ^ (g >> shift)
    return g


def _points(sym, k):
    L = 1 << (k // 2)
    amp = _f32(math.sqrt(3.0 / (2.0 * (L * L - 1))))
    gi, gq = _split_axes(sym, k)
    li = _gray_decode(gi).to(torch.float32)
    lq = _gray_decode(gq).to(torch.float32)
    return (2.0 * li - (L - 1)) * amp, (2.0 * lq - (L - 1)) * amp


def _cn(key, shape, var):
    kr, ki = prng.split_batched(key)
    s = torch.sqrt(torch.as_tensor(var / 2.0, dtype=torch.float32,
                                   device=key.device))
    return prng.normal(kr, shape) * s, prng.normal(ki, shape) * s


def _channel(sr, si, keys, *, fading, large_scale_gain, noise_power):
    """``channel.transmit`` then ``channel.equalize``: equalised ``(yr, yi)``."""
    n_sym = sr.shape[-1]
    k_h, k_n = prng.split_batched(keys)
    amp = float(torch.sqrt(torch.as_tensor(large_scale_gain,
                                           dtype=torch.float32)))
    if fading == "awgn":
        hr = torch.ones(keys.shape[:-1] + (n_sym,), device=sr.device)
        hi = torch.zeros_like(hr)
    elif fading == "rayleigh":
        hr, hi = _cn(k_h, (n_sym,), 1.0)
    else:
        raise ValueError(f"fading {fading!r} is not on the benchmark's path")
    cr, ci = hr * amp, hi * amp
    nr, ni = _cn(k_n, (n_sym,), noise_power)
    rr = (cr * sr - ci * si) + nr
    ri = (cr * si + ci * sr) + ni
    big = cr.abs() >= ci.abs()
    rat = torch.where(big, ci / cr, cr / ci)
    den = torch.where(big, cr + ci * rat, ci + cr * rat)
    yr = torch.where(big, rr + ri * rat, rr * rat + ri) / den
    yi = torch.where(big, ri - rr * rat, ri * rat - rr) / den
    return yr, yi


def _demod(yr, yi, k):
    L = 1 << (k // 2)
    inv = _f32(1.0 / math.sqrt(3.0 / (2.0 * (L * L - 1))))

    def level(x):
        lvl = torch.round((x * inv + (L - 1)) * 0.5).clamp(0, L - 1)
        return torch.nan_to_num(lvl, nan=0.0).to(torch.int64)

    li, lq = level(yr), level(yi)
    return _merge_axes(li ^ (li >> 1), lq ^ (lq >> 1), k)


def uncoded_batch(x, keys, *, bits_per_symbol, fading, large_scale_gain,
                  noise_power, clamp_mask, interleave=True):
    """``(C, N)`` float32 payloads through C layered uplinks keyed ``keys``
    ``(C, 2)``: ``(x_hat (C, N) float32, bit_errors (C,) int64)``."""
    k, wb = bits_per_symbol, 32
    c, n = x.shape
    s_per_word = wb // k
    u = phy_tile.f32_to_bits(x)
    shifts = wb - k * (torch.arange(s_per_word, dtype=torch.int64,
                                    device=x.device) + 1)
    sym = (u[..., None] >> shifts) & ((1 << k) - 1)            # (C, N, S)
    stream = (sym.transpose(-1, -2).reshape(c, -1) if interleave
              else sym.reshape(c, -1))
    sr, si = _points(stream, k)
    yr, yi = _channel(sr, si, keys.to(x.device), fading=fading,
                      large_scale_gain=large_scale_gain,
                      noise_power=noise_power)
    rx = _demod(yr, yi, k)
    rx = (rx.reshape(c, s_per_word, n).transpose(-1, -2) if interleave
          else rx.reshape(c, n, s_per_word))
    u_hat = (((rx & ((1 << k) - 1)) << shifts).sum(dim=-1)
             & 0xFFFFFFFF) & clamp_mask
    errs = phy_tile.popcount(u ^ u_hat).sum(dim=-1)
    return phy_tile.bits_to_f32(u_hat), errs
