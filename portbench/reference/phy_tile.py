"""Frozen copy of the per-tile PHY chain that the CUDA kernels K0, K1 and
K2 compute (``src/repro_torch/kernels/ref.py``, with the bit casts of
``core/float_codec.py`` and ``popcount`` of ``core/modulation.py``), copied
as they stood:

    bitcast -> MSB-first k-bit symbols -> in-tile interleave -> Gray QAM
    -> Rayleigh/AWGN channel from a counter RNG (murmur3 finalizer +
    Box-Muller) -> zero-forcing equalise -> per-axis ML demod -> words
    -> exponent clamp -> popcount bit errors.

Every float operation is a separate IEEE-rounded operation, and
``log``/``sqrt``/``cos``/``sin`` are PyTorch's, which on CUDA are the
libdevice routines the kernels call, so on one card this chain and the
kernels give the same bits. Words are ``int64`` tensors holding
``uint32`` values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.threefry import M32, mul32

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


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of ``uint32`` values held in ``int64``."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24



# Streams for the counter RNG (arbitrary odd constants, as the reference).
_STREAM_NOISE = 0x9E3779B9
_STREAM_FADE = 0x7FEB352D
_STREAM_PHASE = 0x68E31DA4

# float32 constants, held as the Python floats they round to, so every
# tensor-by-scalar product below is a float32 product by that value.
_TWO_PI = float(np.float32(6.283185307179586))
_INV_2_24 = 1.0 / 16777216.0
_HALF_ULP = 2.0**-25
_HS = float(np.sqrt(np.float32(0.5)))
_TINY = float(np.float32(1e-20))


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer — a well-mixed 32-bit hash."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def hash_u32(seed: torch.Tensor, idx: torch.Tensor, stream: int) -> torch.Tensor:
    """``fmix32(seed ^ fmix32(idx * 0x9E3779B9 + stream))`` in uint32."""
    inner = (mul32(idx, 0x9E3779B9) + stream) & M32
    return fmix32(seed ^ fmix32(inner))


def uniform01(h: torch.Tensor) -> torch.Tensor:
    """uint32 hash -> uniform float32 in (0, 1]."""
    return (h >> 8).to(torch.float32) * _INV_2_24 + _HALF_ULP


def gauss_pair(seed: torch.Tensor, idx: torch.Tensor, stream: int):
    """Two iid N(0,1) float32 via Box-Muller on counter-RNG uniforms."""
    u1 = uniform01(hash_u32(seed, idx, stream))
    u2 = uniform01(hash_u32(seed, idx, stream ^ _STREAM_PHASE))
    r = torch.sqrt(-2.0 * torch.log(u1))
    ang = u2 * _TWO_PI
    return r * torch.cos(ang), r * torch.sin(ang)


def gray_encode(n: torch.Tensor) -> torch.Tensor:
    """Binary-reflected Gray code."""
    return n ^ (n >> 1)


def gray_decode(g: torch.Tensor) -> torch.Tensor:
    """Inverse Gray code for axis indices below 2**8."""
    for s in (1, 2, 4):
        g = g ^ (g >> s)
    return g


def _axis_level(y: torch.Tensor, inv: float, L: int):
    """Closed-form ML demod of one axis: ``(pre-round value, level)``."""
    v = (y * inv + (L - 1)) * 0.5
    return v, torch.round(v).clamp(0, L - 1).to(torch.int64)


def channel_tile(u, seed, base_sym, noise_power, large_scale_gain, *,
                 bits_per_symbol: int, fading: str, fade_block: int,
                 block_words: int, word_bits: int = 32):
    """Shared tile body: words -> noisy received words (pre-clamp).

    Args:
      u: ``(..., BW)`` ``int64`` words of whole tiles (low ``word_bits``).
      seed / base_sym: ``int64`` tensors broadcasting against ``(..., 1)``
        — the client's RNG seed and the global index of the tile's first
        symbol.
      noise_power / large_scale_gain: float32, broadcasting like ``seed``.

    Returns ``u_hat`` ``(..., BW)``.
    """
    k = bits_per_symbol
    p = k // 2
    L = 1 << p
    bw = block_words
    if u.shape[-1] != bw:
        raise ValueError(f"tile width {u.shape[-1]} != block_words {bw}")
    s_per_word = word_bits // k
    amp = math.sqrt(3.0 / (2.0 * (L * L - 1)))
    amp32 = float(np.float32(amp))
    inv = float(np.float32(1.0 / amp))
    dev = u.device

    # words -> symbols, MSB-first: (..., BW, S)
    s_idx = torch.arange(s_per_word, dtype=torch.int64, device=dev)
    shifts = word_bits - k * (s_idx + 1)
    sym = (u[..., None] >> shifts) & ((1 << k) - 1)

    # split to Gray axis bits (alternating I/Q allocation, MSB-first)
    gi = torch.zeros_like(sym)
    gq = torch.zeros_like(sym)
    for j in range(p):
        gi = gi | (((sym >> (k - 1 - 2 * j)) & 1) << (p - 1 - j))
        gq = gq | (((sym >> (k - 2 - 2 * j)) & 1) << (p - 1 - j))
    s_re = (2.0 * gray_decode(gi).to(torch.float32) - (L - 1)) * amp32
    s_im = (2.0 * gray_decode(gq).to(torch.float32) - (L - 1)) * amp32

    # global symbol index in transmit order: base + s*BW + w (uint32 wrap)
    w_idx = torch.arange(bw, dtype=torch.int64, device=dev)[:, None]
    gidx = (base_sym[..., None] + s_idx * bw + w_idx) & M32
    seed = seed[..., None]

    # channel: r = c s + n ; receiver equalizes y = s + n/c
    n_re, n_im = gauss_pair(seed, gidx, _STREAM_NOISE)
    nscale = torch.sqrt(noise_power * 0.5)[..., None]
    n_re = n_re * nscale
    n_im = n_im * nscale
    sg = torch.sqrt(large_scale_gain)[..., None]
    if fading == "awgn":
        c_re = sg * torch.ones_like(s_re)
        c_im = torch.zeros_like(s_re)
    elif fading in ("rayleigh", "block_rayleigh"):
        fidx = gidx // fade_block if fading == "block_rayleigh" else gidx
        h_re, h_im = gauss_pair(seed, fidx, _STREAM_FADE)
        c_re = sg * h_re * _HS
        c_im = sg * h_im * _HS
    else:
        raise ValueError(f"unknown fading {fading!r}")
    c2 = torch.clamp_min(c_re * c_re + c_im * c_im, _TINY)
    # n / c = n * conj(c) / |c|^2
    y_re = s_re + (n_re * c_re + n_im * c_im) / c2
    y_im = s_im + (n_im * c_re - n_re * c_im) / c2

    v_re, li_hat = _axis_level(y_re, inv, L)
    v_im, lq_hat = _axis_level(y_im, inv, L)
    gi_hat = gray_encode(li_hat)
    gq_hat = gray_encode(lq_hat)
    rx = torch.zeros_like(sym)
    for j in range(p):
        rx = rx | (((gi_hat >> (p - 1 - j)) & 1) << (k - 1 - 2 * j))
        rx = rx | (((gq_hat >> (p - 1 - j)) & 1) << (k - 2 - 2 * j))
    # reassemble words (symbols occupy disjoint bits, so a sum is an OR)
    return (rx << shifts).sum(dim=-1)


def _wire_bits(x: torch.Tensor, word_bits: int) -> torch.Tensor:
    if word_bits == 16:
        return bf16_to_bits(x)
    return f32_to_bits(x)


def _from_wire_bits(u: torch.Tensor, word_bits: int) -> torch.Tensor:
    if word_bits == 16:
        return bits_to_bf16(u)
    return bits_to_f32(u)


def _active_rows(num_active, c: int) -> int:
    if num_active is None:
        return c
    return max(0, min(c, int(num_active)))


def _rows(x, seeds, noise_powers, gains, *, bits_per_symbol, fading,
          fade_block, clamp_mask, block_words, word_bits, rows):
    """Words and received words (clamped) of the first ``rows`` clients."""
    c, n = x.shape
    if n % block_words != 0:
        raise ValueError(
            f"N={n} must be a multiple of block_words={block_words}")
    tiles = n // block_words
    s_per_word = word_bits // bits_per_symbol
    u = _wire_bits(x[:rows], word_bits).reshape(rows, tiles, block_words)
    base = (torch.arange(tiles, dtype=torch.int64, device=x.device)
            * (block_words * s_per_word)) & M32
    u_hat = channel_tile(
        u,
        seeds[:rows].to(torch.int64).reshape(rows, 1, 1) & M32,
        base.reshape(1, tiles, 1),
        noise_powers[:rows].to(torch.float32).reshape(rows, 1, 1),
        gains[:rows].to(torch.float32).reshape(rows, 1, 1),
        bits_per_symbol=bits_per_symbol, fading=fading,
        fade_block=fade_block, block_words=block_words, word_bits=word_bits)
    return u.reshape(rows, n), u_hat.reshape(rows, n) & clamp_mask


def approx_channel_batch_aggregate_ref(
    x: torch.Tensor,
    seeds: torch.Tensor,
    noise_powers: torch.Tensor,
    large_scale_gains: torch.Tensor,
    weights: torch.Tensor,
    *,
    bits_per_symbol: int = 2,
    fading: str = "rayleigh",
    fade_block: int = 64,
    clamp_mask: int = 0xBFFFFFFF,
    block_words: int = 1024,
    word_bits: int = 32,
    valid_words: int | None = None,
    num_active=None,
):
    """Plain version of K2: K1's chain, then ``agg += w[c] * x_hat[c]``.

    The sum runs in client order as one float32 multiply then one add per
    client (a bf16 wire is upcast first). Bit errors count only the first
    ``valid_words`` words of a row. Rows at or beyond ``num_active`` are
    skipped — not given weight zero, which would still turn a NaN payload
    lane into a NaN sum.

    Returns ``(agg (N,) float32, bit_errors (C,) int32)``.
    """
    c, n = x.shape
    valid = n if valid_words is None else int(valid_words)
    rows = _active_rows(num_active, c)
    u, u_hat = _rows(
        x, seeds, noise_powers, large_scale_gains,
        bits_per_symbol=bits_per_symbol, fading=fading,
        fade_block=fade_block, clamp_mask=clamp_mask,
        block_words=block_words, word_bits=word_bits, rows=rows)
    x_hat = _from_wire_bits(u_hat, word_bits).to(torch.float32)
    w = weights.to(torch.float32)
    agg = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for i in range(rows):
        agg = agg + w[i] * x_hat[i]
    errs = torch.zeros((c,), dtype=torch.int32, device=x.device)
    flips = popcount(u[:, :valid] ^ u_hat[:, :valid])
    errs[:rows] = flips.sum(dim=1).to(torch.int32)
    return agg, errs
