"""Frozen copy of the threefry-2x32 key schedule of
``src/repro_torch/core/prng.py`` (``jax.random``'s partitionable threefry):
``PRNGKey``, ``split``, ``fold_in``, ``random_bits``, ``randint``,
``uniform`` and ``normal``, copied as they stood. The reference draws its
own weights, round keys and kernel seeds with it, so it takes none of
them from the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a * b) mod 2**32`` for ``uint32`` values held in ``int64``.

    ``b`` is split into 16-bit halves so that no partial product reaches
    2**63: ``a * b_lo < 2**48`` and ``a * b_hi < 2**48``.
    """
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher, 20 rounds, as ``jax._src.prng``.

    All arguments are ``int64`` tensors (or ints) of ``uint32`` values that
    broadcast together. Returns the two output words.
    """
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & M32
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` in 32-bit mode: ``(0, seed mod 2**32)``,
    on ``device`` (default the CPU)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def _hash(key: torch.Tensor, hi, lo):
    """Threefry of the counter ``(hi, lo)`` under ``key`` (``(..., 2)``);
    on the meta device, two words of the broadcast shape and no rounds."""
    if key.device.type == "meta":
        shape = torch.broadcast_shapes(key.shape[:-1],
                                       *(torch.as_tensor(v).shape
                                         for v in (hi, lo)))
        return (torch.empty(shape, dtype=torch.int64, device="meta"),
                torch.empty(shape, dtype=torch.int64, device="meta"))
    return threefry2x32(key[..., 0], key[..., 1], hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(num, 2)`` keys."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = _hash(key[None, :], 0, lo)
    return torch.stack([a, b], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``data`` may be a tensor of ints,
    giving one key per element (the vmapped form of the reference)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    a, b = _hash(key, 0, d)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """32 random bits per element, partitionable threefry.

    ``key`` may carry leading batch dimensions ``(..., 2)``; the result has
    shape ``(...) + shape``.
    """
    shape = tuple(shape)
    if key.device.type == "meta":
        # shapes only: no bits to hash, and no limit on the count
        return torch.empty(key.shape[:-1] + shape, dtype=torch.int64,
                           device="meta")
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError("random_bits supports fewer than 2**32 values")
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    k = key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,))
    a, b = _hash(k, 0, lo)
    return a ^ b


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``.

    Two 32-bit draws combine as ``(hi % span) * (2**32 % span) + lo % span``
    in ``uint32`` arithmetic (wrap included). Returns ``int64`` values in
    ``[minval, maxval)``. ``key`` may be batched ``(..., 2)``.
    """
    i32_max = 2**31 - 1
    if not -(2**31) <= minval <= i32_max or maxval > i32_max:
        raise ValueError("randint here covers the int32 range only")
    # Both draws in one hash: keys stacked on a new leading axis.
    higher, lower = random_bits(torch.stack(split_batched(key)), shape)
    span = (maxval - minval) & M32 if maxval > minval else 1
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & M32) % span
    offset = (mul32(higher % span, multiplier) + lower % span) & M32
    offset = offset % span
    val = (minval + offset) & M32
    return torch.where(val >= 1 << 31, val - (1 << 32), val)


def split_batched(key: torch.Tensor, num: int = 2):
    """``split(key, num)`` for a batch of keys ``(..., 2)``: ``num`` keys
    ``(..., 2)``."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = _hash(key[..., None, :], 0, lo)
    out = torch.stack([a, b], dim=-1)  # (..., num, 2): [..., i] = key i
    return tuple(out[..., i, :] for i in range(num))


def _bits_to_unit_f32(bits: torch.Tensor) -> torch.Tensor:
    """Top 23 bits as the mantissa of a float in ``[1, 2)``, minus 1."""
    fb = (bits >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.

    XLA computes ``floats * (maxval - minval) + minval`` as one fused
    multiply-add; so does this, in float64, where the product of two
    float32 values is exact and the sum of these operands rounds once
    (a multiple of ``2**-23`` in ``[0, 1)`` times ``maxval - minval``,
    plus ``minval``), so the cast back is the fma's one rounding.
    """
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    floats = _bits_to_unit_f32(random_bits(key, shape))
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


_LO_NORMAL = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2)))


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) * erfinv(u)``."""
    u = uniform(key, shape, _LO_NORMAL, 1.0)
    return torch.erfinv(u) * _SQRT2_F32
