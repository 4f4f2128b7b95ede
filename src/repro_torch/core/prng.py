"""Threefry-2x32 keys, bit-identical to ``jax.random``'s default PRNG.

The reference draws every key, kernel seed and He-init weight from
``jax.random`` with the ``threefry2x32`` implementation in its
*partitionable* variant (``jax_threefry_partitionable=True``). This module
reproduces that key schedule integer for integer:

* ``PRNGKey(seed)`` -> ``(0, seed mod 2**32)`` (32-bit mode);
* ``split(key, n)[i] == fold_in(key, i) == threefry(key, (0, i))``;
* ``random_bits(key, shape)`` hashes the 64-bit iota ``(hi, lo)`` of the
  flattened shape and XORs the two output words;
* ``randint`` is the exact two-draw modulus algorithm of
  ``jax.random.randint`` (``kernels/ops.py::_seed_from_key`` uses it);
* ``uniform`` sets the mantissa of ``1.0`` from the top 23 random bits;
* ``normal`` is ``sqrt(2) * erfinv(u)`` on ``u ~ U(nextafter(-1, 0), 1)``.
  ``torch.erfinv`` is not XLA's ``erf_inv``, so normals agree only to a
  few ULP (see ``tests/test_torch_prng.py``); everything else is exact;
* ``bernoulli`` is ``uniform < p``, exact;
* ``exponential`` is jax 0.9.0's ``-log1p(-u)`` on ``u ~ U[0, 1)``;
  ``torch.log1p`` is not XLA's, so it agrees to a few ULP (see
  ``tests/test_torch_async.py``);
* ``gamma`` is jax's Marsaglia-Tsang sampler with its key consumption,
  vectorised over elements; it inherits the few ULP of ``normal`` (and
  of ``log`` in its acceptance test);
* ``permutation`` is jax's ``_shuffle`` of ``arange(n)``: rounds of a
  stable sort under fresh 32-bit keys, exact.

Keys are ``int64`` tensors of shape ``(..., 2)`` holding ``uint32``
values. Everything derived from a key is made on the key's device, so a
round key on the GPU keeps the whole per-round schedule (client keys,
kernel seeds) there; on the meta device the hashes give their shapes and
compute nothing, so a model's tree builds there without memory or
arithmetic. All 32-bit arithmetic runs in ``int64`` with an
``& 0xFFFFFFFF`` mask, because PyTorch has no ``uint32`` shift or add on
the CPU; 32-bit products go through :func:`mul32`, which never overflows
``int64``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "M32",
    "mul32",
    "threefry2x32",
    "PRNGKey",
    "split",
    "fold_in",
    "random_bits",
    "randint",
    "uniform",
    "normal",
    "bernoulli",
    "exponential",
    "gamma",
    "permutation",
]

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


def bernoulli(key: torch.Tensor, p: float, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode ``"low"``): ``uniform
    < p`` with ``p`` in float32. Returns a bool tensor."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32,
                                              device=key.device)


def exponential(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.exponential(key, shape, float32)``: ``-log1p(-u)`` on
    ``u = uniform(key, shape)`` (``1 - u`` keeps the log's argument in
    ``(0, 1]``). ``key`` may be batched ``(..., 2)``."""
    return -torch.log1p(-uniform(key, shape))


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def gamma(key: torch.Tensor, a: float, shape=()) -> torch.Tensor:
    """``jax.random.gamma(key, a, shape, float32)`` for a scalar ``a > 0``.

    jax 0.9.0's ``_gamma_impl``/``_gamma_one``: element ``i`` draws from
    ``split(key, n)[i]``; ``key, subkey = split(key)``; then Marsaglia-Tsang
    with ``d = a - 1/3``, ``c = (1/3) / sqrt(d)``: each rejection step
    splits its key in three (``key, x_key, U_key``), redraws the normal
    ``x`` from successive ``split(x_key)`` halves while ``v = 1 + x c <=
    0``, and accepts once ``U < 1 - 0.0331 X^2`` (``X = x^2``) or ``log U <
    X/2 + d (1 - V + log V)``. ``a < 1`` is boosted to ``a + 1`` and the
    sample scaled by ``(1 - uniform(subkey))^(1/a)``. jax vmaps the
    rejection loop; here every element still pending runs the next step
    together, which consumes the same keys.
    """
    shape = tuple(shape)
    n = math.prod(shape)
    dev = key.device
    if not a > 0:
        raise ValueError(f"gamma needs a > 0, got {a}")
    one, zero = _f32(1.0, dev), _f32(0.0, dev)
    third, half = _f32(1.0 / 3.0, dev), _f32(0.5, dev)
    squeeze = _f32(0.0331, dev)
    alpha_orig = _f32(a, dev)
    boost = bool(alpha_orig < one)
    alpha = alpha_orig + one if boost else alpha_orig
    d = alpha - third
    c = third / torch.sqrt(d)
    keys, subkeys = split_batched(split(key, n))
    big_x = torch.zeros((n,), dtype=torch.float32, device=dev)
    big_v = torch.ones((n,), dtype=torch.float32, device=dev)
    big_u = torch.full((n,), 2.0, dtype=torch.float32, device=dev)

    def pending_of(x2, v3, u):
        return ((u >= one - squeeze * (x2 * x2))
                & (torch.log(u) >= x2 * half
                   + d * ((one - v3) + torch.log(v3))))

    pending = pending_of(big_x, big_v, big_u)
    while bool(pending.any()):
        idx = pending.nonzero().reshape(-1)
        keys_p, x_key, u_key = split_batched(keys[idx], 3)
        x = torch.zeros((idx.numel(),), dtype=torch.float32, device=dev)
        v = torch.full_like(x, -1.0)
        redraw = v <= zero
        while bool(redraw.any()):
            r = redraw.nonzero().reshape(-1)
            x_key_r, sub = split_batched(x_key[r], 2)
            x_key[r] = x_key_r
            x[r] = normal(sub, ())
            v[r] = one + x[r] * c
            redraw = v <= zero
        keys[idx] = keys_p
        big_x[idx] = x * x
        big_v[idx] = (v * v) * v
        big_u[idx] = uniform(u_key, ())
        pending = pending_of(big_x, big_v, big_u)
    sample = d * big_v
    if boost:
        u = one - uniform(subkeys, ())
        sample = sample * torch.pow(u, one / alpha_orig)
    return sample.reshape(shape)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a permutation of ``arange(n)``
    (``int64``), one per key of a batch ``(..., 2)``.

    jax's ``_shuffle``: ``ceil(3 ln(n) / ln(2**32 - 1))`` rounds (2 at
    n = 21,840); each round takes ``key, sub = split(key)``, draws 32
    random bits per element from ``sub`` and stable-sorts the elements by
    them (``lax.sort_key_val``), so equal draws keep their order.
    """
    uint32max = np.iinfo(np.uint32).max
    num_rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(uint32max)))
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        key.shape[:-1] + (n,))
    for _ in range(num_rounds):
        key, sub = split_batched(key)
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x
