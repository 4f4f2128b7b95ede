"""Public wrappers of the approximate-channel kernels (port).

Counterpart of ``repro.kernels.ops``. ``approx_channel`` runs one client's
arbitrary-length row through K0, the port's own row kernel (the reference
computes it as K1 at C=1); ``approx_channel_batch`` runs a ``(C, N)``
matrix through K1; ``approx_channel_batch_aggregate`` runs K2. Each pads
its input to whole tiles (:func:`_tiled`) and hands it to
:func:`on_tiles`, the one launch on whole tiles that knows the payload
length: it subtracts the errors K0 and K1 counted on the zero pad words,
or gives K2 the payload length as ``valid_words``, and slices the pad
away. The transport module of ``repro_torch.core``, which this module
does not import, holds the kernel path's ``TransportConfig`` adapter:
the one place that turns a config and keys into these arguments (seeds,
link tensors, ``TxStats``); it packs its row to whole tiles and calls
:func:`on_tiles` itself. Tensors on the CPU run
the plain versions, CUDA tensors the kernels (see
:mod:`repro_torch.kernels.approx_channel`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import float_codec as fc
from repro_torch.core import prng
from repro_torch.kernels import approx_channel as ac
from repro_torch.kernels import ref as ref_lib
from repro_torch.obs import spans

__all__ = [
    "BLOCK_WORDS",
    "approx_channel",
    "approx_channel_batch",
    "approx_channel_batch_aggregate",
    "on_tiles",
]

# Words a tile: the kernels' block and the transport's pad granule.
BLOCK_WORDS = 1024


def _wire(word_bits: int):
    return torch.bfloat16 if word_bits == 16 else torch.float32


def _tiled(x: torch.Tensor, word_bits: int, block_words: int):
    """``x`` on the wire dtype, zero-padded along its last dim to a whole
    number of tiles, contiguous: a dense input already on the wire dtype
    and a whole number of tiles long is passed as it is (no copy)."""
    pad = (-x.shape[-1]) % block_words
    xw = x.to(_wire(word_bits))
    return (F.pad(xw, (0, pad)) if pad else xw).contiguous()


def _padding_errors(pad_hat: torch.Tensor, word_bits: int) -> torch.Tensor:
    """Bit errors a kernel counted on zero pad words (= received popcount),
    per row of a ``(C, pad)`` block."""
    u = fc.bf16_to_bits(pad_hat) if word_bits == 16 else fc.f32_to_bits(pad_hat)
    return ref_lib._popcount(u).sum(dim=-1).to(torch.int32)


def _seed_from_key(keys: torch.Tensor) -> torch.Tensor:
    """Kernel seed(s) of key(s) ``(..., 2)``: ``randint(key, (), 0,
    int32 max)`` as ``uint32``, exactly as the reference. ``int64`` values."""
    return prng.randint(keys, (), 0, 2**31 - 1) & prng.M32


def on_tiles(xp, n: int, seeds, noise_powers, large_scale_gains,
             weights=None, *, bits_per_symbol: int = 2,
             fading: str = "rayleigh", fade_block: int = 64,
             clamp_mask: int = 0xBFFFFFFF, block_words: int = BLOCK_WORDS,
             word_bits: int = 32, num_active=None):
    """One launch on rows already whole tiles on the wire dtype, whose
    first ``n`` words are the payload and the rest zeros: K0 for a 1-D
    row, K1 for ``(C, N)`` rows, K2 when ``weights`` are given.

    K0's and K1's errors on the pad words are subtracted (a sent pad word
    is exactly 0, so every set bit received there counted); K2 counts only
    the first ``n`` words (``valid_words``). Returns ``(x_hat (..., n) wire
    dtype, bit_errors)`` or, with ``weights``, ``(agg (n,) float32,
    bit_errors (C,))``.
    """
    kw = dict(bits_per_symbol=bits_per_symbol, fading=fading,
              fade_block=fade_block, clamp_mask=clamp_mask,
              block_words=block_words, word_bits=word_bits)
    with spans.span("kernel", device=True):
        if weights is not None:
            agg, errs = ac.approx_channel_batch_aggregate_kernel(
                xp, seeds, noise_powers, large_scale_gains,
                weights.to(torch.float32).contiguous(), valid_words=n,
                num_active=num_active, **kw)
            return agg[:n], errs
        if xp.ndim == 1:
            x_hat, errs = ac.approx_channel_kernel(
                xp, seeds, noise_powers, large_scale_gains, **kw)
        else:
            x_hat, errs = ac.approx_channel_batch_kernel(
                xp, seeds, noise_powers, large_scale_gains,
                num_active=num_active, **kw)
    if xp.shape[-1] > n:
        errs = errs - _padding_errors(x_hat[..., n:], word_bits)
    return x_hat[..., :n], errs


def approx_channel(x, seed, noise_power, large_scale_gain, *,
                   bits_per_symbol: int = 2, fading: str = "rayleigh",
                   fade_block: int = 64, clamp_mask: int = 0xBFFFFFFF,
                   block_words: int = BLOCK_WORDS, word_bits: int = 32):
    """Arbitrary-length single-client wrapper: pads with zeros to a tile
    multiple and runs K0. Returns ``(x_hat (N,) wire dtype, bit_errors ()
    int32)``."""
    return on_tiles(_tiled(x, word_bits, block_words), x.shape[0], seed,
                    noise_power, large_scale_gain,
                    bits_per_symbol=bits_per_symbol, fading=fading,
                    fade_block=fade_block, clamp_mask=clamp_mask,
                    block_words=block_words, word_bits=word_bits)


def approx_channel_batch(x, seeds, noise_powers, large_scale_gains, *,
                         bits_per_symbol: int = 2, fading: str = "rayleigh",
                         fade_block: int = 64, clamp_mask: int = 0xBFFFFFFF,
                         block_words: int = BLOCK_WORDS, word_bits: int = 32,
                         num_active=None):
    """Batched arbitrary-length wrapper: pads ``(C, N)`` payloads along the
    payload dim to a tile multiple, one K1 launch for all clients.
    ``num_active`` masks the tail rows (zeros, no PHY work). Returns
    ``(x_hat (C, N), bit_errors (C,))``."""
    return on_tiles(_tiled(x, word_bits, block_words), x.shape[1], seeds,
                    noise_powers, large_scale_gains,
                    bits_per_symbol=bits_per_symbol, fading=fading,
                    fade_block=fade_block, clamp_mask=clamp_mask,
                    block_words=block_words, word_bits=word_bits,
                    num_active=num_active)


def approx_channel_batch_aggregate(x, seeds, noise_powers, large_scale_gains,
                                   weights, *, bits_per_symbol: int = 2,
                                   fading: str = "rayleigh",
                                   fade_block: int = 64,
                                   clamp_mask: int = 0xBFFFFFFF,
                                   block_words: int = BLOCK_WORDS,
                                   word_bits: int = 32, num_active=None):
    """Fused batch + weighted aggregation over the client axis (K2).

    Pads ``(C, N)`` payloads to a tile multiple; bit errors count only the
    first ``N`` words of each row. Returns ``(agg (N,) float32,
    bit_errors (C,) int32)``.
    """
    return on_tiles(_tiled(x, word_bits, block_words), x.shape[1], seeds,
                    noise_powers, large_scale_gains, weights,
                    bits_per_symbol=bits_per_symbol, fading=fading,
                    fade_block=fade_block, clamp_mask=clamp_mask,
                    block_words=block_words, word_bits=word_bits,
                    num_active=num_active)
