"""Wrappers of the CUDA approximate-channel kernels (K0, K1, K2).

Counterpart of ``repro.kernels.approx_channel``, whose Pallas kernels
become hand-written CUDA C++ for Hopper in ``csrc/approx_channel.cu``:

=================================  ==========================================
port                               reference (Pallas, TPU)
=================================  ==========================================
``approx_channel_batch_kernel``    ``approx_channel_batch_pallas`` (K1)
``approx_channel_batch_aggregate_  ``approx_channel_batch_aggregate_pallas``
kernel``                           (K2)
``approx_channel_kernel``          ``approx_channel_pallas`` (K0)
=================================  ==========================================

A tensor on the CPU goes to the plain PyTorch version in
:mod:`repro_torch.kernels.ref`; a CUDA tensor launches the kernel on the
current stream or raises — there is no fallback. Each wrapper checks
device, dtype, shape and contiguity, allocates its outputs, raises if the
launch reports an error, and adds one to its ``launches`` counter each
time it launches its kernel (and nowhere else). The reference computes K0
as K1 at C=1; the port gives it a kernel of its own for one long row
(``k0_approx_channel_row``), with the same bits, so a K0 call counts in
K0's counter alone.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import build as build_lib
from repro_torch.kernels import ref as ref_lib
from repro_torch.obs import spans

__all__ = [
    "approx_channel_kernel",
    "approx_channel_batch_kernel",
    "approx_channel_batch_aggregate_kernel",
    "launch_counts",
    "reset_launch_counts",
    "MAX_ROW_WORDS",
]

_FADING = {"rayleigh": 0, "awgn": 1, "block_rayleigh": 2}
_SOURCE = "approx_channel"
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_U = ctypes.c_uint32


# ctypes signatures of the extern "C" entries of csrc/approx_channel.cu:
# c_void_p for every pointer and the stream (a plain int would cut a
# pointer to 32 bits). Each returns cudaGetLastError() as an int.
SIGNATURES = {
    "repro_k0_approx_channel_row": [
        _P, _P, _P, _P, _P, _P, _P,     # x, out, errs, slow, seed, npow, gain
        _L, _I, _I, _I, _I, _I,         # N, k, fading, wb, bw, fade_block
        _U, _F, _F, _P],                # clamp, amp, inv, stream
    "repro_k1_approx_channel_batch": [
        _P, _P, _P, _P, _P, _P,         # x, out, errs, seeds, npow, gains
        _I, _I, _I, _I, _I, _I, _I,     # C, N, k, fading, wb, bw, fade_block
        _U, _I, _F, _F, _P],            # clamp, num_active, amp, inv, stream
    "repro_k2_approx_channel_aggregate": [
        _P, _P, _P, _P, _P, _P, _P,     # x, agg, errs, seeds, npow, gains, w
        _I, _I, _I, _I, _I, _I, _I,     # C, N, k, fading, wb, bw, fade_block
        _U, _I, _I, _F, _F, _P],        # clamp, num_active, valid, amp, inv,
}                                       # stream


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build_lib.load(_SOURCE)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib


def _constellation(bits_per_symbol: int) -> tuple[float, float]:
    """float32 ``amp`` and ``1/amp`` exactly as the plain version rounds them."""
    L = 1 << (bits_per_symbol // 2)
    amp = math.sqrt(3.0 / (2.0 * (L * L - 1)))
    return float(np.float32(amp)), float(np.float32(1.0 / amp))


# K1 and K2 index a row's words with a 32-bit int (Params::n and the word
# index i in csrc/approx_channel.cu); K0's row length and word index are
# 64-bit, so K0 takes any row the card holds.
MAX_ROW_WORDS = 2**31 - 1


def _check_row(x, kernel: str) -> None:
    """Refuse a padded row longer than K1's and K2's int row index, on
    every device (the plain version would run it, but the kernel could
    not)."""
    if x.shape[-1] > MAX_ROW_WORDS:
        raise ValueError(
            f"{kernel}: a row of {x.shape[-1]} words (padded to whole tiles) "
            f"exceeds its limit of 2**31 - 1 words")


def _check_device(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"kernel path needs CUDA tensors, got {x.device}")


def _check_common(x, seeds, noise_powers, gains, *, bits_per_symbol, fading,
                  block_words, word_bits, fade_block):
    _check_device(x)
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (C, N) tensor")
    wire = torch.bfloat16 if word_bits == 16 else torch.float32
    if word_bits not in (16, 32) or x.dtype != wire:
        raise ValueError(f"x must be {wire} for word_bits={word_bits}, "
                         f"got {x.dtype}")
    if bits_per_symbol not in (2, 4, 8):
        raise ValueError(f"bits_per_symbol must be 2, 4 or 8, "
                         f"got {bits_per_symbol}")
    if fading not in _FADING:
        raise ValueError(f"unknown fading {fading!r}")
    c, n = x.shape
    if block_words <= 0 or n % block_words != 0:
        raise ValueError(f"N={n} must be a multiple of block_words={block_words}")
    if fade_block <= 0:
        raise ValueError("fade_block must be positive")
    if not 0 < c < 65536:
        raise ValueError(f"unsupported payload shape {(c, n)}")
    for name, t in (("seeds", seeds), ("noise_powers", noise_powers),
                    ("large_scale_gains", gains)):
        if t.device != x.device or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({c},) tensor on "
                             f"{x.device}")
    if seeds.dtype != torch.int32:
        raise ValueError("seeds must be int32 (the uint32 bit pattern)")
    if noise_powers.dtype != torch.float32 or gains.dtype != torch.float32:
        raise ValueError("noise_powers and large_scale_gains must be float32")


def _seed_bits(seeds: torch.Tensor) -> torch.Tensor:
    """``uint32`` seed values (any integer dtype) as their int32 bit pattern."""
    if seeds.dtype == torch.int32:
        return seeds.contiguous()
    s = seeds.to(torch.int64) & 0xFFFFFFFF
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def _num_active(num_active, c: int) -> int:
    return c if num_active is None else int(num_active)


def approx_channel_batch_kernel(
    x: torch.Tensor,
    seeds: torch.Tensor,
    noise_powers: torch.Tensor,
    large_scale_gains: torch.Tensor,
    *,
    bits_per_symbol: int = 2,
    fading: str = "rayleigh",
    fade_block: int = 64,
    clamp_mask: int = 0xBFFFFFFF,
    block_words: int = 1024,
    word_bits: int = 32,
    num_active=None,
):
    """K1: the batched uplink over a ``(C, N)`` payload in one launch.

    Args:
      x: ``(C, N)`` float32 (bfloat16 with ``word_bits=16``),
        ``N % block_words == 0``.
      seeds: ``(C,)`` integer tensor of ``uint32`` seed values.
      noise_powers / large_scale_gains: ``(C,)`` float32.
      num_active: rows at or beyond it are masked: zeros, 0 errors, no PHY
        work.

    Returns ``(x_hat (C, N) wire dtype, bit_errors (C,) int32)``; a row
    over ``MAX_ROW_WORDS`` raises ``ValueError`` on any device.
    """
    _check_row(x, "K1")
    if x.device.type == "cpu":
        return ref_lib.approx_channel_batch_ref(
            x, seeds, noise_powers, large_scale_gains,
            bits_per_symbol=bits_per_symbol, fading=fading,
            fade_block=fade_block, clamp_mask=clamp_mask,
            block_words=block_words, word_bits=word_bits,
            num_active=num_active)
    seeds = _seed_bits(seeds)
    _check_common(x, seeds, noise_powers, large_scale_gains,
                  bits_per_symbol=bits_per_symbol, fading=fading,
                  block_words=block_words, word_bits=word_bits,
                  fade_block=fade_block)
    c, n = x.shape
    out = torch.empty_like(x)
    # Blocks add their warp-reduced counts into errs, so it starts at 0.
    errs = torch.zeros((c,), dtype=torch.int32, device=x.device)
    amp, inv = _constellation(bits_per_symbol)
    rc = _library().repro_k1_approx_channel_batch(
        x.data_ptr(), out.data_ptr(), errs.data_ptr(), seeds.data_ptr(),
        noise_powers.data_ptr(), large_scale_gains.data_ptr(),
        c, n, bits_per_symbol, _FADING[fading], word_bits, block_words,
        fade_block, clamp_mask & 0xFFFFFFFF, _num_active(num_active, c),
        amp, inv, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    approx_channel_batch_kernel.launches += 1
    return out, errs


approx_channel_batch_kernel.launches = 0


def approx_channel_batch_aggregate_kernel(
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
    """K2: K1's chain with the weighted client sum folded in, one launch.

    ``agg = sum_c weights[c] * x_hat[c]`` accumulates in client order, one
    float32 multiply then one add per client, so it is bit-identical to
    ``aggregation.fedsgd_aggregate_batch`` over K1's rows. Bit errors count
    only the first ``valid_words`` words of each row; rows at or beyond
    ``num_active`` add nothing and report 0 errors.

    Returns ``(agg (N,) float32, bit_errors (C,) int32)``; a row over
    ``MAX_ROW_WORDS`` raises ``ValueError`` on any device.
    """
    _check_row(x, "K2")
    if x.device.type == "cpu":
        return ref_lib.approx_channel_batch_aggregate_ref(
            x, seeds, noise_powers, large_scale_gains, weights,
            bits_per_symbol=bits_per_symbol, fading=fading,
            fade_block=fade_block, clamp_mask=clamp_mask,
            block_words=block_words, word_bits=word_bits,
            valid_words=valid_words, num_active=num_active)
    seeds = _seed_bits(seeds)
    _check_common(x, seeds, noise_powers, large_scale_gains,
                  bits_per_symbol=bits_per_symbol, fading=fading,
                  block_words=block_words, word_bits=word_bits,
                  fade_block=fade_block)
    c, n = x.shape
    if (weights.device != x.device or weights.shape != (c,)
            or weights.dtype != torch.float32 or not weights.is_contiguous()):
        raise ValueError(f"weights must be a contiguous ({c},) float32 tensor "
                         f"on {x.device}")
    valid = n if valid_words is None else int(valid_words)
    agg = torch.empty((n,), dtype=torch.float32, device=x.device)
    errs = torch.zeros((c,), dtype=torch.int32, device=x.device)
    amp, inv = _constellation(bits_per_symbol)
    rc = _library().repro_k2_approx_channel_aggregate(
        x.data_ptr(), agg.data_ptr(), errs.data_ptr(), seeds.data_ptr(),
        noise_powers.data_ptr(), large_scale_gains.data_ptr(),
        weights.data_ptr(), c, n, bits_per_symbol, _FADING[fading], word_bits,
        block_words, fade_block, clamp_mask & 0xFFFFFFFF,
        _num_active(num_active, c), valid, amp, inv,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    approx_channel_batch_aggregate_kernel.launches += 1
    return agg, errs


approx_channel_batch_aggregate_kernel.launches = 0


def approx_channel_kernel(
    x: torch.Tensor,
    seed,
    noise_power,
    large_scale_gain,
    *,
    bits_per_symbol: int = 2,
    fading: str = "rayleigh",
    fade_block: int = 64,
    clamp_mask: int = 0xBFFFFFFF,
    block_words: int = 1024,
    word_bits: int = 32,
):
    """K0: one client's ``(N,)`` payload in one launch of its own row kernel.

    ``seed`` is a ``uint32`` value (an int or a one-element tensor),
    ``noise_power`` and ``large_scale_gain`` floats or one-element tensors.
    The same received words and int32 error count as K1's row 0 of a C=1
    batch, so as the plain version; a CUDA call counts one launch of K0
    and none of K1. The row may be longer than ``MAX_ROW_WORDS``: each
    word's tile is its index over ``block_words`` as ``uint32`` (the
    reference's ``program_id``), and the int32 count wraps modulo 2**32.
    Inside a ``spans.counting`` scope a CUDA call sets the counters
    ``k0_symbols`` (the row's symbols) and ``k0_symbols_slow`` (those the
    kernel's settling test left to the full chain; a device tensor, read
    when the scope closes). Returns ``(x_hat (N,) wire dtype, bit_errors
    () int32)``.
    """
    if x.device.type == "cpu":
        return ref_lib.ref_approx_channel(
            x, seed, noise_power, large_scale_gain,
            bits_per_symbol=bits_per_symbol, fading=fading,
            fade_block=fade_block, clamp_mask=clamp_mask,
            block_words=block_words, word_bits=word_bits)
    _check_device(x)
    dev = x.device
    row = x[None, :].contiguous()
    seeds = _seed_bits(torch.as_tensor(seed, device=dev).reshape(1))
    npow = torch.as_tensor(noise_power, dtype=torch.float32,
                           device=dev).reshape(1)
    gain = torch.as_tensor(large_scale_gain, dtype=torch.float32,
                           device=dev).reshape(1)
    _check_common(row, seeds, npow, gain, bits_per_symbol=bits_per_symbol,
                  fading=fading, block_words=block_words,
                  word_bits=word_bits, fade_block=fade_block)
    n = row.shape[1]
    out = torch.empty_like(row[0])
    # Blocks add their counts into both, so they start at 0: the int32
    # error count in the low half of counts[0], the symbols the settling
    # test left to the full chain in counts[1].
    counts = torch.zeros((2,), dtype=torch.int64, device=dev)
    errs = counts[:1].view(torch.int32)[0]
    amp, inv = _constellation(bits_per_symbol)
    rc = _library().repro_k0_approx_channel_row(
        row.data_ptr(), out.data_ptr(), counts.data_ptr(),
        counts[1:].data_ptr(), seeds.data_ptr(), npow.data_ptr(),
        gain.data_ptr(), n, bits_per_symbol, _FADING[fading], word_bits,
        block_words, fade_block, clamp_mask & 0xFFFFFFFF, amp, inv,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K0 launch failed: cudaError {rc}")
    approx_channel_kernel.launches += 1
    spans.count("k0_symbols_slow", 0, counts[1])
    spans.count("k0_symbols", 0, n * (word_bits // bits_per_symbol))
    return out, errs


approx_channel_kernel.launches = 0


def launch_counts() -> dict:
    """Launches of each kernel since the last reset:
    ``{"k0": n, "k1": n, "k2": n}``, each counting its own kernel (a K0
    call launches K0's row kernel, not K1)."""
    return {"k0": approx_channel_kernel.launches,
            "k1": approx_channel_batch_kernel.launches,
            "k2": approx_channel_batch_aggregate_kernel.launches}


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    approx_channel_kernel.launches = 0
    approx_channel_batch_kernel.launches = 0
    approx_channel_batch_aggregate_kernel.launches = 0
