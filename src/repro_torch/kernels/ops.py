"""Public wrappers of the approximate-channel kernels (port).

Counterpart of ``repro.kernels.ops``. ``approx_channel`` pads an
arbitrary-length vector to the tile size and runs K0 (K1 at C=1);
``approx_channel_batch`` does the same for a ``(C, N)`` matrix through K1;
``approx_channel_batch_aggregate`` runs K2. The ``*_transmit*`` adapters
take a ``TransportConfig`` and PRNG keys, derive per-client kernel seeds
exactly as the reference does (``_seed_from_key``), and return
``TxStats``. Tensors on the CPU run the plain versions, CUDA tensors the
kernels (see :mod:`repro_torch.kernels.approx_channel`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import channel as channel_lib
from repro_torch.core import float_codec as fc
from repro_torch.core import prng
from repro_torch.kernels import approx_channel as ac
from repro_torch.kernels import ref as ref_lib
from repro_torch.obs import spans

__all__ = [
    "approx_channel",
    "approx_channel_batch",
    "approx_channel_batch_aggregate",
    "approx_channel_transmit",
    "approx_channel_transmit_batch",
    "approx_channel_transmit_batch_aggregate",
]


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


def approx_channel(x, seed, noise_power, large_scale_gain, *,
                   bits_per_symbol: int = 2, fading: str = "rayleigh",
                   fade_block: int = 64, clamp_mask: int = 0xBFFFFFFF,
                   block_words: int = 1024, word_bits: int = 32):
    """Arbitrary-length single-client wrapper: pads with zeros to a tile
    multiple and subtracts the errors counted on the padding (transmitted
    pad words are exactly 0, so every received set bit there counts).
    Returns ``(x_hat (N,) wire dtype, bit_errors () int32)``."""
    n = x.shape[0]
    with spans.span("pad", device=True):
        xp = _tiled(x, word_bits, block_words)
    with spans.span("kernel", device=True):
        x_hat, errs = ac.approx_channel_kernel(
            xp, seed, noise_power, large_scale_gain,
            bits_per_symbol=bits_per_symbol, fading=fading,
            fade_block=fade_block, clamp_mask=clamp_mask,
            block_words=block_words, word_bits=word_bits)
    with spans.span("unflatten", device=True):
        errs = errs - _padding_errors(x_hat[n:], word_bits)
    return x_hat[:n], errs


def _transport_kernel_params(cfg):
    """(wire_bits, clamp_mask, bits_per_symbol) for a TransportConfig."""
    wb = 16 if cfg.wire_dtype == "bfloat16" else 32
    if cfg.mode != "approx":
        clamp_mask = 0xFFFFFFFF
    elif wb == 16:
        clamp_mask = fc.exponent_clamp_mask16(cfg.clamp_bound)
    else:
        clamp_mask = fc.exponent_clamp_mask(cfg.clamp_bound)
    return wb, clamp_mask, cfg.scheme.bits_per_symbol


def _seed_from_key(keys: torch.Tensor) -> torch.Tensor:
    """Kernel seed(s) of key(s) ``(..., 2)``: ``randint(key, (), 0,
    int32 max)`` as ``uint32``, exactly as the reference. ``int64`` values."""
    return prng.randint(keys, (), 0, 2**31 - 1) & prng.M32


def approx_channel_transmit(x: torch.Tensor, key: torch.Tensor, cfg, *,
                            snr_db=None):
    """TransportConfig adapter (mode 'approx'|'naive' with use_kernel) for
    one client's ``(N,)`` float32 payload; ``snr_db`` overrides
    ``cfg.channel.snr_db``. Returns ``(x_hat (N,) float32, TxStats)``."""
    from repro_torch.core import transport as transport_lib

    ch = cfg.channel
    dev = x.device
    with spans.span("keys"):
        seed = _seed_from_key(key).to(dev)
    wb, clamp_mask, k = _transport_kernel_params(cfg)
    if snr_db is None:
        npow = torch.tensor(ch.noise_power, dtype=torch.float32, device=dev)
    else:
        npow = channel_lib.noise_power_for(ch, snr_db, dev)
    x_hat, errs = approx_channel(
        x, seed, npow, ch.large_scale_gain, bits_per_symbol=k,
        fading=ch.fading, fade_block=ch.block_len, clamp_mask=clamp_mask,
        word_bits=wb)
    n = x.shape[0]
    stats = transport_lib._stats(n * (wb // k), 1, errs, n * wb, n * wb,
                                 device=dev)
    with spans.span("unflatten", device=True):
        x_hat = x_hat.to(torch.float32)
    return x_hat, stats


def approx_channel_batch(x, seeds, noise_powers, large_scale_gains, *,
                         bits_per_symbol: int = 2, fading: str = "rayleigh",
                         fade_block: int = 64, clamp_mask: int = 0xBFFFFFFF,
                         block_words: int = 1024, word_bits: int = 32,
                         num_active=None):
    """Batched arbitrary-length wrapper: pads ``(C, N)`` payloads along the
    payload dim to a tile multiple, one K1 launch for all clients, and
    subtracts each row's padding errors. ``num_active`` masks the tail
    rows (zeros, no PHY work). Returns ``(x_hat (C, N), bit_errors (C,))``."""
    c, n = x.shape
    xp = _tiled(x, word_bits, block_words)
    with spans.span("kernel", device=True):
        x_hat, errs = ac.approx_channel_batch_kernel(
            xp, seeds, noise_powers, large_scale_gains,
            bits_per_symbol=bits_per_symbol, fading=fading,
            fade_block=fade_block, clamp_mask=clamp_mask,
            block_words=block_words, word_bits=word_bits,
            num_active=num_active)
    errs = errs - _padding_errors(x_hat[:, n:], word_bits)
    return x_hat[:, :n], errs


def _link_params(cfg, c: int, snr_db, device):
    """Per-client noise powers and gains ``(C,)`` float32 on ``device``."""
    ch = cfg.channel
    if snr_db is None:
        npow = torch.full((c,), ch.noise_power, dtype=torch.float32,
                          device=device)
    else:
        npow = channel_lib.noise_power_for(ch, snr_db, device).contiguous()
    gains = torch.full((c,), ch.large_scale_gain, dtype=torch.float32,
                       device=device)
    return npow, gains


def _batch_stats(c: int, n: int, wb: int, k: int, errs, device):
    from repro_torch.core import transport as transport_lib

    return transport_lib._batch_stats(c, n * (wb // k), 1, errs, n * wb,
                                      n * wb, device=device)


def approx_channel_transmit_batch(x: torch.Tensor, keys: torch.Tensor, cfg,
                                  snr_db=None, *, num_active=None):
    """Batched TransportConfig adapter behind ``transport.transmit_batch``.

    Args:
      x: ``(C, N)`` float32 payload matrix.
      keys: ``(C, 2)`` per-client keys (``transport.client_keys``).
      cfg: TransportConfig with mode 'approx'|'naive'.
      snr_db: optional ``(C,)`` per-client SNR; ``None`` = config scalar.
      num_active: compute only the first ``num_active`` rows.

    Returns ``(x_hat (C, N) float32, TxStats with (C,) fields)``.
    """
    c, n = x.shape
    with spans.span("keys"):
        seeds = _seed_from_key(keys).to(x.device)
    wb, clamp_mask, k = _transport_kernel_params(cfg)
    npow, gains = _link_params(cfg, c, snr_db, x.device)
    x_hat, errs = approx_channel_batch(
        x, seeds, npow, gains, bits_per_symbol=k, fading=cfg.channel.fading,
        fade_block=cfg.channel.block_len, clamp_mask=clamp_mask,
        word_bits=wb, num_active=num_active)
    return x_hat.to(torch.float32), _batch_stats(c, n, wb, k, errs, x.device)


def approx_channel_batch_aggregate(x, seeds, noise_powers, large_scale_gains,
                                   weights, *, bits_per_symbol: int = 2,
                                   fading: str = "rayleigh",
                                   fade_block: int = 64,
                                   clamp_mask: int = 0xBFFFFFFF,
                                   block_words: int = 1024,
                                   word_bits: int = 32, num_active=None):
    """Fused batch + weighted aggregation over the client axis (K2).

    Pads ``(C, N)`` payloads to a tile multiple; bit errors are masked to
    the first ``N`` words inside the kernel (``valid_words``), so no
    padding subtraction happens here. Returns ``(agg (N,) float32,
    bit_errors (C,) int32)``.
    """
    c, n = x.shape
    xp = _tiled(x, word_bits, block_words)
    with spans.span("kernel", device=True):
        agg, errs = ac.approx_channel_batch_aggregate_kernel(
            xp, seeds, noise_powers, large_scale_gains,
            weights.to(torch.float32).contiguous(),
            bits_per_symbol=bits_per_symbol, fading=fading,
            fade_block=fade_block, clamp_mask=clamp_mask,
            block_words=block_words, word_bits=word_bits, valid_words=n,
            num_active=num_active)
    return agg[:n], errs


def approx_channel_transmit_batch_aggregate(x: torch.Tensor,
                                            keys: torch.Tensor, cfg, snr_db,
                                            weights, *, num_active=None):
    """Batched TransportConfig adapter with in-kernel aggregation: the
    per-client rows collapse to ``sum_c weights[c] * x_hat[c]`` (weights
    used as given — normalize first). Returns ``(agg (N,) float32,
    TxStats with (C,) fields)``."""
    c, n = x.shape
    with spans.span("keys"):
        seeds = _seed_from_key(keys).to(x.device)
    wb, clamp_mask, k = _transport_kernel_params(cfg)
    npow, gains = _link_params(cfg, c, snr_db, x.device)
    agg, errs = approx_channel_batch_aggregate(
        x, seeds, npow, gains,
        torch.as_tensor(weights, dtype=torch.float32, device=x.device),
        bits_per_symbol=k, fading=cfg.channel.fading,
        fade_block=cfg.channel.block_len, clamp_mask=clamp_mask,
        word_bits=wb, num_active=num_active)
    return agg, _batch_stats(c, n, wb, k, errs, x.device)
