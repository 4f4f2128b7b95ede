"""Wireless uplink channel model (port; paper Sec. II-B, eq. (7)).

r = sqrt(p d^-alpha) h s + n,   h ~ CN(0,1),   n ~ CN(0, sigma^2)

Counterpart of ``repro.core.channel``. ``snr_db`` is the average received
symbol SNR, so sigma^2 = p d^-alpha / snr_lin; the PS knows the composite
gain ``c = sqrt(p d^-alpha) h`` (coherent detection). ``block_rayleigh``
holds ``h`` over runs of ``block_len`` symbols.

:func:`transmit` draws the reference's fading and noise: ``key -> (k_h,
k_n)``, each ``-> (re, im)`` keys of ``prng.normal``. It also takes a batch
of keys ``(..., 2)`` with symbols ``(..., n_sym)``, every row drawing from
its own key exactly as a single call would (the reference vmaps instead).
Complex values are computed on their real and imaginary parts with
separate float32 operations: the products and the zero-forcing division
(Smith's algorithm, the one XLA uses) round the same on every device and
layout. XLA on the CPU contracts those multiply-adds into fmas, so
against the reference the received symbols agree to a few ULP, besides
the few ULP of ``prng.normal``.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Any

import numpy as np
import torch

from repro_torch.core import prng

__all__ = [
    "ChannelConfig",
    "transmit",
    "equalize",
    "noise_var_post_eq",
    "noise_power_for",
    "per_client_snr_db",
    "snr_db_vector",
]


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Uplink parameters. All powers are linear (not dB) except ``snr_db``.

    ``snr_db`` is a scalar (every client sees the same average SNR, the
    paper's setup) or a per-client sequence (heterogeneous links).
    """

    snr_db: Any = 10.0  # float, or per-client tuple/array of floats
    fading: str = "rayleigh"  # "rayleigh" | "awgn" | "block_rayleigh"
    block_len: int = 64  # symbols per fading block (block_rayleigh only)
    tx_power: float = 1.0
    distance: float = 10.0
    pathloss_exp: float = 3.0

    @property
    def large_scale_gain(self) -> float:
        """Mean received power ``p * d^-alpha`` (linear path-loss model)."""
        return self.tx_power * self.distance ** (-self.pathloss_exp)

    @property
    def noise_power(self) -> float:
        """Scalar receiver noise power sigma^2 = p d^-alpha / snr_lin."""
        if not _is_scalar_snr(self.snr_db):
            raise TypeError(
                "ChannelConfig.noise_power needs a scalar snr_db; per-client "
                "arrays go through transport.transmit_batch / noise_power_for()"
            )
        return self.large_scale_gain / (10.0 ** (float(self.snr_db) / 10.0))

    def with_snr(self, snr_db) -> "ChannelConfig":
        """Copy of this config at a different average SNR."""
        return dataclasses.replace(self, snr_db=snr_db)


def _is_scalar_snr(snr_db) -> bool:
    """True for Python/numpy real scalars (incl. 0-d arrays)."""
    if isinstance(snr_db, numbers.Real):
        return True
    return getattr(snr_db, "ndim", None) == 0


def noise_power_for(cfg: ChannelConfig, snr_db, device=None) -> torch.Tensor:
    """float32 noise power for an explicit (possibly ``(C,)``) SNR in dB.

    The dB -> linear ``pow`` runs in float32 as in the reference, whose
    float32 ``pow`` is a different routine: equal to a few ULP, not exact.
    """
    snr = torch.as_tensor(snr_db, dtype=torch.float32, device=device)
    # tensor / tensor: PyTorch turns a division by a Python scalar into a
    # multiply by its reciprocal, which rounds differently.
    lin = torch.pow(10.0, snr / torch.full_like(snr, 10.0))
    return torch.full_like(lin, cfg.large_scale_gain) / lin


def snr_db_vector(snr_db, num_clients: int, device=None) -> torch.Tensor:
    """Broadcast/validate an explicit per-client SNR to ``(num_clients,)``.

    Accepts a scalar, single-element, or length-``num_clients`` value;
    anything else raises ValueError (a 2-D grid is rejected rather than
    flattened, which would scramble the client <-> SNR pairing).
    """
    arr = torch.as_tensor(snr_db, dtype=torch.float32, device=device)
    if arr.ndim > 1:
        raise ValueError(
            f"snr_db must be a scalar or 1-D per-client vector; got shape "
            f"{tuple(arr.shape)}")
    arr = arr.reshape(-1)
    if arr.shape[0] == 1:
        return arr.expand(num_clients)
    if arr.shape[0] != num_clients:
        raise ValueError(
            f"snr_db has {arr.shape[0]} entries but batch has {num_clients} "
            f"clients")
    return arr


def per_client_snr_db(cfg: ChannelConfig, num_clients: int, device=None):
    """``cfg.snr_db`` as a per-client view, or ``None`` for a scalar SNR
    (callers then use the scalar noise power, as the reference does)."""
    if _is_scalar_snr(cfg.snr_db):
        return None
    return snr_db_vector(np.asarray(cfg.snr_db, np.float32), num_clients,
                         device)


def _f32_tensor(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _cn(key: torch.Tensor, shape, var):
    """Complex normal CN(0, var) as ``(re, im)`` float32, shape
    ``key.shape[:-1] + shape``. ``var`` is a Python float or a per-key
    float32 tensor ``key.shape[:-1]``."""
    kr, ki = prng.split_batched(key)
    if isinstance(var, torch.Tensor):
        s = torch.sqrt(var / 2.0).reshape(var.shape + (1,) * len(shape))
    else:
        s = torch.sqrt(_f32_tensor(var / 2.0, key.device))
    return prng.normal(kr, shape) * s, prng.normal(ki, shape) * s


def transmit(symbols: torch.Tensor, key: torch.Tensor, cfg: ChannelConfig, *,
             snr_db=None):
    """Pass unit-energy symbols through the uplink.

    Args:
      symbols: ``(..., n_sym)`` complex64 constellation points.
      key: PRNG key ``(2,)``, or one per row ``(..., 2)``.
      cfg: channel parameters.
      snr_db: optional override of ``cfg.channel.snr_db``: a scalar, or a
        float32 tensor ``key.shape[:-1]`` (one per row).

    Returns ``(r, c)``: received symbols and the composite gain known at
    the PS, both complex64 shaped like ``symbols``.
    """
    n_sym = symbols.shape[-1]
    dev = symbols.device
    key = key.to(dev)
    k_h, k_n = prng.split_batched(key)
    amp = float(torch.sqrt(_f32_tensor(cfg.large_scale_gain, "cpu")))
    if cfg.fading == "awgn":
        hr = torch.ones(key.shape[:-1] + (n_sym,), device=dev)
        hi = torch.zeros_like(hr)
    elif cfg.fading == "rayleigh":
        hr, hi = _cn(k_h, (n_sym,), 1.0)
    elif cfg.fading == "block_rayleigh":
        n_blocks = -(-n_sym // cfg.block_len)
        hr, hi = (h.repeat_interleave(cfg.block_len, dim=-1)[..., :n_sym]
                  for h in _cn(k_h, (n_blocks,), 1.0))
    else:
        raise ValueError(f"unknown fading {cfg.fading!r}")
    cr, ci = hr * amp, hi * amp
    npow = (cfg.noise_power if snr_db is None
            else noise_power_for(cfg, snr_db, dev))
    nr, ni = _cn(k_n, (n_sym,), npow)
    sr, si = symbols.real, symbols.imag
    rr = (cr * sr - ci * si) + nr
    ri = (cr * si + ci * sr) + ni
    return torch.complex(rr, ri), torch.complex(cr, ci)


def equalize(r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Coherent (zero-forcing) equalization ``y = r / c`` by Smith's
    algorithm, each operation rounded on its own."""
    ar, ai, br, bi = r.real, r.imag, c.real, c.imag
    big = br.abs() >= bi.abs()
    rat = torch.where(big, bi / br, br / bi)
    den = torch.where(big, br + bi * rat, bi + br * rat)
    yr = torch.where(big, ar + ai * rat, ar * rat + ai) / den
    yi = torch.where(big, ai - ar * rat, ai * rat - ar) / den
    return torch.complex(yr, yi)


def noise_var_post_eq(c: torch.Tensor, cfg: ChannelConfig, *,
                      snr_db=None) -> torch.Tensor:
    """Per-symbol noise variance after equalization (for soft LLRs):
    ``sigma^2 / max(|c|^2, 1e-20)``, float32 shaped like ``c``; ``snr_db``
    overrides ``cfg.snr_db`` as in :func:`transmit`."""
    g2 = torch.clamp_min(c.real * c.real + c.imag * c.imag, 1e-20)
    if snr_db is None:
        npow = torch.full_like(g2, cfg.noise_power)
    else:
        npow = noise_power_for(cfg, snr_db, c.device)
        npow = npow.reshape(npow.shape + (1,) * (g2.ndim - npow.ndim))
    return npow / g2
