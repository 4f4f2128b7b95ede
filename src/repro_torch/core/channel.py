"""Wireless uplink channel parameters (port, part; paper Sec. II-B eq. 7).

r = sqrt(p d^-alpha) h s + n,   h ~ CN(0,1),   n ~ CN(0, sigma^2)

Counterpart of ``repro.core.channel`` for what the kernel path needs:
``ChannelConfig``, ``noise_power_for``, ``snr_db_vector`` and
``per_client_snr_db``. ``snr_db`` is the average received symbol SNR, so
sigma^2 = p d^-alpha / snr_lin. The channel draws themselves happen inside
the kernels (counter RNG); the layered ``transmit``/``equalize`` path is
not ported yet.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Any

import numpy as np
import torch

__all__ = [
    "ChannelConfig",
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
