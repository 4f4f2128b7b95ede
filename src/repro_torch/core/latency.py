"""Airtime of one FL uplink round (port, part; paper Sec. V, Fig. 3).

    t_round(mode) = transmissions * t_overhead + data_symbols / symbol_rate

Counterpart of ``repro.core.latency`` for ``PhyTimings`` and
``round_airtime``. The ECRT calibration (``calibrate_ecrt`` and its
curves) comes with the ECRT item of the ROADMAP.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["PhyTimings", "round_airtime"]


@dataclasses.dataclass(frozen=True)
class PhyTimings:
    """PHY timing constants that convert transport stats into airtime."""

    symbol_rate: float = 13e6  # complex symbols / s (52 subcarriers / 4us)
    t_overhead: float = 200e-6  # preamble + SIFS + ACK per transmission
    fec_encode_overhead: float = 0.05  # fractional airtime stall for FEC proc


def round_airtime(stats, timings: PhyTimings, mode: str):
    """Airtime (seconds) of one uplink round given transport stats; float32
    tensors shaped like the stats fields."""
    sym = stats.data_symbols
    # tensor / tensor: a division by a Python scalar would become a
    # multiply by its reciprocal, which rounds differently.
    t_data = sym / torch.full_like(sym, timings.symbol_rate)
    t_ovh = stats.transmissions * timings.t_overhead
    if mode == "ecrt":
        t_data = t_data * (1.0 + timings.fec_encode_overhead)
    return t_data + t_ovh
