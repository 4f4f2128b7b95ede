"""Per-client transmission-mode policy: the paper's conditional mechanism
(port).

Counterpart of ``repro.link.policy``. A mode table orders link modes from
most protected to most aggressive (default: ECRT -> approx QPSK -> approx
16-QAM -> approx 256-QAM); :func:`choose_mode` maps estimated SNR to a
table index by thresholds with hysteresis, and :func:`build_mode_cfgs`
materialises the table as ``TransportConfig`` rows for
``transport.transmit_batch_adaptive``. The decisions are comparisons of
float32 values against float32 thresholds, so they are the reference's
exactly on equal inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import latency as latency_lib
from repro_torch.core import modulation as mod_lib
from repro_torch.core import transport as transport_lib

__all__ = [
    "DEFAULT_CALIB_CODEWORDS",
    "DEFAULT_CALIB_MAX_TX",
    "PolicyConfig",
    "fixed_policy",
    "mode_names",
    "initial_mode",
    "choose_mode",
    "downlink_mode",
    "ecrt_anchor_snr_db",
    "build_mode_cfgs",
    "compress_k_table",
]

DEFAULT_CALIB_CODEWORDS = latency_lib.DEFAULT_CALIB_CODEWORDS
DEFAULT_CALIB_MAX_TX = latency_lib.DEFAULT_CALIB_MAX_TX


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Threshold policy over an ordered mode table.

    ``modes[i]`` is a ``(transport_mode, modulation)`` pair; ``modes[0]``
    is the protected fallback. ``thresholds_db[i]`` is the estimated SNR
    above which mode ``i+1`` becomes eligible (ascending, one fewer than
    the modes). ``compress_ratios`` is the CSI-adaptive compression
    column, one kept fraction per mode, used by compressed runs
    (ROADMAP Queue 1, item 6).
    """

    modes: tuple = (
        ("ecrt", "qpsk"),
        ("approx", "qpsk"),
        ("approx", "16qam"),
        ("approx", "256qam"),
    )
    thresholds_db: tuple = (6.0, 16.0, 26.0)
    hysteresis_db: float = 2.0
    compress_ratios: tuple | None = None

    def __post_init__(self):
        if len(self.thresholds_db) != len(self.modes) - 1:
            raise ValueError(
                f"need len(modes)-1 = {len(self.modes) - 1} thresholds, got "
                f"{len(self.thresholds_db)}"
            )
        if list(self.thresholds_db) != sorted(self.thresholds_db):
            raise ValueError(f"thresholds must ascend: {self.thresholds_db}")
        if self.compress_ratios is not None:
            if len(self.compress_ratios) != len(self.modes):
                raise ValueError(
                    f"compress_ratios needs one entry per mode "
                    f"({len(self.modes)}), got {len(self.compress_ratios)}"
                )
            if any(not 0.0 < r <= 1.0 for r in self.compress_ratios):
                raise ValueError(
                    f"compress_ratios must lie in (0, 1]: "
                    f"{self.compress_ratios}"
                )


def fixed_policy(mode: str, modulation: str = "qpsk") -> PolicyConfig:
    """A degenerate single-mode policy (a fixed-transport baseline arm)."""
    return PolicyConfig(modes=((mode, modulation),), thresholds_db=())


def mode_names(cfg: PolicyConfig) -> list:
    """Labels of the mode table: ``["ecrt/qpsk", "approx/qpsk", ...]``."""
    return ["/".join(m) for m in cfg.modes]


def _snr_f32(snr_est_db) -> torch.Tensor:
    return torch.as_tensor(snr_est_db, dtype=torch.float32)


def _thresholds(cfg: PolicyConfig, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(cfg.thresholds_db, dtype=torch.float32,
                        device=like.device)


def initial_mode(snr_est_db, cfg: PolicyConfig) -> torch.Tensor:
    """Hysteresis-free threshold mapping (seeds round 0): int32 modes."""
    snr = _snr_f32(snr_est_db)
    thr = _thresholds(cfg, snr)
    return (snr[..., None] >= thr).sum(dim=-1).to(torch.int32)


def choose_mode(snr_est_db, prev_mode, cfg: PolicyConfig,
                observed=None) -> torch.Tensor:
    """Per-client mode given noisy CSI and the previous mode.

    With ``h = hysteresis_db / 2``: ``up`` counts thresholds cleared by
    ``+h`` (the highest mode the link may rise to), ``down`` those cleared
    by ``-h`` (the highest it may hold), and the mode is ``clip(prev, up,
    down)``. ``observed`` (0/1 per client) keeps absent clients at
    ``prev_mode``; ``None`` means everyone took part.
    """
    snr = _snr_f32(snr_est_db)
    thr = _thresholds(cfg, snr)
    h = torch.tensor(cfg.hysteresis_db / 2.0, dtype=torch.float32,
                     device=snr.device)
    up = (snr[..., None] >= thr + h).sum(dim=-1).to(torch.int32)
    down = (snr[..., None] >= thr - h).sum(dim=-1).to(torch.int32)
    prev = torch.as_tensor(prev_mode).to(device=snr.device,
                                         dtype=torch.int32)
    mode = torch.minimum(torch.maximum(prev, up), down)
    if observed is None:
        return mode
    seen = torch.as_tensor(observed).to(snr.device) > 0
    return torch.where(seen, mode, prev)


def downlink_mode(snr_est_db, cfg: PolicyConfig,
                  snr_offset_db: float = 0.0) -> torch.Tensor:
    """Per-client downlink mode from the same table at the shifted CSI
    (hysteresis-free)."""
    snr = _snr_f32(snr_est_db)
    return initial_mode(
        snr + torch.tensor(snr_offset_db, dtype=torch.float32,
                           device=snr.device), cfg)


def ecrt_anchor_snr_db(cfg: PolicyConfig, fallback_db: float) -> float:
    """The SNR where the table's ECRT row operates: the first threshold,
    or ``fallback_db`` for a threshold-less (fixed) table."""
    return float(cfg.thresholds_db[0]) if cfg.thresholds_db else float(
        fallback_db)


def compress_k_table(cfg: PolicyConfig, dim: int,
                     default_ratio: float) -> tuple:
    """Per-mode sparse slot budgets for a ``dim``-coordinate payload:
    ``max(1, round(ratio_i * dim))`` per mode."""
    ratios = (cfg.compress_ratios if cfg.compress_ratios is not None
              else (default_ratio,) * len(cfg.modes))
    return tuple(max(1, min(dim, int(round(r * dim)))) for r in ratios)


def build_mode_cfgs(base: transport_lib.TransportConfig, cfg: PolicyConfig,
                    *, ecrt_expected_tx: float | None = None,
                    calib_codewords: int = DEFAULT_CALIB_CODEWORDS,
                    calib_max_tx: int = DEFAULT_CALIB_MAX_TX,
                    anchor_fallback_db: float | None = None,
                    device=None):
    """Materialise the mode table as ``TransportConfig`` rows.

    Every row inherits ``base`` and overrides mode and modulation. ECRT
    rows use the analytic model (``simulate_fec=False``) at
    ``ecrt_expected_tx``, or, when that is ``None``, at E[tx] calibrated
    once per ECRT modulation by ``latency.calibrate_ecrt`` at
    :func:`ecrt_anchor_snr_db` (``anchor_fallback_db`` defaults to the base
    channel's mean SNR), on ``device`` (``None`` is the GPU).
    ``use_kernel`` carries over to the uncoded rows only. A modulation
    whose bits per symbol do not divide the wire word (64-QAM) is
    rejected.
    """
    rows = []
    wire_bits = 16 if base.wire_dtype == "bfloat16" else 32
    e_tx_by_mod = {}
    if ecrt_expected_tx is None and any(m == "ecrt" for m, _ in cfg.modes):
        if anchor_fallback_db is None:
            anchor_fallback_db = np.mean(
                np.asarray(base.channel.snr_db, np.float32))
        anchor = ecrt_anchor_snr_db(cfg, anchor_fallback_db)
        for m, mod in cfg.modes:
            if m == "ecrt" and mod not in e_tx_by_mod:
                e_tx_by_mod[mod] = latency_lib.calibrate_ecrt(
                    anchor, mod, n_codewords=calib_codewords,
                    max_tx=calib_max_tx, device=device)
    for mode, modulation in cfg.modes:
        k = mod_lib.MOD_SCHEMES[modulation].bits_per_symbol
        if mode in ("approx", "naive") and wire_bits % k != 0:
            raise ValueError(
                f"{modulation} ({k} bits/symbol) cannot carry the "
                f"{wire_bits}-bit wire words MSB-first; pick a modulation "
                f"whose bits_per_symbol divides {wire_bits}"
            )
        if mode != "ecrt":
            e_tx = 1.0
        elif ecrt_expected_tx is not None:
            e_tx = ecrt_expected_tx
        else:
            e_tx = e_tx_by_mod[modulation]
        rows.append(dataclasses.replace(
            base, mode=mode, modulation=modulation,
            use_kernel=base.use_kernel and mode in ("approx", "naive"),
            simulate_fec=False,
            ecrt_expected_tx=float(e_tx),
        ))
    return tuple(rows)
