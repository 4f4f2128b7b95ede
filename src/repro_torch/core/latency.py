"""Airtime of one FL uplink round and the ECRT calibration (port; paper
Sec. V, Fig. 3).

    t_round(mode) = transmissions * t_overhead + data_symbols / symbol_rate

Counterpart of ``repro.core.latency`` for ``PhyTimings``,
``round_airtime`` and the ECRT pricing: ``calibrate_ecrt`` runs the real
LDPC chain (encode -> channel -> soft min-sum decode -> retransmit) and
returns E[transmissions per codeword]; ``ecrt_expected_tx_curve``,
``interp_expected_tx`` and ``ecrt_expected_tx_profile`` turn it into
per-client E[tx] for heterogeneous SNR. ECRT pays the FEC-processing stall
on its data time and the per-transmission overhead E[tx] times;
``round_airtime_adaptive`` prices a mixed-mode round client by client,
and ``broadcast_airtime`` prices the downlink broadcast (one transmission
per distinct mode). ``arrival_times`` and ``sync_round_duration`` price
the buffered engine's event clock on the host, in float64.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import channel as channel_lib
from repro_torch.core import ecrt as ecrt_lib
from repro_torch.core import modulation as mod_lib
from repro_torch.core import prng

__all__ = ["DEFAULT_CALIB_CODEWORDS", "DEFAULT_CALIB_MAX_TX", "PhyTimings",
           "round_airtime", "round_airtime_adaptive", "broadcast_airtime",
           "arrival_times", "sync_round_duration",
           "calibrate_ecrt", "ecrt_expected_tx_curve", "interp_expected_tx",
           "ecrt_expected_tx_profile"]

# ECRT E[tx] pricing sample budget shared by every pricing entry point
# (the FL engine's resolve_ecrt_analytic among them), so one channel always
# resolves to one estimate. calibrate_ecrt's own larger defaults serve
# standalone measurement.
DEFAULT_CALIB_CODEWORDS = 48
DEFAULT_CALIB_MAX_TX = 6


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


def round_airtime_adaptive(stats, timings: PhyTimings, cfgs):
    """Per-client airtime (seconds) of a mixed-mode round: each client is
    priced under its row ``cfgs[stats.mode_idx[i]]``, and ECRT clients pay
    the FEC-processing stall on their data time. ``stats`` comes from
    ``transport.transmit_batch_adaptive``. Returns ``(num_clients,)``
    float32, as ``data_symbols / symbol_rate * (1 + stall) +
    transmissions * t_overhead``."""
    if stats.mode_idx is None:
        raise ValueError(
            "round_airtime_adaptive needs TxStats.mode_idx (from "
            "transmit_batch_adaptive); for single-mode stats use "
            "round_airtime")
    sym = stats.data_symbols
    stall = torch.tensor(
        [timings.fec_encode_overhead if c.mode == "ecrt" else 0.0
         for c in cfgs], dtype=torch.float32, device=sym.device)
    fec_stall = stall[stats.mode_idx.to(device=sym.device, dtype=torch.int64)]
    t_data = sym / torch.full_like(sym, timings.symbol_rate) * (1.0 + fec_stall)
    return t_data + stats.transmissions * timings.t_overhead


def broadcast_airtime(per_client_air, mode_idx=None) -> float:
    """Seconds the PS spends on one downlink broadcast.

    The uplink is TDMA, so its round costs the sum of the clients'
    airtimes; the downlink is a broadcast, transmitted once per encoding
    and heard by every client of that mode. So the round's downlink cost
    is, per distinct mode in the cohort, the per-mode max of the clients'
    reception airtime (which also covers per-client E[tx]-rescaled ECRT
    rows), summed over the modes present.

    Args:
      per_client_air: ``(num_clients,)`` reception airtime,
        ``round_airtime`` or ``round_airtime_adaptive`` of the broadcast's
        ``TxStats``.
      mode_idx: the stats' per-client mode vector, or ``None`` for a
        single-mode broadcast (one transmission in all).

    Returns a host float: the same float32 numpy reductions as the
    reference.
    """
    if isinstance(per_client_air, torch.Tensor):
        per_client_air = per_client_air.cpu()
    air = np.asarray(per_client_air, np.float32).reshape(-1)
    if air.size == 0:
        return 0.0
    if mode_idx is None:
        return float(air.max())
    if isinstance(mode_idx, torch.Tensor):
        mode_idx = mode_idx.cpu()
    modes = np.asarray(mode_idx).reshape(-1)
    return float(sum(float(air[modes == m].max()) for m in np.unique(modes)))


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu()
    return np.asarray(x, np.float64)


def arrival_times(t_dispatch: float, compute_s, air_s,
                  downlink_s: float = 0.0) -> np.ndarray:
    """Event-clock upload-arrival times of one dispatched wave, float64:
    ``t_dispatch + downlink_s + compute_s[i] + air_s[i]``, summed in that
    order. A dropped client (``air_s[i] == 0``) gets its ready-again time
    from the same formula. The clock stays on the host in float64, since
    the arrival order decides the buffered engine's aggregations."""
    return (np.float64(t_dispatch) + np.float64(downlink_s)
            + _host64(compute_s) + _host64(air_s))


def sync_round_duration(compute_s, air_s, active=None) -> float:
    """Wall-clock seconds of one synchronous (barrier) round: every active
    client computes in parallel, then the TDMA uplink serializes them, so
    ``max_i(compute_i) + sum_i(air_i)`` over the active clients (0.0 if
    none is)."""
    comp = _host64(compute_s).reshape(-1)
    air = _host64(air_s).reshape(-1)
    if active is not None:
        if isinstance(active, torch.Tensor):
            active = active.cpu()
        act = np.asarray(active, bool).reshape(-1)
        comp, air = comp[act], air[act]
    if comp.size == 0:
        return 0.0
    return float(comp.max() + air.sum())


def calibrate_ecrt(snr_db: float, modulation: str = "qpsk",
                   fading: str = "block_rayleigh", n_codewords: int = 256,
                   max_tx: int = 8, seed: int = 0, decoder: str = "minsum",
                   device=None) -> float:
    """Measure E[transmissions per codeword] for the real LDPC chain.

    Random payloads (``randint`` under ``PRNGKey(seed)``, as the reference)
    go through encode -> channel -> decode, and failed codewords are
    retransmitted over fresh channel draws up to ``max_tx`` times; returns
    the mean transmission count. Cached on canonical arguments (the SNR
    round-trips through float32) plus the device, so FL loops reuse the
    scalar. Default fading is per-codeword block Rayleigh: a codeword
    caught in a deep fade fails regardless of coding, the regime behind the
    paper's 3x (10 dB) vs 2x (20 dB) ECRT slowdown.

    ``decoder="bounded"`` is the paper's abstraction: LDPC(648, 1/2) has
    d_min = 15 and corrects 7 hard bit errors, so a transmission fails iff
    its hard-decision error count exceeds 7. ``"minsum"`` is the soft
    min-sum chain. ``device`` is where it runs (``None`` is the GPU).
    """
    return _calibrate_ecrt(
        float(np.float32(snr_db)), str(modulation), str(fading),
        int(n_codewords), int(max_tx), int(seed), str(decoder),
        str(resolve_device(device)))


@functools.lru_cache(maxsize=64)
def _calibrate_ecrt(snr_db, modulation, fading, n_codewords, max_tx, seed,
                    decoder, device) -> float:
    """The canonicalized, cached body of :func:`calibrate_ecrt`."""
    dev = torch.device(device)
    code = ecrt_lib.LdpcCode()
    scheme = mod_lib.MOD_SCHEMES[modulation]
    k_msg, k_ch = prng.split(prng.PRNGKey(seed, device=dev))
    msgs = prng.randint(k_msg, (n_codewords, code.k), 0, 2)
    cw = ecrt_lib.encode(msgs, code)
    n_cw, n_code = cw.shape
    k_mod = scheme.bits_per_symbol
    sym_per_cw = n_code // k_mod
    ch_cfg = channel_lib.ChannelConfig(snr_db=snr_db, fading=fading,
                                       block_len=sym_per_cw)
    weights = 1 << (k_mod - 1 - torch.arange(k_mod, device=dev))
    sym = (cw.reshape(n_cw, sym_per_cw, k_mod) * weights).sum(-1)
    tx = mod_lib.modulate(sym.reshape(-1), scheme)
    ok = torch.zeros((n_cw,), dtype=torch.bool, device=dev)
    tx_count = torch.zeros((n_cw,), dtype=torch.int64, device=dev)
    for kr in prng.split(k_ch, max_tx):
        if bool(ok.all()):
            break  # the reference's later rounds change nothing from here
        r, c = channel_lib.transmit(tx, kr, ch_cfg)
        y = channel_lib.equalize(r, c)
        pend = ~ok
        if decoder == "bounded":
            rx = mod_lib.demod_hard(y, scheme).reshape(n_cw, sym_per_cw)
            errs = mod_lib.popcount(rx[pend] ^ sym[pend]).sum(-1)
            ok_pend = errs <= 7
        else:
            nv = channel_lib.noise_var_post_eq(c, ch_cfg)
            llr = mod_lib.bit_llrs(y, nv, scheme).reshape(n_cw, n_code)
            _, ok_pend = ecrt_lib.decode(llr[pend], code)
        tx_count += pend
        ok[pend] = ok_pend
    # the reference's mean: XLA multiplies by the count's reciprocal
    return float(tx_count.sum().to(torch.float32) * (1.0 / n_cw))


def ecrt_expected_tx_curve(grid_db, modulation: str = "qpsk", *,
                           fading: str = "block_rayleigh",
                           n_codewords: int = DEFAULT_CALIB_CODEWORDS,
                           max_tx: int = DEFAULT_CALIB_MAX_TX, device=None):
    """Calibrate E[transmissions] on an SNR grid (one cached point each).

    A client in a fade retransmits far more than the fleet average, so
    heterogeneous cohorts price ECRT per client from this curve. Returns
    ``(grid_db, e_tx)`` as ascending float32 tensors on the CPU.
    """
    grid = np.asarray(sorted(float(s) for s in np.asarray(grid_db).reshape(-1)),
                      np.float32)
    if grid.size == 0:
        raise ValueError("ecrt_expected_tx_curve needs a non-empty SNR grid")
    vals = np.asarray(
        [calibrate_ecrt(float(s), modulation, fading, n_codewords, max_tx,
                        device=device) for s in grid], np.float32)
    return torch.from_numpy(grid), torch.from_numpy(vals)


def interp_expected_tx(snr_db, grid, e_tx) -> torch.Tensor:
    """Per-entry E[tx] at ``snr_db`` by linear interpolation on a calibrated
    curve, clamped at the grid edges: ``jnp.interp``'s arithmetic, on the
    device of ``snr_db`` if it is a tensor."""
    dev = snr_db.device if isinstance(snr_db, torch.Tensor) else None
    x = torch.as_tensor(snr_db, dtype=torch.float32, device=dev)
    xp = torch.as_tensor(grid, dtype=torch.float32).to(x.device)
    fp = torch.as_tensor(e_tx, dtype=torch.float32).to(x.device)
    xs = x.reshape(-1)
    i = torch.searchsorted(xp, xs, right=True).clamp(1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = xs - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(xs < xp[0], fp[0], f)
    f = torch.where(xs > xp[-1], fp[-1], f)
    return f.reshape(x.shape)


def ecrt_expected_tx_profile(snr_db, modulation: str = "qpsk", *,
                             fading: str = "block_rayleigh",
                             n_codewords: int = DEFAULT_CALIB_CODEWORDS,
                             max_tx: int = DEFAULT_CALIB_MAX_TX,
                             max_grid: int = 4, device=None) -> np.ndarray:
    """Per-client E[tx] for a static SNR vector (the fixed-ECRT FL loops).

    Calibrates at each distinct SNR when there are at most ``max_grid`` of
    them (interpolation is then exact), else on a ``max_grid``-point linear
    grid spanning the cohort's range. Returns a float32 numpy vector
    matching ``snr_db``'s length (scalars give length 1).
    """
    snr = np.asarray(snr_db, np.float32).reshape(-1)
    uniq = np.unique(snr)
    if uniq.size <= max_grid:
        grid = uniq
    else:
        grid = np.linspace(float(snr.min()), float(snr.max()), max_grid,
                           dtype=np.float32)
    grid_t, vals_t = ecrt_expected_tx_curve(
        grid, modulation, fading=fading, n_codewords=n_codewords,
        max_tx=max_tx, device=device)
    return np.interp(snr, grid_t.numpy(), vals_t.numpy()).astype(np.float32)
