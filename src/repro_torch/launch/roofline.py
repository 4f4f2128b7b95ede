"""Uplink traffic model (port of the analytic part of
``repro.launch.roofline``).

``uplink_traffic`` counts HBM bytes per payload float for the three
uplink paths, as the reference does; the seconds use the NVIDIA H100
SXM's HBM3 rate (``HBM_BW``, 3.35 TB/s on the data sheet), not the TPU
v5e constants of the reference. The reference's HLO-based parts
(``load_artifacts``, ``extrapolate``, ``analyze``) read XLA dry-run
artifacts and have no counterpart here yet.
"""

from __future__ import annotations

__all__ = ["HBM_BW", "uplink_traffic", "transport_traffic"]

HBM_BW = 3.35e12  # B/s, NVIDIA H100 SXM (HBM3), data sheet

_WIRE_BITS = {"float32": 32, "bfloat16": 16}


def uplink_traffic(num_clients: int, *, bits_per_symbol: int = 2,
                   wire_dtype: str = "float32",
                   n_floats: int | None = None) -> dict:
    """Analytic HBM bytes per payload float for one full round.

    Per payload float with ``wb``-bit wire words and ``n_sym = wb / k``
    symbols, the layered pipeline materializes:

        wire words in+out (r/w each)      4 * wb/8
        tx symbol indices, int32 (w+r)    8 * n_sym
        complex64 channel stream (w+r)   16 * n_sym
        equalized stream (read)           8 * n_sym
        rx symbol indices, int32 (w+r)    8 * n_sym
        ------------------------------------------
        uplink total             wb/2 + 40 * n_sym   (= 656 B at QPSK f32)

    The batch kernel (K1) reads 4 B and writes 4 B per float; the fused
    kernel (K2) writes each aggregate word once for all C clients
    (4 + 4/C). The unfused paths add the aggregation pass (4 + 4/C).
    These are the reference's counts (its layered stream is int32 /
    complex64); the port's layered PHY holds int64 words, so it moves more.

    Returns bytes/float per path, ratios vs the fused kernel, and — with
    ``n_floats`` — memory-bound seconds per round at ``HBM_BW`` (H100).
    """
    wb = _WIRE_BITS[wire_dtype]
    c = float(num_clients)
    n_sym = wb / bits_per_symbol
    layered_uplink = wb / 2.0 + 40.0 * n_sym
    agg_pass = 4.0 + 4.0 / c  # read x_hat + amortized aggregate write
    bpf = {
        "jnp_layered": layered_uplink + agg_pass,
        "kernel_batch": 8.0 + agg_pass,
        "kernel_fused": 4.0 + 4.0 / c,
    }
    out = {
        "num_clients": num_clients,
        "bits_per_symbol": bits_per_symbol,
        "wire_dtype": wire_dtype,
        "bytes_per_float": bpf,
        "ratio_vs_fused": {k: v / bpf["kernel_fused"] for k, v in bpf.items()},
    }
    if n_floats is not None:
        out["hbm_s"] = {k: num_clients * n_floats * v / HBM_BW
                        for k, v in bpf.items()}
    return out


def transport_traffic(cfg, num_clients: int,
                      n_floats: int | None = None) -> dict:
    """:func:`uplink_traffic` with the modulation order and wire dtype of a
    ``repro_torch.core.transport.TransportConfig``."""
    return uplink_traffic(num_clients,
                          bits_per_symbol=cfg.scheme.bits_per_symbol,
                          wire_dtype=cfg.wire_dtype, n_floats=n_floats)
