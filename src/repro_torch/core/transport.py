"""Composable gradient transport (port, part; the paper's Sec. IV uplink).

Counterpart of ``repro.core.transport`` for the main path: the
``perfect`` mode and the kernel path of ``naive``/``approx``, single-client
(``transmit_flat``) and batched (``transmit_batch``), with the fused
uplink + aggregation (``transmit_batch_aggregate``) and the pytree
front-ends of both.

The key schedule is the reference's: client ``i`` of a batch draws
``fold_in(key, client_offset + i)`` (:func:`client_keys`), and each
client's kernel seed is ``randint(key_i, (), 0, int32 max)``, so the
port's channel realizations are the reference's, draw for draw.

Pytrees are dicts of tensors (nested dicts allowed). They flatten in
``jax.tree_util.tree_flatten`` order — dict keys sorted — so every float
lands in the same tile, and so gets the same RNG draws, as in the
reference. Parameters keep the reference's layout (FC weights are
``(in, out)``).

Not ported yet (they raise ``NotImplementedError``): ``use_kernel=False``
on ``naive``/``approx`` (the layered PHY of ``core/channel.py::transmit``
and ``core/modulation.py::demod_hard``) and ``mode="ecrt"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core import channel as channel_lib
from repro_torch.core import keylanes
from repro_torch.core import modulation as mod_lib
from repro_torch.core import prng
from repro_torch.obs import spans

__all__ = [
    "TransportConfig",
    "TxStats",
    "client_keys",
    "transmit_flat",
    "transmit_batch",
    "transmit_pytree_batch",
    "transmit_batch_aggregate",
    "transmit_pytree_batch_aggregate",
]

_LAYERED_PHY = ("use_kernel=False on naive/approx (the layered PHY of "
                "core/channel.py::transmit and core/modulation.py::demod_hard) "
                "is not ported yet: ROADMAP Queue 1, item 1 'Layered PHY'")
_ECRT = ("mode='ecrt' (LDPC + retransmission) is not ported yet: ROADMAP "
         "Queue 1, item 2 'ECRT, latency, bounds'")


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """One uplink transport: wire mode, modulation and channel.

    The fields are the reference's that the kernel path reads; the layered
    PHY's ``interleave``/``chunk_elems`` and the ECRT knobs (``ldpc``,
    ``max_tx``, ``simulate_fec``, ``ecrt_expected_tx``) come with those
    paths.
    """

    mode: str = "approx"  # perfect | naive | approx | ecrt
    modulation: str = "qpsk"
    channel: channel_lib.ChannelConfig = dataclasses.field(
        default_factory=channel_lib.ChannelConfig)
    clamp_bound: float = 2.0  # paper: |g| < 2 -> clear bit 30 only
    wire_dtype: str = "float32"  # "float32" (paper) or "bfloat16"
    use_kernel: bool = False  # route through the fused CUDA kernels

    @property
    def scheme(self) -> mod_lib.ModScheme:
        """The resolved :class:`~repro_torch.core.modulation.ModScheme`."""
        return mod_lib.MOD_SCHEMES[self.modulation]


@dataclasses.dataclass
class TxStats:
    """Per-uplink transmission statistics (units as in the reference).

    * ``data_symbols`` — complex modulation symbols put on the air.
    * ``transmissions`` — PHY transmissions (1 for perfect/naive/approx).
    * ``bit_errors`` — residual flipped payload bits after the receiver.
    * ``n_bits`` — payload bits offered (``n_floats * wire_bits``).
    * ``bits_on_air`` — bits actually put on the air.

    Fields are float32 tensors: scalars for one uplink, ``(num_clients,)``
    for a batch.
    """

    data_symbols: torch.Tensor
    transmissions: torch.Tensor
    bit_errors: torch.Tensor
    n_bits: torch.Tensor
    bits_on_air: Any = None

    @property
    def ber(self) -> torch.Tensor:
        """End-to-end payload bit-error rate (``bit_errors / n_bits``)."""
        return self.bit_errors / torch.clamp_min(self.n_bits, 1.0)


def _stats(data_symbols, transmissions, bit_errors, n_bits, bits_on_air=None,
           *, device=None) -> TxStats:
    def f(v):
        return torch.as_tensor(v, device=device).to(torch.float32)

    return TxStats(f(data_symbols), f(transmissions), f(bit_errors), f(n_bits),
                   bits_on_air=None if bits_on_air is None else f(bits_on_air))


def _check_mode(cfg: TransportConfig) -> None:
    """Raise for the modes this slice does not port."""
    if cfg.mode == "ecrt":
        raise NotImplementedError(_ECRT)
    if cfg.mode in ("naive", "approx"):
        if not cfg.use_kernel:
            raise NotImplementedError(_LAYERED_PHY)
    elif cfg.mode != "perfect":
        raise ValueError(f"unknown transport mode {cfg.mode!r}")


def _payload(x, device, ndim: int, name: str) -> torch.Tensor:
    x = torch.as_tensor(x).to(device=resolve_device(device),
                              dtype=torch.float32)
    if x.ndim != ndim:
        raise ValueError(f"{name} wants a {ndim}-D payload; got "
                         f"{tuple(x.shape)}")
    return x


def transmit_flat(x, key: torch.Tensor, cfg: TransportConfig, *, snr_db=None,
                  device=None):
    """Transmit one client's flat float vector.

    Args:
      x: ``(N,)`` payload (cast to float32; wire format per
        ``cfg.wire_dtype``).
      key: PRNG key ``(2,)`` for this uplink's fading + noise realization.
      cfg: transport configuration.
      snr_db: optional scalar override of ``cfg.channel.snr_db``.
      device: where to run; ``None`` is the GPU.

    Returns ``(x_hat (N,) float32, TxStats)``.
    """
    _check_mode(cfg)
    x = _payload(x, device, 1, "transmit_flat")
    n = x.shape[0]
    wb = 16 if cfg.wire_dtype == "bfloat16" else 32
    k = cfg.scheme.bits_per_symbol
    if cfg.mode == "perfect":
        return x, _stats(n * wb // k, 1, 0, n * wb, n * wb, device=x.device)
    from repro_torch.kernels import ops as kernel_ops

    return kernel_ops.approx_channel_transmit(x, key, cfg, snr_db=snr_db)


def client_keys(key: torch.Tensor, num_clients: int, offset: int = 0):
    """The batched uplink's key schedule: ``key_i = fold_in(key, offset + i)``.

    Returns ``(num_clients, 2)`` keys.
    """
    keylanes.check_range(offset, num_clients)
    idx = torch.arange(num_clients, dtype=torch.int64,
                       device=key.device) + offset
    return prng.fold_in(key, idx)


def _resolve_batch_snr(cfg: TransportConfig, num_clients: int, snr_db,
                       device):
    """Per-client SNR column: explicit override > config > ``None``
    (homogeneous: the scalar noise power, as ``transmit_flat``)."""
    if snr_db is not None:
        return channel_lib.snr_db_vector(snr_db, num_clients, device)
    return channel_lib.per_client_snr_db(cfg.channel, num_clients, device)


def _batch_with_keys(x: torch.Tensor, keys: torch.Tensor,
                     cfg: TransportConfig, snr_vec):
    """Single-mode batch over explicit per-client keys."""
    if cfg.mode == "perfect":
        c, n = x.shape
        wb = 16 if cfg.wire_dtype == "bfloat16" else 32
        k = cfg.scheme.bits_per_symbol
        full = lambda v: torch.full((c,), float(v), dtype=torch.float32,
                                    device=x.device)
        return x, TxStats(full(n * wb // k), full(1), full(0), full(n * wb),
                          bits_on_air=full(n * wb))
    from repro_torch.kernels import ops as kernel_ops

    return kernel_ops.approx_channel_transmit_batch(x, keys, cfg, snr_vec)


def transmit_batch(x, key: torch.Tensor, cfg: TransportConfig, *,
                   snr_db=None, client_offset: int = 0, device=None):
    """Transmit ``num_clients`` payloads through independent fading uplinks.

    One K1 launch on the kernel path. Client ``i`` uses
    ``fold_in(key, client_offset + i)``, so the result equals a loop of
    :func:`transmit_flat` over that schedule.

    Args:
      x: ``(num_clients, N)`` payload matrix (cast to float32).
      key: base PRNG key ``(2,)``.
      cfg: transport configuration (``cfg.channel.snr_db`` may be
        per-client).
      snr_db: optional per-client SNR override, scalar or ``(num_clients,)``.
      client_offset: global index of row 0.
      device: where to run; ``None`` is the GPU.

    Returns ``(x_hat (num_clients, N) float32, TxStats with (num_clients,)
    fields)``.
    """
    _check_mode(cfg)
    x = _payload(x, device, 2, "transmit_batch")
    num_clients = x.shape[0]
    snr_vec = _resolve_batch_snr(cfg, num_clients, snr_db, x.device)
    with spans.span("keys"):
        keys = client_keys(key, num_clients, client_offset)
    return _batch_with_keys(x, keys, cfg, snr_vec)


def _scan_weighted_sum(rows: torch.Tensor, weights, num_active=None):
    """``sum_c weights[c] * rows[c]`` in client order, one multiply and one
    add per client per element — the fused kernel's arithmetic, and the one
    place that order is written (``aggregation.fedsgd_aggregate_batch`` is
    this loop on normalized weights). Rows at or beyond ``num_active`` are
    skipped (not given weight zero, which would still turn a NaN lane into
    a NaN sum)."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=rows.device)
    rows = rows.to(torch.float32)
    n_rows = rows.shape[0] if num_active is None else min(
        rows.shape[0], int(num_active))
    agg = torch.zeros(rows.shape[1:], dtype=torch.float32, device=rows.device)
    for c in range(n_rows):
        agg = agg + w[c] * rows[c]
    return agg


def _batch_aggregate_with_keys(x, keys, cfg, snr_vec, weights):
    """Single-mode batch + weighted aggregation over explicit keys: K2 on
    the kernel path, the client-order sum over the batch otherwise."""
    if cfg.mode in ("naive", "approx"):
        from repro_torch.kernels import ops as kernel_ops

        return kernel_ops.approx_channel_transmit_batch_aggregate(
            x, keys, cfg, snr_vec, weights)
    x_hat, stats = _batch_with_keys(x, keys, cfg, snr_vec)
    return _scan_weighted_sum(x_hat, weights), stats


def transmit_batch_aggregate(x, key: torch.Tensor, cfg: TransportConfig,
                             weights, *, snr_db=None, client_offset: int = 0,
                             device=None):
    """Fused uplink + aggregation: ``sum_c weights[c] * x_hat[c]`` in one
    pass (one K2 launch on the kernel path).

    Bit-identical to :func:`transmit_batch` followed by
    ``aggregation.fedsgd_aggregate_batch`` with the same, already
    normalized, weights: same key schedule, same client-order sum.

    Returns ``(agg (N,) float32, TxStats with (num_clients,) fields)``.
    """
    _check_mode(cfg)
    x = _payload(x, device, 2, "transmit_batch_aggregate")
    num_clients = x.shape[0]
    snr_vec = _resolve_batch_snr(cfg, num_clients, snr_db, x.device)
    with spans.span("keys"):
        keys = client_keys(key, num_clients, client_offset)
    return _batch_aggregate_with_keys(x, keys, cfg, snr_vec, weights)


def tree_flatten(tree) -> tuple[list, Any]:
    """Leaves of a (nested) dict of tensors in ``jax.tree_util`` order —
    dict keys sorted — and the structure to rebuild it."""
    if isinstance(tree, dict):
        leaves, spec = [], []
        for k in sorted(tree):
            sub_leaves, sub_spec = tree_flatten(tree[k])
            leaves.extend(sub_leaves)
            spec.append((k, sub_spec, len(sub_leaves)))
        return leaves, spec
    return [tree], None


def tree_unflatten(spec, leaves: list):
    """Inverse of :func:`tree_flatten`."""
    if spec is None:
        return leaves[0]
    out, off = {}, 0
    for k, sub_spec, count in spec:
        out[k] = tree_unflatten(sub_spec, leaves[off:off + count])
        off += count
    return out


def _flatten_client_tree(tree):
    """Stack a ``(num_clients, ...)``-leaved tree into one ``(C, D)``
    float32 matrix, in sorted-key order."""
    leaves, spec = tree_flatten(tree)
    num_clients = leaves[0].shape[0]
    flat = torch.cat([l.reshape(num_clients, -1).to(torch.float32)
                      for l in leaves], dim=1)
    return flat, (leaves, spec)


def transmit_pytree_batch(tree, key: torch.Tensor, cfg: TransportConfig, *,
                          snr_db=None, device=None):
    """Batched pytree uplink: every leaf has a leading client dim; each
    client's leaves flatten (sorted keys) into one ``(C, D)`` payload.

    Returns ``(tree_hat, stats)`` with shapes and dtypes restored.
    """
    flat, (leaves, spec) = _flatten_client_tree(tree)
    flat_hat, stats = transmit_batch(flat, key, cfg, snr_db=snr_db,
                                     device=device)
    out, off = [], 0
    for leaf in leaves:
        size = leaf[0].numel()
        out.append(flat_hat[:, off:off + size].reshape(leaf.shape)
                   .to(leaf.dtype))
        off += size
    return tree_unflatten(spec, out), stats


def transmit_pytree_batch_aggregate(tree, key: torch.Tensor,
                                    cfg: TransportConfig, weights, *,
                                    snr_db=None, device=None):
    """Pytree front-end of :func:`transmit_batch_aggregate`: the aggregate
    comes back in the tree's structure with the client axis reduced away
    (float32 whatever the leaf dtype, since it feeds the f32 update)."""
    flat, (leaves, spec) = _flatten_client_tree(tree)
    agg, stats = transmit_batch_aggregate(flat, key, cfg, weights,
                                          snr_db=snr_db, device=device)
    out, off = [], 0
    for leaf in leaves:
        size = leaf[0].numel()
        out.append(agg[off:off + size].reshape(leaf.shape[1:]))
        off += size
    return tree_unflatten(spec, out), stats
