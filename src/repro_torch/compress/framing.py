"""Sparse wire format: protected index header + approximate value payload
(port).

Counterpart of ``repro.compress.framing``. A sparse uplink carries two
legs per client, both on the client's radio:

* **value payload** — the ``(k,)`` selected values ride the transport
  unchanged under the client's transport key (``transport._batch_with_keys``:
  one K1 launch for the whole ``(M, k)`` batch on a ``use_kernel`` config,
  the layered PHY or ECRT otherwise). The reference sends each client's
  values through ``transmit_flat`` under a ``vmap``, which is K0 per
  client; K0 is K1 at C = 1 and K1 restarts its symbol counter per client
  with the client's own seed, so every row's words and bit errors are the
  reference's;
* **index header** — the ``(k,)`` coordinate indices, ``index_bits(dim)``
  bits each, on ``fold_in(client_key, HEADER_KEY_LANE)``:

  - ``"gray"``: two header bits per symbol on ``b0``/``b1`` (the I and Q
    Gray MSBs), every other position zero, through the layered channel;
  - ``"ecrt"``: the packed index words, bitcast to float32, through the
    rate-1/2 LDPC transport (analytic by default: exact bits);
  - ``"perfect"``: an error-free control channel, priced at full
    constellation packing.

The receiver drops indices that land out of range and adds the received
values into a dense vector; in-range duplicates (only a corrupted header
makes them) accumulate in update order, the reference's order
(``index_put_`` with ``accumulate=True``, sequential on the CPU and sorted
per index on the card).

Every function is written over a batch of clients; the single-client
calls are the batch of one. Indices are ``int64``; packed header words are
``uint32`` values held in ``int64``, MSB-first.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.compress import sparsify as sparsify_lib
from repro_torch.core import channel as channel_lib
from repro_torch.core import float_codec as fc
from repro_torch.core import keylanes
from repro_torch.core import modulation as mod_lib
from repro_torch.core import prng
from repro_torch.core import transport as transport_lib
from repro_torch.obs import spans

__all__ = [
    "HEADER_KEY_LANE",
    "index_bits",
    "pack_index_bits",
    "unpack_index_bits",
    "transmit_header",
    "scatter_received",
    "transmit_sparse",
    "transmit_sparse_batch",
    "sparse_batch_with_keys",
    "transmit_sparse_batch_adaptive",
]

HEADER_KEY_LANE = keylanes.HEADER_KEY_LANE


def _default_compression(compression):
    return (sparsify_lib.CompressionConfig() if compression is None
            else compression)


def index_bits(dim: int) -> int:
    """Bits needed to address a coordinate of a ``dim``-vector (>= 1)."""
    return max(1, int(dim - 1).bit_length())


def _shifts(n: int, device) -> torch.Tensor:
    return n - 1 - torch.arange(n, dtype=torch.int64, device=device)


def _index_bit_vector(indices: torch.Tensor, dim: int) -> torch.Tensor:
    """``(..., k)`` indices -> the flat ``(..., k * index_bits)`` 0/1
    header bit stream, MSB-first."""
    sh = _shifts(index_bits(dim), indices.device)
    return ((indices.to(torch.int64)[..., None] >> sh) & 1).flatten(-2)


def _bits_to_indices(bits: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    b = index_bits(dim)
    sh = _shifts(b, bits.device)
    return (bits.reshape(bits.shape[:-1] + (k, b)) << sh).sum(-1)


def pack_index_bits(indices, dim: int) -> torch.Tensor:
    """Pack ``(..., k)`` indices into ``(..., W)`` uint32 words, MSB-first,
    the bit stream zero-padded to a word boundary. Inverse:
    :func:`unpack_index_bits`."""
    bits = _index_bit_vector(torch.as_tensor(indices), dim)
    bits = F.pad(bits, (0, (-bits.shape[-1]) % 32))
    w = bits.reshape(bits.shape[:-1] + (-1, 32))
    return (w << _shifts(32, w.device)).sum(-1)


def unpack_index_bits(words, k: int, dim: int) -> torch.Tensor:
    """Inverse of :func:`pack_index_bits`: ``(..., W)`` words -> ``(..., k)``
    ``int64`` indices."""
    words = torch.as_tensor(words).to(torch.int64)
    bits = ((words[..., None] >> _shifts(32, words.device)) & 1).flatten(-2)
    return _bits_to_indices(bits[..., :k * index_bits(dim)], k, dim)


def _header_gray(indices, dim, keys, cfg, snr_vec):
    """Gray-MSB header leg for ``(C, k)`` indices: bit pairs on ``b0``/``b1``
    of each symbol, zeros elsewhere, through the layered channel on
    ``keys``. Returns ``(idx_rx, (symbols, extra_tx, bit_errors, n_bits,
    bits_on_air))``."""
    c, k = indices.shape
    km = cfg.scheme.bits_per_symbol
    bits = _index_bit_vector(indices, dim)
    n_hdr = bits.shape[1]
    bp = F.pad(bits, (0, n_hdr % 2)).reshape(c, -1, 2)
    sym = (bp[..., 0] << (km - 1)) | (bp[..., 1] << (km - 2))
    y, _ = transport_lib._through_channel(sym, keys, cfg, snr_vec)
    rx = mod_lib.demod_hard(y, cfg.scheme)
    bits_rx = torch.stack([(rx >> (km - 1)) & 1, (rx >> (km - 2)) & 1],
                          dim=-1).reshape(c, -1)[:, :n_hdr]
    errs = (bits_rx != bits).sum(-1)
    n_sym = sym.shape[1]
    return _bits_to_indices(bits_rx, k, dim), (n_sym, 0.0, errs, n_hdr,
                                               n_sym * km)


def _header_ecrt(indices, dim, keys, cfg, compression, snr_vec):
    """ECRT header leg: the packed index words through the LDPC transport
    (real or analytic as ``compression`` says)."""
    k = indices.shape[1]
    hcfg = dataclasses.replace(
        cfg, mode="ecrt", use_kernel=False, chunk_elems=0,
        simulate_fec=compression.header_simulate_fec,
        ecrt_expected_tx=compression.header_ecrt_expected_tx)
    x = fc.bits_to_f32(pack_index_bits(indices, dim))
    x_hat, st = transport_lib._batch_with_keys(x, keys, hcfg, snr_vec)
    idx_rx = unpack_index_bits(fc.f32_to_bits(x_hat), k, dim)
    return idx_rx, (st.data_symbols, st.transmissions - 1.0, st.bit_errors,
                    st.n_bits, st.bits_on_air)


def _header_perfect(indices, dim, cfg):
    """Error-free control-channel header, still priced on the air."""
    k = indices.shape[1]
    b, km = index_bits(dim), cfg.scheme.bits_per_symbol
    n_sym = -(-k * b // km)  # full constellation packing
    return indices, (n_sym, 0.0, 0.0, k * b, n_sym * km)


def _header_batch(indices, dim, keys, cfg, compression, snr_vec):
    """The header leg of a ``(C, k)`` batch on header keys ``(C, 2)``:
    ``(idx_rx (C, k), header TxStats with (C,) fields)`` (the stats'
    ``transmissions`` field holds the extra transmissions)."""
    c = indices.shape[0]
    if compression.header == "gray":
        idx_rx, parts = _header_gray(indices, dim, keys.to(indices.device),
                                     cfg, snr_vec)
    elif compression.header == "ecrt":
        idx_rx, parts = _header_ecrt(indices, dim, keys, cfg, compression,
                                     snr_vec)
    else:
        idx_rx, parts = _header_perfect(indices, dim, cfg)
    return idx_rx, transport_lib._batch_stats(c, *parts,
                                              device=indices.device)


def _header_keys(keys: torch.Tensor) -> torch.Tensor:
    with spans.span("keys"):
        return prng.fold_in(keys, HEADER_KEY_LANE)


def _indices(indices, values: torch.Tensor, caller: str) -> torch.Tensor:
    idx = torch.as_tensor(indices).to(device=values.device,
                                      dtype=torch.int64)
    if tuple(idx.shape) != tuple(values.shape):
        raise ValueError(
            f"{caller} wants matching values/indices; got "
            f"{tuple(values.shape)} vs {tuple(idx.shape)}")
    return idx


def _single_snr(snr_db, device):
    return (None if snr_db is None
            else channel_lib.snr_db_vector(snr_db, 1, device))


def transmit_header(indices, dim: int, key: torch.Tensor, cfg,
                    compression=None, *, snr_db=None, device=None):
    """Carry one client's ``(k,)`` index header over its protected leg on
    ``key`` (already the header key). ``cfg`` is the value leg's
    ``TransportConfig``: the header shares its constellation and channel.
    Returns ``(idx_rx, (symbols, extra_transmissions, bit_errors, n_bits,
    bits_on_air))``, float32 scalars."""
    dev = resolve_device(device)
    idx = torch.as_tensor(indices).to(device=dev, dtype=torch.int64)[None]
    idx_rx, st = _header_batch(idx, dim, key.reshape(1, 2), cfg,
                               _default_compression(compression),
                               _single_snr(snr_db, dev))
    row = transport_lib._row(st, 0)
    return idx_rx[0], (row.data_symbols, row.transmissions, row.bit_errors,
                       row.n_bits, row.bits_on_air)


def scatter_received(values: torch.Tensor, idx_rx: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """Receiver-side scatter of ``(..., k)`` values to ``(..., dim)``:
    out-of-range indices are dropped, in-range duplicates accumulate in
    update order."""
    valid = idx_rx < dim
    vals = torch.where(valid, values, torch.zeros_like(values))
    idx = torch.where(valid, idx_rx, torch.zeros_like(idx_rx))
    lead = values.shape[:-1]
    rows = torch.arange(vals[..., 0].numel(), dtype=torch.int64,
                        device=idx.device).reshape(lead + (1,))
    out = torch.zeros(lead + (dim,), dtype=vals.dtype, device=vals.device)
    out.view(-1).index_put_(((rows * dim + idx).reshape(-1),),
                            vals.reshape(-1), accumulate=True)
    return out


def sparse_batch_with_keys(values: torch.Tensor, indices: torch.Tensor,
                           dim: int, keys: torch.Tensor, cfg, snr_vec,
                           compression=None):
    """Sparse batch over explicit per-client transport keys ``(C, 2)``
    (the bucketed hook): the ``(C, k)`` value leg in one pass of the
    transport (one K1 launch on a ``use_kernel`` config), the header leg on
    the header lane, the received rows scattered to ``(C, dim)``.
    ``snr_vec`` is ``None`` or ``(C,)``. Stats sum the two legs."""
    compression = _default_compression(compression)
    v_hat, vs = transport_lib._batch_with_keys(values, keys, cfg, snr_vec)
    idx_rx, hs = _header_batch(indices, dim, _header_keys(keys), cfg,
                               compression, snr_vec)
    dense = scatter_received(v_hat, idx_rx, dim)
    return dense, transport_lib.TxStats(
        vs.data_symbols + hs.data_symbols, vs.transmissions + hs.transmissions,
        vs.bit_errors + hs.bit_errors, vs.n_bits + hs.n_bits,
        bits_on_air=vs.bits_on_air + hs.bits_on_air)


def transmit_sparse(values, indices, dim: int, key: torch.Tensor, cfg,
                    compression=None, *, snr_db=None, device=None):
    """One client's sparse uplink: ``(k,)`` values on ``key`` plus the index
    header on ``fold_in(key, HEADER_KEY_LANE)``; ``snr_db`` overrides the
    channel's SNR on both legs.

    Returns ``(x_hat (dim,), TxStats)``: the dense reconstruction and one
    set of stats whose ``data_symbols`` / ``bit_errors`` / ``n_bits`` /
    ``bits_on_air`` sum the two legs and whose ``transmissions`` counts one
    PHY frame plus any header retransmissions.
    """
    transport_lib._check_mode(cfg)
    v = transport_lib._payload(values, device, 1, "transmit_sparse")[None]
    idx = _indices(indices, v[0], "transmit_sparse")[None]
    dense, st = sparse_batch_with_keys(v, idx, dim, key.reshape(1, 2), cfg,
                                       _single_snr(snr_db, v.device),
                                       compression)
    return dense[0], transport_lib._row(st, 0)


def transmit_sparse_batch(values, indices, dim: int, key: torch.Tensor, cfg,
                          compression=None, *, snr_db=None,
                          client_offset: int = 0, device=None):
    """Batched sparse uplink: client ``i`` on ``fold_in(key, client_offset
    + i)`` (the dense schedule), so the batch equals a loop of
    :func:`transmit_sparse`. ``values`` and ``indices`` are ``(M, k)``.
    Returns ``(x_hat (M, dim), TxStats with (M,) fields)``."""
    transport_lib._check_mode(cfg)
    v = transport_lib._payload(values, device, 2, "transmit_sparse_batch")
    idx = _indices(indices, v, "transmit_sparse_batch")
    num_clients = v.shape[0]
    snr_vec = transport_lib._resolve_batch_snr(cfg, num_clients, snr_db,
                                               v.device)
    with spans.span("keys"):
        keys = transport_lib.client_keys(key, num_clients, client_offset)
    return sparse_batch_with_keys(v, idx, int(dim), keys, cfg, snr_vec,
                                  compression)


def _sparse_buckets(values, indices, dim, keys, cfgs, mode_np, snr_vec,
                    compression):
    """Each non-empty mode's clients as one sparse batch, unpadded, rows
    and stats back in client order."""
    if values.shape[0] == 0:
        return (values.new_zeros((0, dim)),
                transport_lib._empty_stats(values.device))
    order, buckets = transport_lib._buckets(mode_np, len(cfgs))
    parts_x, parts_st = [], []
    for m, count, idx in buckets:
        vb, kb, sb = transport_lib._gather_bucket(values, keys, snr_vec, idx,
                                                  count, count)
        ib = indices[torch.as_tensor(idx, device=indices.device)]
        xh, st = sparse_batch_with_keys(vb, ib, dim, kb, cfgs[m], sb,
                                        compression)
        parts_x.append(xh)
        parts_st.append(st)
    return transport_lib._scatter_bucket_parts(parts_x, parts_st, order)


def transmit_sparse_batch_adaptive(values, indices, dim: int,
                                   key: torch.Tensor, cfgs, mode_idx,
                                   compression=None, *, snr_db=None,
                                   client_offset: int = 0,
                                   dispatch: str = "auto", device=None):
    """Mixed-mode sparse uplink: client ``i``'s values ride
    ``cfgs[mode_idx[i]]``, one slot budget ``k`` for every mode.

    ``"bucketed"`` (= ``"auto"``) runs each non-empty mode once on its
    clients (one K1 launch per uncoded ``use_kernel`` bucket); ``"select"``
    gives the same rows and refuses ``use_kernel`` rows, as the
    reference's vmapped switch does. The key rides the client index, so
    both equal a per-client :func:`transmit_sparse` loop. Returns
    ``(x_hat (M, dim), TxStats)`` with ``stats.mode_idx`` set.
    """
    v, cfgs, mode_np, snr_vec, keys, _ = transport_lib._adaptive_prologue(
        values, key, cfgs, mode_idx, snr_db, client_offset, dispatch,
        "transmit_sparse_batch_adaptive", device)
    idx = _indices(indices, v, "transmit_sparse_batch_adaptive")
    dense, stats = _sparse_buckets(v, idx, int(dim), keys, cfgs, mode_np,
                                   snr_vec, _default_compression(compression))
    stats.mode_idx = torch.as_tensor(mode_np, device=v.device)
    return dense, stats
