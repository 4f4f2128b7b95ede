"""Composable gradient transport (port; the paper's Sec. IV uplink).

Counterpart of ``repro.core.transport``. Modes:

``perfect``  error-free delivery (genie).
``naive``    raw float bits through the fading channel, no prior.
``approx``   the paper's scheme: MSB-first packing + Gray-QAM unequal
             protection + symbol interleaving + the exponent clamp.
``ecrt``     rate-1/2 LDPC FEC + retransmission until every codeword
             decodes; ``simulate_fec=False`` swaps the real min-sum chain
             for the calibrated analytic model (exact bits, E[tx] from
             ``latency.calibrate_ecrt``).

``naive``/``approx`` run either on the fused CUDA kernels
(``use_kernel=True``: K0 for one client, K1 for a batch, K2 for the fused
aggregate) or on the layered PHY (``use_kernel=False``, the default): the
reference's ``float_codec -> modulation -> channel -> demod`` chain as
tensor operations, with the reference's ``threefry`` draws. Both run on
the payload's device. On CUDA the layered chain's channel stage (Gray
QAM, the draws, fading, noise and zero-forcing: :func:`_through_channel`)
is one launch of its own kernel, the eager chain's bits.

Mixed-mode batches (:func:`transmit_batch_adaptive`, the link-adaptation
hook) give client ``i`` the table row ``cfgs[mode_idx[i]]``. The
``bucketed`` dispatch stable-sorts clients by mode, gathers each mode's
rows into one bucket padded to a quarter-octave capacity
(:func:`_bucket_capacity`; pad rows are zeros with row 0's key and SNR,
masked by ``num_active`` on the kernel path and discarded otherwise), runs
each bucket once (one K1 or K2 launch per uncoded bucket on
``use_kernel`` rows), and scatters the rows back to client order. The
reference's ``select`` dispatch vmaps a ``lax.switch`` over the table, so
every client pays every mode; here a batch row does not depend on the
rest of its batch, so ``select`` runs each mode on exactly its own
clients, unpadded, and gives the same bits. Like the reference it
refuses ``use_kernel`` rows (:func:`clear_kernel_rows` clears them).

The downlink broadcast (:func:`transmit_broadcast`, the FL round's
noisy downlink leg) tiles one flat payload into a dense ``(M, N)`` batch
on the payload's device and runs it through the same engine, client
``i`` on ``fold_in(key, DOWNLINK_KEY_LANE + i)``; the mixed-mode
broadcast (:func:`transmit_broadcast_adaptive`) runs the adaptive
dispatch with ``client_offset=DOWNLINK_KEY_LANE``.

The key schedule is the reference's: client ``i`` of a batch draws
``fold_in(key, client_offset + i)`` (:func:`client_keys`). On the kernel
path each client's kernel seed is ``randint(key_i, (), 0, int32 max)``; on
the layered path each client's fading and noise come from ``key_i`` as
``channel.transmit`` draws them, so the port's channel realizations are
the reference's, draw for draw. The reference's batch path is a vmap of
:func:`transmit_flat`; here every path is written over a batch of keys,
and :func:`transmit_flat` is the batch of one, so a batch row equals the
single-client call bit for bit.

Pytrees are dicts and lists of tensors, nested. They flatten in
``jax.tree_util.tree_flatten`` order — dict keys sorted, list items in
order — so every float lands in the same tile and symbol slot, and so
gets the same draws, as in the reference. Parameters keep the reference's
layout (FC weights are ``(in, out)``). :func:`pack` casts a tree's
leaves into one float32 row, padded once: to whole tiles where the
front-end's one config runs a kernel, which takes it as it is, else not
at all (a mixed-mode table's kernel bucket is padded where it is
gathered). :func:`unpack` returns per-leaf views of the received row.
:func:`_kernel_path` alone turns a config and keys into kernel arguments.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import channel as channel_lib
from repro_torch.core import ecrt as ecrt_lib
from repro_torch.core import float_codec as fc
from repro_torch.core import keylanes
from repro_torch.core import modulation as mod_lib
from repro_torch.core import prng
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import phy_channel as phy_kernel
from repro_torch.obs import spans

__all__ = [
    "TransportConfig",
    "TxStats",
    "client_keys",
    "transmit_flat",
    "transmit_pytree",
    "transmit_batch",
    "transmit_pytree_batch",
    "transmit_batch_aggregate",
    "transmit_pytree_batch_aggregate",
    "clear_kernel_rows",
    "transmit_batch_adaptive",
    "transmit_pytree_batch_adaptive",
    "transmit_batch_adaptive_aggregate",
    "transmit_pytree_batch_adaptive_aggregate",
    "DOWNLINK_KEY_LANE",
    "transmit_broadcast",
    "transmit_broadcast_adaptive",
    "transmit_pytree_broadcast",
    "transmit_pytree_broadcast_adaptive",
    "transmit_sparse",
    "transmit_sparse_batch",
]

_MODES = ("perfect", "naive", "approx", "ecrt")

# Client i of a broadcast draws fold_in(key, DOWNLINK_KEY_LANE + i): the
# round's uplink key serves both legs, on disjoint lanes.
DOWNLINK_KEY_LANE = keylanes.DOWNLINK_KEY_LANE


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """One uplink transport: wire mode, modulation, channel, and FEC knobs.

    The reference's fields at its defaults. The kernel path ignores
    ``interleave`` and ``chunk_elems`` (its interleave is fixed, per tile),
    as the reference does.
    """

    mode: str = "approx"  # perfect | naive | approx | ecrt
    modulation: str = "qpsk"
    channel: channel_lib.ChannelConfig = dataclasses.field(
        default_factory=channel_lib.ChannelConfig)
    interleave: bool = True
    clamp_bound: float = 2.0  # paper: |g| < 2 -> clear bit 30 only
    wire_dtype: str = "float32"  # "float32" (paper) or "bfloat16"
    # Process the layered payload in chunks of this many floats (0 = whole
    # payload); chunk i of a client draws from fold_in(client key, i).
    chunk_elems: int = 0
    ldpc: ecrt_lib.LdpcCode = dataclasses.field(
        default_factory=ecrt_lib.LdpcCode)
    max_tx: int = 8  # ECRT retransmission cap
    simulate_fec: bool = True
    ecrt_expected_tx: float = 1.0  # analytic model (calibrated; see latency)
    use_kernel: bool = False  # route naive/approx through the CUDA kernels

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
    for a batch. ``mode_idx`` is ``None`` for single-mode calls, or the
    ``(num_clients,)`` int32 table index each client of
    :func:`transmit_batch_adaptive` used (after clamping), so
    ``latency.round_airtime_adaptive`` prices each client under its mode.
    """

    data_symbols: torch.Tensor
    transmissions: torch.Tensor
    bit_errors: torch.Tensor
    n_bits: torch.Tensor
    mode_idx: Any = None
    bits_on_air: Any = None

    @property
    def ber(self) -> torch.Tensor:
        """End-to-end payload bit-error rate (``bit_errors / n_bits``)."""
        return self.bit_errors / torch.clamp_min(self.n_bits, 1.0)

    def round_summary(self) -> dict:
        """Cohort aggregates as Python floats: the ``uplink_*`` fields of
        ``repro_torch.obs.records.RoundRecord``. Copies the per-client
        fields to the host and reduces them in float64 with numpy, as the
        reference; ``uplink_ber`` is the pooled BER (total errors over
        total offered bits). The engine calls it only with a ledger
        attached."""
        def f64(t):
            return t.detach().cpu().numpy().astype(np.float64)

        bits, errors = f64(self.n_bits), f64(self.bit_errors)
        out = {
            "uplink_symbols": float(f64(self.data_symbols).sum()),
            "uplink_bits": float(bits.sum()),
            "uplink_bit_errors": float(errors.sum()),
            "uplink_ber": float(errors.sum() / max(bits.sum(), 1.0)),
            "uplink_mean_tx": float(np.mean(f64(self.transmissions))),
        }
        if self.bits_on_air is not None:
            out["uplink_bits_on_air"] = float(f64(self.bits_on_air).sum())
        return out

    def client_metrics(self) -> dict:
        """Per-client tensors for the sketches, on the stats' device and
        without a host copy, keyed by ``repro_torch.obs.metrics`` metric
        names."""
        out = {"ber": self.ber, "transmissions": self.transmissions,
               "n_bits": self.n_bits}
        if self.bits_on_air is not None:
            out["bits_on_air"] = self.bits_on_air
        return out


def _f32(v, device) -> torch.Tensor:
    """``v`` as a float32 tensor on ``device``. A Python number is filled
    there: made on the host and copied, it would block the host until the
    device's queue drains."""
    if isinstance(v, (int, float)):
        return torch.full((), v, dtype=torch.float32, device=device)
    return torch.as_tensor(v, device=device).to(torch.float32)


def _stats(data_symbols, transmissions, bit_errors, n_bits, bits_on_air=None,
           *, device=None) -> TxStats:
    f = functools.partial(_f32, device=device)
    return TxStats(f(data_symbols), f(transmissions), f(bit_errors), f(n_bits),
                   bits_on_air=None if bits_on_air is None else f(bits_on_air))


def _check_mode(cfg: TransportConfig) -> None:
    """Raise ``ValueError`` for a mode the transport does not know."""
    if cfg.mode not in _MODES:
        raise ValueError(f"unknown transport mode {cfg.mode!r}")


def _payload(x, device, ndim: int, name: str) -> torch.Tensor:
    x = torch.as_tensor(x).to(device=resolve_device(device),
                              dtype=torch.float32)
    if x.ndim != ndim:
        raise ValueError(f"{name} wants a {ndim}-D payload; got "
                         f"{tuple(x.shape)}")
    return x


def _through_channel(sym_stream: torch.Tensor, keys: torch.Tensor,
                     cfg: TransportConfig, snr_vec=None, *, gain=False):
    """Symbol indices ``(C, S)`` -> Gray QAM -> channel -> zero-forcing
    equalization: ``(y, c)``, complex64 ``(C, S)``. On the CPU the eager
    chain; on CUDA one launch of the channel-stage kernel
    (:func:`~repro_torch.kernels.phy_channel.channel_stage`, the same
    bits). On both devices ``c`` is returned only where ``gain`` asks for
    it, else ``None``."""
    if sym_stream.device.type == "cuda":
        ch, dev = cfg.channel, sym_stream.device
        npow = (ch.noise_power if snr_vec is None
                else channel_lib.noise_power_for(ch, snr_vec, dev))
        return phy_kernel.channel_stage(
            sym_stream.to(torch.int64).contiguous(),
            keys.to(dev).contiguous(), npow, ch.large_scale_gain,
            bits_per_symbol=cfg.scheme.bits_per_symbol, fading=ch.fading,
            block_len=ch.block_len, gain=gain)
    tx = mod_lib.modulate(sym_stream, cfg.scheme)
    r, c = channel_lib.transmit(tx, keys, cfg.channel, snr_db=snr_vec)
    return channel_lib.equalize(r, c), (c if gain else None)


def _wire_bits(cfg: TransportConfig) -> int:
    return 16 if cfg.wire_dtype == "bfloat16" else 32


def _equalized_stream(x: torch.Tensor, keys: torch.Tensor,
                      cfg: TransportConfig, snr_vec):
    """The uncoded pipeline up to the demod: ``(words (C, N), y (C, N*S))``
    with the stream interleaved or not as ``cfg.interleave`` says."""
    k, wb = cfg.scheme.bits_per_symbol, _wire_bits(cfg)
    with spans.span("codec", device=True):
        u = fc.bf16_to_bits(x) if wb == 16 else fc.f32_to_bits(x)
        sym = fc.words_to_symbols(u, k, wb)  # (C, N, S)
        stream = (fc.interleave(sym) if cfg.interleave
                  else sym.reshape(sym.shape[0], -1))
    with spans.span("channel", device=True):
        y, _ = _through_channel(stream, keys, cfg, snr_vec)
    return u, y


def _per_word(stream: torch.Tensor, n: int, cfg: TransportConfig):
    """A received symbol stream ``(C, N*S)`` back to ``(C, N, S)``."""
    s_per_word = _wire_bits(cfg) // cfg.scheme.bits_per_symbol
    if cfg.interleave:
        return fc.deinterleave(stream, n, s_per_word)
    return stream.reshape(stream.shape[0], n, s_per_word)


def _uncoded(x: torch.Tensor, keys: torch.Tensor, cfg: TransportConfig,
             clamp: bool, snr_vec=None):
    """naive/approx on the layered PHY for ``(C, N)`` payloads and keys
    ``(C, 2)``: bits -> QAM -> channel -> bits, per-client stats."""
    k, wb = cfg.scheme.bits_per_symbol, _wire_bits(cfg)
    c, n = x.shape
    u, y = _equalized_stream(x, keys, cfg, snr_vec)
    with spans.span("demod", device=True):
        rx = _per_word(mod_lib.demod_hard(y, cfg.scheme), n, cfg)
    del y
    with spans.span("codec", device=True):
        u_hat = fc.symbols_to_words(rx, k, wb)
        if clamp:
            u_hat = (fc.clamp_exponent_bits16(u_hat, cfg.clamp_bound)
                     if wb == 16
                     else fc.clamp_exponent_bits(u_hat, cfg.clamp_bound))
        # Post-clamp discrepancies against the true words: the clamp only
        # lowers the count, since the true exponent MSB is 0.
        bit_errors = mod_lib.popcount(u ^ u_hat).sum(dim=-1)
        out = (fc.bits_to_bf16(u_hat).to(torch.float32) if wb == 16
               else fc.bits_to_f32(u_hat))
    return out, _batch_stats(c, n * (wb // k), 1, bit_errors, n * wb,
                             n * wb, device=x.device)


def _word_margins(x: torch.Tensor, keys: torch.Tensor, cfg: TransportConfig,
                  snr_vec=None) -> torch.Tensor:
    """Per-word decision margin ``(C, N)`` of the layered uplink: the least
    :func:`~repro_torch.core.modulation.decision_margin` over the word's
    symbols. A received word may differ from another implementation's only
    where this is within that implementation's rounding of 0."""
    c, n = x.shape
    if cfg.chunk_elems and n > cfg.chunk_elems:
        xc, kc, sc, _ = _chunk_view(x, keys, cfg.chunk_elems, snr_vec)
        return _word_margins(xc, kc, dataclasses.replace(cfg, chunk_elems=0),
                             sc).reshape(c, -1)[:, :n]
    _, y = _equalized_stream(x, keys, cfg, snr_vec)
    m = _per_word(mod_lib.decision_margin(y, cfg.scheme), n, cfg)
    return m.amin(dim=-1)


def _chunk_view(x: torch.Tensor, keys: torch.Tensor, chunk: int, snr_vec):
    """``(C, N)`` payloads as ``(C * n_chunks, chunk)`` rows (zero-padded),
    with chunk ``i`` of client ``c`` keyed ``fold_in(keys[c], i)``."""
    c, n = x.shape
    xp = torch.nn.functional.pad(x, (0, (-n) % chunk))
    n_chunks = xp.shape[1] // chunk
    # chunk indices ride the client-space chunk lane of the client key
    keylanes.check_range(0, n_chunks, space="client")
    idx = torch.arange(n_chunks, dtype=torch.int64, device=keys.device)
    kc = prng.fold_in(keys[:, None, :], idx).reshape(-1, 2)
    sc = None if snr_vec is None else snr_vec.repeat_interleave(n_chunks)
    return xp.reshape(-1, chunk), kc, sc, n_chunks


def _uncoded_chunked(x: torch.Tensor, keys: torch.Tensor,
                     cfg: TransportConfig, clamp: bool, snr_vec=None):
    """:func:`_uncoded` over fixed-size chunks of each payload (bounds the
    live set); stats cover the true payload only."""
    c, n = x.shape
    xc, kc, sc, n_chunks = _chunk_view(x, keys, cfg.chunk_elems, snr_vec)
    x_hat, st = _uncoded(xc, kc, cfg, clamp, sc)
    x_hat = x_hat.reshape(c, -1)
    # The transmitted pad words are exactly 0, so every set bit in a
    # received pad word was counted as an error: subtract them.
    wb, k = _wire_bits(cfg), cfg.scheme.bits_per_symbol
    pad = x_hat[:, n:]
    pad_bits = (fc.bf16_to_bits(pad) if wb == 16 else fc.f32_to_bits(pad))
    pad_errs = mod_lib.popcount(pad_bits).sum(dim=-1)
    chunk_errs = st.bit_errors.reshape(c, n_chunks).sum(dim=-1)
    return x_hat[:, :n], _batch_stats(
        c, n * (wb // k), 1, chunk_errs - pad_errs, n * wb, n * wb,
        device=x.device)


def _ecrt_real(x: torch.Tensor, keys: torch.Tensor, cfg: TransportConfig,
               snr_vec=None):
    """Real LDPC + retransmission for ``(C, N)`` payloads: up to ``max_tx``
    transmissions, transmission ``t`` of client ``c`` drawn from
    ``split(keys[c], max_tx)[t]``; a codeword is taken from the first
    transmission that decodes, and codewords still failing after
    ``max_tx`` fall back to the genie (counted)."""
    code = cfg.ldpc
    c, n_words = x.shape
    dev = x.device
    u = fc.f32_to_bits(x)
    shifts = 31 - torch.arange(32, dtype=torch.int64, device=dev)
    bits = ((u[..., None] >> shifts) & 1).reshape(c, -1)
    n_bits = bits.shape[1]
    bits_p = torch.nn.functional.pad(bits, (0, (-n_bits) % code.k))
    cw = ecrt_lib.encode(bits_p.reshape(c, -1, code.k), code)  # (C, n_cw, n)
    n_cw, n_code = cw.shape[1], cw.shape[2]
    k_mod = cfg.scheme.bits_per_symbol
    if n_code % k_mod:
        raise ValueError(f"codeword length {n_code} is not a multiple of "
                         f"bits_per_symbol={k_mod}")
    sym_per_cw = n_code // k_mod
    weights = 1 << (k_mod - 1 - torch.arange(k_mod, device=dev))
    sym = (cw.reshape(c, n_cw, sym_per_cw, k_mod) * weights).sum(-1)
    sym = sym.reshape(c, -1)
    tx_keys = prng.split_batched(keys, cfg.max_tx)  # max_tx keys (C, 2)
    decoded = torch.zeros_like(cw)
    ok = torch.zeros((c, n_cw), dtype=torch.bool, device=dev)
    tx_count = torch.zeros((c, n_cw), dtype=torch.int64, device=dev)
    for t in range(cfg.max_tx):
        if bool(ok.all()):
            break  # the reference's later rounds change nothing from here
        y, cc = _through_channel(sym, tx_keys[t], cfg, snr_vec, gain=True)
        nv = channel_lib.noise_var_post_eq(cc, cfg.channel, snr_db=snr_vec)
        llr = mod_lib.bit_llrs(y, nv, cfg.scheme).reshape(c, n_cw, n_code)
        pend = ~ok
        hard, ok_pend = ecrt_lib.decode(llr[pend], code)
        take = torch.zeros_like(ok)
        take[pend] = ok_pend
        decoded[take] = hard[ok_pend]
        tx_count += pend
        ok |= take
    decoded = torch.where(ok[..., None], decoded, cw)  # genie fallback
    info = decoded[..., :code.k].reshape(c, -1)[:, :n_bits]
    u_hat = (info.reshape(c, n_words, 32) << shifts).sum(-1)
    bit_errors = mod_lib.popcount(u ^ u_hat).sum(-1)
    total_tx = tx_count.sum(-1)
    # XLA turns the reference's mean over a constant count into a multiply
    # by its float32 reciprocal: so does this.
    mean_tx = total_tx.to(torch.float32) * (1.0 / n_cw)
    return fc.bits_to_f32(u_hat), _batch_stats(
        c, total_tx * sym_per_cw, mean_tx, bit_errors, n_words * 32,
        total_tx * sym_per_cw * k_mod, device=dev)


def _ecrt_analytic(x: torch.Tensor, cfg: TransportConfig):
    """Calibrated ECRT model: exact bits, ``cfg.ecrt_expected_tx``
    transmissions. SNR-blind by construction (one constant calibrated for
    one link quality); the engine rescales per-client airtime instead."""
    c, n_words = x.shape
    n_bits = n_words * 32
    coded_bits = 2 * n_bits  # rate 1/2
    sym = coded_bits / cfg.scheme.bits_per_symbol * cfg.ecrt_expected_tx
    return x, _batch_stats(c, sym, cfg.ecrt_expected_tx, 0, n_bits,
                           coded_bits * cfg.ecrt_expected_tx, device=x.device)


def _batch_stats(c: int, data_symbols, transmissions, bit_errors, n_bits,
                 bits_on_air, *, device) -> TxStats:
    """:class:`TxStats` with ``(c,)`` float32 fields from scalars or
    per-client tensors."""
    def f(v):
        t = _f32(v, device)
        return t.expand(c) if t.ndim == 0 else t

    return TxStats(f(data_symbols), f(transmissions), f(bit_errors),
                   f(n_bits), bits_on_air=f(bits_on_air))


def _row(stats: TxStats, i: int) -> TxStats:
    """Client ``i``'s scalar stats of a batch."""
    return TxStats(stats.data_symbols[i], stats.transmissions[i],
                   stats.bit_errors[i], stats.n_bits[i],
                   bits_on_air=stats.bits_on_air[i])


def _runs_kernel(cfg: TransportConfig) -> bool:
    """True where ``cfg`` runs on the CUDA kernels (K0, K1 or K2)."""
    return cfg.mode in ("naive", "approx") and cfg.use_kernel


def _pad_to(cfg: TransportConfig) -> int:
    """The pad granule of a single-config front-end's packed row: whole
    tiles where the config runs a kernel, none elsewhere."""
    return kernel_ops.BLOCK_WORDS if _runs_kernel(cfg) else 1


def _transport_kernel_params(cfg: TransportConfig):
    """(wire_bits, clamp_mask, bits_per_symbol) for a TransportConfig."""
    wb = _wire_bits(cfg)
    if cfg.mode != "approx":
        clamp_mask = 0xFFFFFFFF
    elif wb == 16:
        clamp_mask = fc.exponent_clamp_mask16(cfg.clamp_bound)
    else:
        clamp_mask = fc.exponent_clamp_mask(cfg.clamp_bound)
    return wb, clamp_mask, cfg.scheme.bits_per_symbol


def _link_params(cfg: TransportConfig, c: int, snr_db, device):
    """Per-client noise powers and gains ``(C,)`` float32, made on
    ``device`` (no host copy)."""
    ch = cfg.channel
    if snr_db is None:
        npow = torch.full((c,), ch.noise_power, dtype=torch.float32,
                          device=device)
    else:
        npow = channel_lib.noise_power_for(ch, snr_db, device).contiguous()
    gains = torch.full((c,), ch.large_scale_gain, dtype=torch.float32,
                       device=device)
    return npow, gains


def _kernel_path(x: torch.Tensor, n, keys: torch.Tensor,
                 cfg: TransportConfig, snr_vec, weights=None, *,
                 num_active=None):
    """The kernel path's one prologue: K0 for one row ``x (D,)`` and its
    key ``(2,)``, K1 for rows ``(C, D)`` and keys ``(C, 2)``, K2 with
    ``weights``. The first ``n`` words of a row (``None``: all) are the
    payload; a packed row of whole tiles goes to the kernel as it is, any
    other is padded first. Seeds are ``randint(key_i, (), 0, int32
    max)``; noise powers and gains are made on the device. Returns
    ``(x_hat (..., n) float32, or agg (n,) with weights, TxStats)``,
    scalar stats for K0."""
    dev, n = x.device, x.shape[-1] if n is None else n
    c = 1 if x.ndim == 1 else x.shape[0]
    with spans.span("keys"):
        seeds = kernel_ops._seed_from_key(keys).to(dev).reshape(c)
    wb, clamp_mask, k = _transport_kernel_params(cfg)
    npow, gains = _link_params(cfg, c, snr_vec, dev)
    if weights is not None:
        weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    out, errs = kernel_ops.on_tiles(
        kernel_ops._tiled(x, wb, kernel_ops.BLOCK_WORDS), n, seeds, npow,
        gains, weights, bits_per_symbol=k, fading=cfg.channel.fading,
        fade_block=cfg.channel.block_len, clamp_mask=clamp_mask,
        word_bits=wb, num_active=num_active)
    counts = (n * (wb // k), 1, errs, n * wb, n * wb)
    stats = (_stats(*counts, device=dev) if x.ndim == 1
             else _batch_stats(c, *counts, device=dev))
    return out.to(torch.float32), stats


def pack(leaves, lead: int = 0, pad_to: int = 1):
    """The wire row of ``leaves``: one float32 buffer ``L + (D_pad,)``,
    ``L`` the first ``lead`` axes every leaf shares (a client axis, or
    none).

    Each leaf is read as ``L + (-1,)`` and cast to float32 on its way into
    the buffer, in order; the ``D_pad - D`` tail, up to the next multiple
    of ``pad_to``, is zeros. Two launches: the concatenation, written
    straight into the buffer, and the tail's fill. Returns ``(buf, D)``.
    """
    lead = tuple(leaves[0].shape[:lead])
    parts = [torch.as_tensor(l).reshape(lead + (-1,)) for l in leaves]
    d = sum(p.shape[-1] for p in parts)
    buf = torch.empty(lead + (d + (-d) % pad_to,), dtype=torch.float32,
                      device=parts[0].device)
    torch.cat(parts, dim=-1, out=buf[..., :d])
    if buf.shape[-1] > d:
        buf[..., d:].zero_()
    return buf, d


def unpack(row: torch.Tensor, like, lead: int = 0, *, cast: bool = True):
    """Per-leaf views of a received row ``(..., >= D)``: leaf ``i`` of
    ``like`` (packed with :func:`pack` under ``lead``) takes its run of
    words, shaped ``row.shape[:-1] + like[i].shape[lead:]``. So a
    ``(C, D)`` batch keeps the client axis, an aggregate ``(D,)`` drops
    it, and ``(M, D)`` broadcast copies add one. A leaf whose dtype is not
    float32 is cast back to it unless ``cast`` is false (an aggregate
    stays float32: it feeds the float32 update)."""
    out, off = [], 0
    for leaf in like:
        shape = tuple(leaf.shape[lead:])
        size = math.prod(shape)
        part = row[..., off:off + size].reshape(row.shape[:-1] + shape)
        out.append(part.to(leaf.dtype) if cast else part)
        off += size
    return out


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
    x = _payload(x, device, 1, "transmit_flat")
    return _transmit_row(x, x.shape[0], key, cfg, snr_db)


def _transmit_row(x: torch.Tensor, n: int, key: torch.Tensor,
                  cfg: TransportConfig, snr_db=None):
    """:func:`transmit_flat` on a row ``x`` whose first ``n`` words are the
    payload and the rest zeros (a packed row; wider only on K0's path)."""
    _check_mode(cfg)
    wb, k = _wire_bits(cfg), cfg.scheme.bits_per_symbol
    if cfg.mode == "perfect":
        return x, _stats(n * wb // k, 1, 0, n * wb, n * wb, device=x.device)
    snr_vec = (None if snr_db is None
               else channel_lib.snr_db_vector(snr_db, 1, x.device))
    if _runs_kernel(cfg):
        return _kernel_path(x, n, key, cfg, snr_vec)
    x_hat, stats = _batch_with_keys(x[None], key.reshape(1, 2), cfg, snr_vec)
    return x_hat[0], _row(stats, 0)


def transmit_pytree(tree, key: torch.Tensor, cfg: TransportConfig, *,
                    device=None):
    """Transmit every leaf of a (nested) dict of tensors as one flat uplink
    payload, leaves in sorted-key order; returns ``(tree_hat, stats)`` with
    shapes and dtypes restored."""
    leaves, spec = tree_flatten(tree)
    with spans.span("flatten", device=True):
        row, n = pack(leaves, 0, _pad_to(cfg))
    row_hat, stats = _transmit_row(_payload(row, device, 1, "transmit_pytree"),
                                   n, key, cfg)
    with spans.span("unflatten", device=True):
        out = unpack(row_hat, leaves)
    return tree_unflatten(spec, out), stats


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
                     cfg: TransportConfig, snr_vec, *, n=None,
                     num_active=None):
    """Single-mode batch over explicit per-client keys ``(C, 2)``, in the
    reference's dispatch order: perfect, the kernel path, the chunked and
    whole layered PHY, ECRT real or analytic. ``n`` is the payload's
    length where the kernel path gets rows packed wider; ``num_active``
    masks the tail rows of a padded bucket on the kernel path (no PHY
    work, zeros); the other paths compute them and the caller discards
    them."""
    c = x.shape[0]
    n = x.shape[1] if n is None else n
    if cfg.mode == "perfect":
        wb, k = _wire_bits(cfg), cfg.scheme.bits_per_symbol
        return x, _batch_stats(c, n * wb // k, 1, 0, n * wb, n * wb,
                               device=x.device)
    if _runs_kernel(cfg):
        return _kernel_path(x, n, keys, cfg, snr_vec, num_active=num_active)
    keys = keys.to(x.device)  # every draw of these paths is per symbol
    if cfg.mode in ("naive", "approx"):
        clamp = cfg.mode == "approx"
        if cfg.chunk_elems and n > cfg.chunk_elems:
            return _uncoded_chunked(x, keys, cfg, clamp, snr_vec)
        return _uncoded(x, keys, cfg, clamp, snr_vec)
    if cfg.simulate_fec:
        return _ecrt_real(x, keys, cfg, snr_vec)
    return _ecrt_analytic(x, cfg)


def transmit_batch(x, key: torch.Tensor, cfg: TransportConfig, *,
                   snr_db=None, client_offset: int = 0, device=None):
    """Transmit ``num_clients`` payloads through independent fading uplinks.

    One K1 launch on the kernel path; one batched pass of the layered PHY
    (or the ECRT chain) otherwise. Client ``i`` uses
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
    x, snr_vec, keys = _batch_prologue(x, key, cfg, snr_db, client_offset,
                                       device, "transmit_batch")
    return _batch_with_keys(x, keys, cfg, snr_vec)


def _batch_prologue(x, key, cfg, snr_db, client_offset, device, caller):
    """Shared head of the single-mode batch front-ends: the mode check,
    the payload on its device, the SNR column and the key schedule."""
    _check_mode(cfg)
    x = _payload(x, device, 2, caller)
    snr_vec = _resolve_batch_snr(cfg, x.shape[0], snr_db, x.device)
    with spans.span("keys"):
        keys = client_keys(key, x.shape[0], client_offset)
    return x, snr_vec, keys


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


def _batch_aggregate_with_keys(x, keys, cfg, snr_vec, weights, *, n=None,
                               num_active=None):
    """Single-mode batch + weighted aggregation over explicit keys: K2 on
    the kernel path, the client-order sum over the batch otherwise. Rows
    at or beyond ``num_active`` add nothing."""
    if _runs_kernel(cfg):
        return _kernel_path(x, n, keys, cfg, snr_vec, weights,
                            num_active=num_active)
    x_hat, stats = _batch_with_keys(x, keys, cfg, snr_vec)
    return _scan_weighted_sum(x_hat, weights, num_active), stats


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
    x, snr_vec, keys = _batch_prologue(x, key, cfg, snr_db, client_offset,
                                       device, "transmit_batch_aggregate")
    return _batch_aggregate_with_keys(x, keys, cfg, snr_vec, weights)


def _same_channel(a: channel_lib.ChannelConfig,
                  b: channel_lib.ChannelConfig) -> bool:
    """ChannelConfig equality that tolerates array-valued ``snr_db``: a
    scalar, a 0-d array and a length-1 sequence all mean one SNR, and a
    size-1 value equals any vector it would broadcast to."""
    if a is b:
        return True
    if dataclasses.replace(a, snr_db=0.0) != dataclasses.replace(b, snr_db=0.0):
        return False
    sa = np.asarray(a.snr_db, np.float32).reshape(-1)
    sb = np.asarray(b.snr_db, np.float32).reshape(-1)
    if sa.size != sb.size and sa.size != 1 and sb.size != 1:
        return False
    if sa.size == 0 or sb.size == 0:
        return sa.size == sb.size
    return bool(np.all(sa == sb))


def clear_kernel_rows(cfgs):
    """A mode table with every ``use_kernel`` flag cleared: the one rule
    behind every select-dispatch consumer. The layered rows draw their own,
    equally valid, channel realization, so the kernel flag is never
    dropped silently."""
    return tuple(
        dataclasses.replace(c, use_kernel=False) if c.use_kernel else c
        for c in cfgs
    )


def _bucket_capacity(count: int) -> int:
    """Bucket capacity for ``count`` clients: the next multiple of
    ``2^(floor(log2 count) - 2)`` (counts <= 4 exact), so at most four
    capacities per octave and at most 25% masked padding."""
    if count <= 4:
        return max(count, 1)
    granule = 1 << (count.bit_length() - 3)
    return -(-count // granule) * granule


def _gather_bucket(x, keys, snr_vec, idx, count, cap):
    """One mode bucket's rows, padded to ``cap``: payload pads with zero
    rows, keys and SNR with row 0's (the pad rows' outputs are masked or
    discarded). ``idx`` is a numpy index vector; keys stay on their
    device (the host), payload and SNR on theirs."""
    xb = x[torch.as_tensor(idx, device=x.device)]
    kb = keys[torch.as_tensor(idx, device=keys.device)]
    sb = (None if snr_vec is None
          else snr_vec[torch.as_tensor(idx, device=snr_vec.device)])
    if cap > count:
        pad = cap - count
        xb = torch.cat([xb, xb.new_zeros((pad, xb.shape[1]))])
        kb = torch.cat([kb, kb[:1].expand(pad, -1)])
        if sb is not None:
            sb = torch.cat([sb, sb[:1].expand(pad)])
    return xb, kb, sb


def _slice_stats(st: TxStats, count: int) -> TxStats:
    """Drop a padded bucket's tail rows from every stat field."""
    return TxStats(st.data_symbols[:count], st.transmissions[:count],
                   st.bit_errors[:count], st.n_bits[:count],
                   bits_on_air=st.bits_on_air[:count])


_STAT_FIELDS = ("data_symbols", "transmissions", "bit_errors", "n_bits",
                "bits_on_air")


def _inverse(order) -> np.ndarray:
    """The inverse of the stable permutation ``order`` (sorted position ->
    client becomes client -> sorted position)."""
    inv = np.empty(len(order), np.int64)
    inv[order] = np.arange(len(order))
    return inv


def _scatter_stats(parts_st, inv):
    """Per-bucket stats (in sorted order) back to client order through
    ``inv``; ``mode_idx`` is left to the caller."""
    inv = torch.as_tensor(inv, device=parts_st[0].data_symbols.device)
    return TxStats(**{f: torch.cat([getattr(st, f) for st in parts_st])[inv]
                      for f in _STAT_FIELDS})


def _scatter_bucket_parts(parts_x, parts_st, order):
    """Per-bucket payload rows and stats back to client order:
    ``(x_hat, stats)``."""
    inv = _inverse(order)
    x_cat = torch.cat(parts_x)
    return (x_cat[torch.as_tensor(inv, device=x_cat.device)],
            _scatter_stats(parts_st, inv))


def _buckets(mode_np, n_modes):
    """``(order, [(mode, count, client indices)] of the non-empty modes,
    in increasing mode index)`` for a concrete mode vector."""
    order = np.argsort(mode_np, kind="stable")
    counts = np.bincount(mode_np, minlength=n_modes)
    starts = np.concatenate([[0], np.cumsum(counts)])
    return order, [(m, int(counts[m]), order[starts[m]:starts[m + 1]])
                   for m in range(n_modes) if counts[m]]


def _empty_stats(device) -> TxStats:
    empty = torch.zeros((0,), dtype=torch.float32, device=device)
    return TxStats(empty, empty, empty, empty, bits_on_air=empty)


def _bucketed_adaptive(x, keys, cfgs, mode_np, snr_vec, *, padded=True):
    """Sort/gather/scatter mixed-mode dispatch: each non-empty mode runs
    once on its bucket (padded to :func:`_bucket_capacity`, tail masked
    with ``num_active``), rows and stats scatter back to client order.
    ``padded=False`` runs each bucket at exactly its count (the select
    dispatch); a row's result is the same either way."""
    num_clients = x.shape[0]
    if num_clients == 0:
        return x, _empty_stats(x.device)
    order, buckets = _buckets(mode_np, len(cfgs))
    parts_x, parts_st = [], []
    for m, count, idx in buckets:
        cap = _bucket_capacity(count) if padded else count
        xb, kb, sb = _gather_bucket(x, keys, snr_vec, idx, count, cap)
        xh, st = _batch_with_keys(xb, kb, cfgs[m], sb, num_active=count)
        parts_x.append(xh[:count])
        parts_st.append(_slice_stats(st, count))
    return _scatter_bucket_parts(parts_x, parts_st, order)


def _bucketed_adaptive_aggregate(x, keys, cfgs, mode_np, snr_vec, weights):
    """Bucketed dispatch with per-bucket fused aggregation: each bucket
    reduces to one weighted partial (K2 on ``use_kernel`` rows, the
    client-order sum otherwise; pad rows masked by ``num_active``), and
    the partials add as ``total + partial`` in increasing mode index, the
    reference's summation order. Weights are normalized globally by the
    caller, before the split."""
    num_clients, n_payload = x.shape
    if num_clients == 0:
        return x.new_zeros((n_payload,)), _empty_stats(x.device)
    w = torch.as_tensor(weights, dtype=torch.float32).to(x.device)
    order, buckets = _buckets(mode_np, len(cfgs))
    total, parts_st = None, []
    for m, count, idx in buckets:
        cap = _bucket_capacity(count)
        xb, kb, sb = _gather_bucket(x, keys, snr_vec, idx, count, cap)
        wb = w[torch.as_tensor(idx, device=w.device)]
        if cap > count:
            wb = torch.cat([wb, wb.new_zeros((cap - count,))])
        agg, st = _batch_aggregate_with_keys(xb, kb, cfgs[m], sb, wb,
                                             num_active=count)
        total = agg if total is None else total + agg
        parts_st.append(_slice_stats(st, count))
    return total, _scatter_stats(parts_st, _inverse(order))


def _adaptive_prologue(x, key, cfgs, mode_idx, snr_db, client_offset,
                       dispatch, caller, device):
    """Shared head of the adaptive dispatches: validates the payload and
    the shared-channel invariant, gives every row ``cfgs[0]``'s channel,
    resolves the dispatch (``"auto"`` is ``"bucketed"``: the mode vector
    is always concrete here), clamps the mode vector once (the dispatch
    and ``stats.mode_idx`` agree on the mode used) and builds the key
    schedule. Returns ``(x, cfgs, mode_np, snr_vec, keys, dispatch)``."""
    x = _payload(x, device, 2, caller)
    cfgs = tuple(cfgs)
    if not cfgs:
        raise ValueError(f"{caller} needs a non-empty config table")
    for cfg in cfgs:
        _check_mode(cfg)
        if not _same_channel(cfg.channel, cfgs[0].channel):
            raise ValueError(
                "all adaptive mode configs must share one ChannelConfig; "
                f"got {cfg.channel} vs {cfgs[0].channel}")
    ch0 = cfgs[0].channel
    cfgs = tuple(c if c.channel is ch0 else dataclasses.replace(c, channel=ch0)
                 for c in cfgs)
    if dispatch == "auto":
        dispatch = "bucketed"
    if dispatch not in ("bucketed", "select"):
        raise ValueError(f"unknown dispatch {dispatch!r}; use bucketed|select")
    if dispatch == "select" and any(cfg.use_kernel for cfg in cfgs):
        raise ValueError(
            "use_kernel configs cannot take the select dispatch (the "
            "reference's vmapped switch cannot lower its kernel); use the "
            "bucketed dispatch, or clear_kernel_rows")
    num_clients = x.shape[0]
    if isinstance(mode_idx, torch.Tensor):
        mode_idx = mode_idx.cpu()
    mode_np = np.asarray(mode_idx).astype(np.int32)
    if mode_np.shape != (num_clients,):
        raise ValueError(
            f"mode_idx must be ({num_clients},) to match the batch; got "
            f"{mode_np.shape}")
    mode_np = np.clip(mode_np, 0, len(cfgs) - 1)
    snr_vec = _resolve_batch_snr(cfgs[0], num_clients, snr_db, x.device)
    with spans.span("keys"):
        keys = client_keys(key, num_clients, client_offset)
    return x, cfgs, mode_np, snr_vec, keys, dispatch


def transmit_batch_adaptive(x, key: torch.Tensor, cfgs, mode_idx, *,
                            snr_db=None, client_offset: int = 0,
                            dispatch: str = "auto", device=None):
    """Mixed-mode batched uplink: client ``i`` uses ``cfgs[mode_idx[i]]``.

    Args:
      x: ``(num_clients, N)`` payload matrix.
      key: base PRNG key; the :func:`client_keys` schedule, so row ``i``
        equals ``transmit_flat(x[i], fold_in(key, client_offset + i),
        cfgs[m_i])`` under either dispatch.
      cfgs: the mode table; all rows share one ``ChannelConfig``.
      mode_idx: ``(num_clients,)`` table indices; out-of-range values
        clamp, and the clamped vector is what ``stats.mode_idx`` records.
      snr_db: optional per-client SNR (scalar or ``(num_clients,)``).
      client_offset: global index of row 0.
      dispatch: ``"auto"`` (= ``"bucketed"``), ``"bucketed"`` (one batch
        per non-empty mode at a quarter-octave capacity; ``use_kernel``
        rows launch K1 once per bucket) or ``"select"`` (each mode on
        exactly its clients; ``use_kernel`` rows raise ``ValueError``).
      device: where to run; ``None`` is the GPU.

    Returns ``(x_hat (num_clients, N) float32, TxStats)`` with
    ``stats.mode_idx`` set.
    """
    x, cfgs, mode_np, snr_vec, keys, dispatch = _adaptive_prologue(
        x, key, cfgs, mode_idx, snr_db, client_offset, dispatch,
        "transmit_batch_adaptive", device)
    x_hat, stats = _bucketed_adaptive(x, keys, cfgs, mode_np, snr_vec,
                                      padded=dispatch == "bucketed")
    stats.mode_idx = torch.as_tensor(mode_np, device=x.device)
    return x_hat, stats


def transmit_batch_adaptive_aggregate(x, key: torch.Tensor, cfgs, mode_idx,
                                      weights, *, snr_db=None,
                                      client_offset: int = 0, device=None):
    """Mixed-mode fused uplink + aggregation (bucketed dispatch only).

    Each mode bucket reduces its clients to one weighted partial (one K2
    launch per uncoded ``use_kernel`` bucket) and the partials add in
    increasing mode index: on a one-mode cohort this is
    :func:`transmit_batch_aggregate` bit for bit. ``weights`` must be
    normalized over the whole cohort first. Returns ``(agg (N,) float32,
    TxStats)`` with stats in client order and ``mode_idx`` set.
    """
    x, cfgs, mode_np, snr_vec, keys, _ = _adaptive_prologue(
        x, key, cfgs, mode_idx, snr_db, client_offset, "bucketed",
        "transmit_batch_adaptive_aggregate", device)
    agg, stats = _bucketed_adaptive_aggregate(x, keys, cfgs, mode_np,
                                              snr_vec, weights)
    stats.mode_idx = torch.as_tensor(mode_np, device=x.device)
    return agg, stats


def tree_flatten(tree) -> tuple[list, Any]:
    """Leaves of a tree of dicts and lists of tensors in
    ``jax.tree_util`` order — dict keys sorted, list items in order — and
    the structure to rebuild it. An empty dict or list holds no leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
    elif isinstance(tree, list):
        keys = range(len(tree))
    else:
        return [tree], None
    leaves, children = [], []
    for k in keys:
        sub_leaves, sub_spec = tree_flatten(tree[k])
        leaves.extend(sub_leaves)
        children.append((k, sub_spec, len(sub_leaves)))
    return leaves, (type(tree), children)


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees (dicts and lists) of one
    structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        return [tree_map(fn, *items) for items in zip(*trees)]
    return fn(*trees)


def tree_unflatten(spec, leaves: list):
    """Inverse of :func:`tree_flatten`."""
    if spec is None:
        return leaves[0]
    kind, children = spec
    out, off = {}, 0
    for k, sub_spec, count in children:
        out[k] = tree_unflatten(sub_spec, leaves[off:off + count])
        off += count
    return [out[i] for i in range(len(children))] if kind is list else out


def transmit_pytree_batch(tree, key: torch.Tensor, cfg: TransportConfig, *,
                          snr_db=None, device=None):
    """Batched pytree uplink: every leaf has a leading client dim; each
    client's leaves flatten (sorted keys) into one ``(C, D)`` payload.

    Returns ``(tree_hat, stats)`` with shapes and dtypes restored.
    """
    leaves, spec = tree_flatten(tree)
    row, n = pack(leaves, 1, _pad_to(cfg))
    x, snr_vec, keys = _batch_prologue(row, key, cfg, snr_db, 0, device,
                                       "transmit_pytree_batch")
    x_hat, stats = _batch_with_keys(x, keys, cfg, snr_vec, n=n)
    return tree_unflatten(spec, unpack(x_hat, leaves, 1)), stats


def transmit_pytree_batch_aggregate(tree, key: torch.Tensor,
                                    cfg: TransportConfig, weights, *,
                                    snr_db=None, device=None):
    """Pytree front-end of :func:`transmit_batch_aggregate`: the aggregate
    comes back in the tree's structure with the client axis reduced
    away."""
    leaves, spec = tree_flatten(tree)
    row, n = pack(leaves, 1, _pad_to(cfg))
    x, snr_vec, keys = _batch_prologue(row, key, cfg, snr_db, 0, device,
                                       "transmit_pytree_batch_aggregate")
    agg, stats = _batch_aggregate_with_keys(x, keys, cfg, snr_vec, weights,
                                            n=n)
    return tree_unflatten(spec, unpack(agg, leaves, 1, cast=False)), stats


def transmit_pytree_batch_adaptive(tree, key: torch.Tensor, cfgs, mode_idx,
                                   *, snr_db=None, dispatch: str = "auto",
                                   device=None):
    """Pytree front-end of :func:`transmit_batch_adaptive`: the entry point
    the scenario-driven FL rounds feed their gradients through."""
    leaves, spec = tree_flatten(tree)
    row, _ = pack(leaves, 1)
    x_hat, stats = transmit_batch_adaptive(
        row, key, cfgs, mode_idx, snr_db=snr_db, dispatch=dispatch,
        device=device)
    return tree_unflatten(spec, unpack(x_hat, leaves, 1)), stats


def transmit_pytree_batch_adaptive_aggregate(tree, key: torch.Tensor, cfgs,
                                             mode_idx, weights, *,
                                             snr_db=None, device=None):
    """Pytree front-end of :func:`transmit_batch_adaptive_aggregate` (the
    scenario-driven fused rounds; globally normalized weights)."""
    leaves, spec = tree_flatten(tree)
    row, _ = pack(leaves, 1)
    agg, stats = transmit_batch_adaptive_aggregate(
        row, key, cfgs, mode_idx, weights, snr_db=snr_db, device=device)
    return tree_unflatten(spec, unpack(agg, leaves, 1, cast=False)), stats


def _broadcast_payload(x, num_clients: int, device) -> torch.Tensor:
    """Validate one flat ``(N,)`` payload and tile it into one dense
    ``(num_clients, N)`` float32 batch on its device (one copy there; the
    kernel path takes it as it is when ``N`` is a whole number of
    tiles)."""
    x = torch.as_tensor(x).to(device=resolve_device(device),
                              dtype=torch.float32)
    if x.ndim != 1:
        raise ValueError(f"broadcast wants a flat (N,) payload; got "
                         f"{tuple(x.shape)}")
    keylanes.check_cohort(DOWNLINK_KEY_LANE, num_clients)
    return x.expand(num_clients, x.shape[0]).contiguous()


def transmit_broadcast(x, key: torch.Tensor, cfg: TransportConfig,
                       num_clients: int, *, snr_db=None, device=None):
    """Broadcast one payload through ``num_clients`` independent downlinks.

    The downlink leg of an FL round: the PS transmits the global model
    once and every client hears it over its own fading channel. Client
    ``i``'s key is ``fold_in(key, DOWNLINK_KEY_LANE + i)``, so the caller
    may reuse the round's uplink key: the uplink's draws do not change.
    One K1 launch on the kernel path; the layered PHY or the ECRT model
    otherwise.

    Args:
      x: ``(N,)`` global payload (cast to float32).
      key: base PRNG key ``(2,)``, typically the round's uplink key.
      cfg: downlink transport configuration.
      num_clients: receiving clients, in ``[1, lane width]``.
      snr_db: optional per-client SNR (scalar or ``(num_clients,)``).
      device: where to run; ``None`` is the GPU.

    Returns ``(x_hat (num_clients, N) float32, TxStats with
    (num_clients,) fields)``; ``latency.broadcast_airtime`` prices the
    single transmission from them.
    """
    xb, snr_vec, keys = _batch_prologue(
        _broadcast_payload(x, num_clients, device), key, cfg, snr_db,
        DOWNLINK_KEY_LANE, device, "transmit_broadcast")
    return _batch_with_keys(xb, keys, cfg, snr_vec)


def transmit_broadcast_adaptive(x, key: torch.Tensor, cfgs, mode_idx, *,
                                snr_db=None, dispatch: str = "auto",
                                device=None):
    """Mixed-mode broadcast: client ``i`` receives via
    ``cfgs[mode_idx[i]]``. :func:`transmit_batch_adaptive` on the tiled
    payload with ``client_offset=DOWNLINK_KEY_LANE``: the same dispatches
    and checks (one K1 launch per non-empty uncoded bucket on
    ``use_kernel`` tables)."""
    num_clients = len(mode_idx)
    xb = _broadcast_payload(x, num_clients, device)
    return transmit_batch_adaptive(
        xb, key, cfgs, mode_idx, snr_db=snr_db,
        client_offset=DOWNLINK_KEY_LANE, dispatch=dispatch, device=device)


def transmit_pytree_broadcast(tree, key: torch.Tensor, cfg: TransportConfig,
                              num_clients: int, *, snr_db=None, device=None):
    """Broadcast a whole tree (the global model) to every client: leaves
    come back with a leading ``(num_clients,)`` dim, client ``i``'s copy
    at index ``i``; stats are per client."""
    leaves, spec = tree_flatten(tree)
    row, n = pack(leaves, 0, _pad_to(cfg))
    xb, snr_vec, keys = _batch_prologue(
        _broadcast_payload(row, num_clients, device), key, cfg, snr_db,
        DOWNLINK_KEY_LANE, device, "transmit_pytree_broadcast")
    x_hat, stats = _batch_with_keys(xb, keys, cfg, snr_vec, n=n)
    return tree_unflatten(spec, unpack(x_hat, leaves)), stats


def transmit_pytree_broadcast_adaptive(tree, key: torch.Tensor, cfgs,
                                       mode_idx, *, snr_db=None,
                                       dispatch: str = "auto", device=None):
    """Pytree front-end of :func:`transmit_broadcast_adaptive`."""
    leaves, spec = tree_flatten(tree)
    row, _ = pack(leaves)
    x_hat, stats = transmit_broadcast_adaptive(
        row, key, cfgs, mode_idx, snr_db=snr_db, dispatch=dispatch,
        device=device)
    return tree_unflatten(spec, unpack(x_hat, leaves)), stats


def transmit_sparse(values, indices, dim: int, key: torch.Tensor,
                    cfg: TransportConfig, compression=None, *, snr_db=None,
                    device=None):
    """One client's sparse ``(values, indices)`` uplink: the ``(k,)`` values
    on ``key``, the index header on the header key lane, scattered back to a
    dense ``(dim,)`` vector; stats sum both legs. Delegates to
    :func:`repro_torch.compress.framing.transmit_sparse`."""
    from repro_torch.compress import framing as framing_lib

    return framing_lib.transmit_sparse(values, indices, dim, key, cfg,
                                       compression, snr_db=snr_db,
                                       device=device)


def transmit_sparse_batch(values, indices, dim: int, key: torch.Tensor,
                          cfg: TransportConfig, compression=None, *,
                          snr_db=None, client_offset: int = 0, device=None):
    """Batched :func:`transmit_sparse` under the :func:`client_keys`
    schedule (one K1 launch for the value leg on the kernel path).
    Delegates to :func:`repro_torch.compress.framing.transmit_sparse_batch`.
    """
    from repro_torch.compress import framing as framing_lib

    return framing_lib.transmit_sparse_batch(
        values, indices, dim, key, cfg, compression, snr_db=snr_db,
        client_offset=client_offset, device=device)
