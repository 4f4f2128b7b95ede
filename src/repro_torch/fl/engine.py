"""FL round engine (port): FedSGD and FedAvg rounds over the wireless
uplink, with the optional noisy downlink broadcast.

Counterpart of ``repro.fl.engine``. An algorithm says what the clients
compute and how the PS applies the aggregate: :class:`FedSGD` uploads
one-step gradients and applies them through SGD (paper eq. (4)-(6));
:class:`FedAvg` uploads the weight delta after ``local_steps`` local SGD
steps, optionally scaled per client by ``1 / max|delta|``
(``scale_mode="max_abs"``), and adds the aggregated delta to the model.
:class:`RoundEngine` says how a round runs. Driverless runs (no
``scenario=``) are the paper's own experiment, in both of its round
shapes:

* **layered** (``fused_aggregate=False``): payloads ->
  ``transport.transmit_pytree_batch`` (one K1 launch on the kernel path,
  the layered PHY or the ECRT model otherwise) -> mean over clients ->
  apply;
* **fused** (``fused_aggregate=True``): payloads ->
  ``transport.transmit_pytree_batch_aggregate`` with uniform normalized
  weights (one K2 launch on the kernel path) -> apply.

Each round mirrors the reference as written: the layered round averages
with a mean over the client axis (a reduction whose order PyTorch does not
share with XLA), the fused round with the client-order sum of K2.

Scenario runs (``scenario=`` a preset name, a ``Scenario`` or a
``ScenarioDriver``) add the link step of the reference: each round the
driver moves every client's SNR, estimates it, picks a mode per client
from the policy table and draws dropouts and stragglers; the uplink then
runs the mixed-mode table in one of three round shapes:

* **bucketed layered** (``adaptive_dispatch="bucketed"``): one batch per
  non-empty mode (``transport.transmit_pytree_batch_adaptive``; one K1
  launch per uncoded bucket on ``use_kernel`` tables), then
  :func:`dropout_weighted_mean`;
* **bucketed fused** (``fused_aggregate=True``): the ``active`` mask
  normalized over the cohort as weights (dropped clients still transmit,
  with weight 0), one weighted partial per bucket (one K2 launch per
  uncoded bucket), the partials added in mode order;
* **select** (``adaptive_dispatch="select"``): the table with its kernel
  rows cleared (:func:`select_mode_cfgs`), each mode on exactly its own
  clients, then :func:`dropout_weighted_mean`. ``fused_aggregate=True``
  with it raises ``ValueError``, as in the reference.

Every layered uplink goes through ``algorithm.wrap_uplink`` (FedAvg's
``max_abs`` scale and descale); ``fused_aggregate=True`` with
``scale_mode="max_abs"`` raises ``ValueError``, since the descale runs
between demap and aggregate.

Downlink leg (``downlink=DownlinkConfig(...)``, or a scenario that brings
one, as ``static-noisy-dl`` and ``vehicular-noisy-dl`` do): at the top of
each round the global model rides ``transport.transmit_pytree_broadcast``
through every client's own downlink (one K1 launch on a ``use_kernel``
config), and each client computes its payload from its received copy
(``algorithm.payload_from``). The broadcast reuses the round's uplink key
(``rk`` driverless, ``k_tx`` in scenario rounds) on the downlink key lane,
so the uplink's draws do not change. Its transport is the pre-resolution
uplink config with the downlink's mode and modulation: driverless runs
shift the channel SNR by ``snr_offset_db`` (elementwise) and resolve ECRT
to its analytic model at the shifted SNR (with a per-client airtime scale
for heterogeneous cohorts); scenario rounds transmit at ``rnd.snr_db +
offset`` and calibrate an ECRT downlink at the fleet's mean SNR + offset.
``adaptive=True`` (scenario runs only) picks each client's downlink mode
from the policy table at the shifted CSI and runs the mixed-mode
broadcast under the run's dispatch (one K1 launch per non-empty uncoded
bucket, bucketed; kernel rows cleared, select). The broadcast costs the
per-mode max of the clients' reception airtime
(``latency.broadcast_airtime``). A lossless downlink (``perfect``, or
ECRT, which delivers exact bits) hands every client the global model bit
for bit, so the round computes the payload from the global model itself,
once (``algorithm.payload``); this keeps a perfect downlink bit-identical
to ``downlink=None``. ``downlink=None`` leaves every draw and result of
the downlink-free rounds as they were.

The per-client airtime is the driver's (mode-priced, straggler-scaled,
zero for dropped clients) or ``round_airtime`` (driverless), plus the
broadcast's airtime. Each round's telemetry is a typed
``repro_torch.obs.records.RoundRecord`` in ``FLResult.records`` (one per
round, driverless rounds included); ``FLResult.link`` is the
``to_link_dict()`` view of the records that have link fields, the
reference's per-round dicts in its key order.

Compressed uplinks (``compression=CompressionConfig(...)``, or a scenario
that brings one, as ``iot-lowrate`` does) replace each round's dense
uplink with the sparse wire (``repro_torch.compress``): every client keeps
an error-feedback residual ``(M, D)`` across rounds (zeros when
``error_feedback=False``), selects ``k`` coordinates of ``residual +
payload`` and sends the values through the transport (one K1 launch for
the whole ``(M, k)`` batch on a ``use_kernel`` config) plus a protected
index header; the PS scatters the received values back to ``(M, D)`` and
aggregates as the dense rounds do. The three round shapes: driverless
(EF select -> sparse batch -> mean), bucketed (each mode bucket selects
with its own budget from ``PolicyConfig.compress_ratios``, rides
``wrap_uplink`` and its mode's config, one K1 launch per uncoded bucket,
then :func:`dropout_weighted_mean`; dropped clients keep their
accumulation) and select (the same on the table with its kernel rows
cleared, one budget for every mode).
``compress_ratios`` needs the bucketed dispatch and an explicit ``k``
wins everywhere, as in the reference; ``fused_aggregate=True`` with
compression raises ``ValueError``. Compressed rounds add ``comp_ratio``,
``comp_bits_on_air`` and ``comp_residual_norm`` to ``FLResult.link``,
between the scenario fields and the downlink fields.

ECRT with ``simulate_fec=True`` is priced, not decoded, in rounds, as in
the reference: :func:`resolve_ecrt_analytic` calibrates E[tx] once with
the real LDPC chain and swaps in the analytic model; a heterogeneous-SNR
cohort also gets a per-client airtime scale.

The key schedule is the reference's: ``key -> (key, params key)`` at
start, then (scenario runs) ``key -> (key, link-init key)``, then ``key ->
(key, round key)`` each round, and inside a scenario round ``round key ->
(link key, uplink key)``; minibatches come from
``numpy.random.default_rng(seed)`` exactly as in the reference.

Each round is timed by spans (``repro_torch.obs.spans``; the span tree
is in its docstring) into ``FLResult.phase_s``: ``key`` (the round key's
split, threefry on the host), ``sample`` (the minibatch gather and its
copy to the device: whole rows into pinned staging and a non-blocking
copy on CUDA, :class:`RowStaging`; the algorithm's ``staged_samples``
counts those rounds), ``gradients`` (FedAvg: the local steps),
``uplink``, ``apply``, ``telemetry`` (airtime, the record, its ledger
line and sketches) and ``eval`` (0.0 on rounds without one).
The device phases (downlink, gradients, uplink, apply, eval) take their
time from CUDA events on the card, resolved at the phase-end synchronise
the engine makes (so ``FLResult.phase_s`` reads device time, not enqueue
time); the host phases and every phase on the CPU, the host clock. The
uplink's parts are ``uplink_<part>``: ``keys`` (the per-client key
schedule and kernel seeds, on the host), ``kernel`` (the K1/K2 launches,
or their plain versions on the CPU), the layered PHY's ``codec``,
``channel`` and ``demod``, and ``mean`` (the PS mean of a layered round);
each is 0.0 on a round whose uplink has no such part. Downlink rounds add
``downlink`` and its ``downlink_<part>`` (the uplink's parts but
``mean``); scenario rounds add ``link``, the link step on the host.
``FLResult.counters`` holds each round's kernel launches (``k0``, ``k1``,
``k2``).

The round key stays on the CPU, so the key schedule (a few hundred int64
ops on ``num_clients`` elements) and the link step run on the host and
only the seeds, the SNRs and the ``active`` weights cross to the device:
each op costs less there than a launch on the GPU (measured by
``chip_smoke.py``, phases 5d and 6; see PERF.md). ``prng`` follows
its key's device, so moving the key moves the schedule; the layered PHY
moves the client keys to the payload's device, where it draws per symbol.

Observability sinks (``repro_torch.obs``), each a pure observer: a run
with any of them is bit for bit the run without (params, accuracy,
airtime, ``FLResult.link``, launch counters).

* ``ledger=`` (a path or a ``RunLedger``) writes the reference's JSONL
  ledger: the manifest (config fingerprint, equal to the reference's for
  equal arguments; provenance with the device), one line per round
  record, with the ``uplink_*`` aggregates of ``TxStats.round_summary``
  (a host copy made only with a ledger attached), one per eval, and the
  summary (with ``phases`` and ``sketches`` when those sinks are on).
* ``phase_timers=`` (a ``PhaseTimers``) times the reference's scopes:
  ``sample``, ``round`` (link step through apply), ``telemetry``
  (airtime, the record, its ledger line and sketches; one scope a round)
  and ``eval``. On CUDA each scope closes after a device synchronise, so
  it reads device time.
* ``sketches=`` (``True``, a layout dict or a ``RoundSketcher``) needs a
  scenario (``ValueError`` otherwise, as the reference): each round's
  per-client SNR, estimate, BER (K1's or K2's per-client error counts on
  kernel rounds), airtime, mode dwell and downlink BER become bucket
  counts and exemplars on the engine's device, keyed by the round key on
  the reserved obs lane.

The buffered asynchronous engine (``fl/async_engine.py``) runs the same
round body (:meth:`RoundEngine._round_body`: link step, downlink,
payloads, uplink) on each wave, with a member mask and without the PS
mean, and aggregates at its own event times.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch import resolve_device
from repro_torch.compress import framing as framing_lib
from repro_torch.compress import sparsify as sparsify_lib
from repro_torch.core import aggregation as aggregation_lib
from repro_torch.core import latency as latency_lib
from repro_torch.core import prng
from repro_torch.core import transport as transport_lib
from repro_torch.fl import cnn
from repro_torch.kernels import approx_channel as ac
from repro_torch.obs import ledger as ledger_lib
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import records as records_lib
from repro_torch.obs import spans
from repro_torch.obs import timers as timers_lib
from repro_torch.optim.sgd import sgd as make_sgd

__all__ = ["FLResult", "FedSGD", "FedAvg", "RoundEngine", "RowStaging",
           "resolve_ecrt_analytic", "resolve_scenario", "resolve_downlink",
           "resolve_compression", "select_mode_cfgs",
           "dropout_weighted_mean"]


@dataclasses.dataclass
class FLResult:
    """Outcome of one FL run."""

    rounds: list
    accuracy: list
    airtime_s: list  # cumulative airtime: TDMA uplink sum (+ downlink leg)
    wall_s: float
    final_accuracy: float
    # One dict per round, the seconds of each span (module docstring):
    # "key" (the round key's split), "sample", "gradients" (FedAvg: the
    # local steps), "uplink" with its
    # parts "uplink_<part>" (keys, kernel, codec, channel, demod, mean; 0.0
    # where the uplink has none), "telemetry", "apply" and "eval" (0.0 on
    # rounds without an eval); scenario rounds add "link", the host-side
    # link step; downlink rounds add "downlink" with its parts
    # "downlink_<part>" (the uplink's but mean).
    phase_s: list = dataclasses.field(default_factory=list)
    # One dict per round (the buffered engine: per wave): the round's
    # launches of each kernel, {"k0", "k1", "k2"}; 0 on the CPU.
    counters: list = dataclasses.field(default_factory=list)
    # Per-round link telemetry in the reference's key order. Scenario
    # runs: {round, mean_snr_db, mean_est_db, mode_counts, n_active,
    # n_stragglers, airtime_s} (mode_counts indexes the driver's mode
    # table); runs with a downlink add {downlink_airtime_s, downlink_ber,
    # and for adaptive downlinks downlink_mode_counts}; compressed runs add
    # {comp_ratio (mean kept fraction), comp_bits_on_air (active clients'
    # on-air bits this round), comp_residual_norm (mean per-client L2 of
    # the EF residual)} before the downlink fields; driverless downlink or
    # compressed runs append {round} and their own fields. [] otherwise.
    link: list = dataclasses.field(default_factory=list)
    # One ``repro_torch.obs.records.RoundRecord`` per round, rounds
    # without link fields included; ``link`` is the ``to_link_dict()``
    # view of the records that have any. With a ledger attached the
    # records also carry the ``uplink_*`` aggregates, with sketches the
    # round's ``sketches`` group.
    records: list = dataclasses.field(default_factory=list)
    # Event-clock times of each eval point; only the buffered engine
    # (fl/async_engine.py) fills it, the sync engine leaves it [].
    event_s: list = dataclasses.field(default_factory=list)


def resolve_scenario(scenario, transport_cfg, device=None):
    """``scenario=`` argument -> a bound ``ScenarioDriver`` (or ``None``):
    a registered name, a ``Scenario`` or a ready driver. ECRT calibration,
    if the scenario asks for it, runs on ``device``."""
    if scenario is None:
        return None
    from repro_torch.link import scenario as scenario_lib

    if isinstance(scenario, scenario_lib.ScenarioDriver):
        return scenario
    if isinstance(scenario, str):
        scenario = scenario_lib.get_scenario(scenario)
    return scenario_lib.ScenarioDriver(scenario, transport_cfg, device=device)


def resolve_downlink(downlink, driver):
    """``downlink=`` argument -> the run's ``DownlinkConfig`` (or
    ``None``): an explicit argument wins, else a scenario's own
    ``downlink``; ``None`` is the error-free downlink (no broadcast)."""
    if downlink is not None:
        return downlink
    if driver is not None:
        return driver.scenario.downlink
    return None


def resolve_compression(compression, driver):
    """``compression=`` argument -> the run's ``CompressionConfig`` (or
    ``None``): an explicit argument wins, else a scenario's own
    ``compression``; ``None`` is the dense uplink."""
    if compression is not None:
        return compression
    if driver is not None:
        return driver.scenario.compression
    return None


def dropout_weighted_mean(tree, active):
    """Mean of ``(M, ...)`` leaves over the active clients only:
    ``tensordot(active, g) / max(sum(active), 1)``; an all-dropped round
    gives zeros. The contraction is PyTorch's, deterministic on a device
    but not in XLA's order (Trajectory grade against the reference)."""
    leaves, spec = transport_lib.tree_flatten(tree)
    active = torch.as_tensor(active, dtype=torch.float32).to(
        leaves[0].device)
    denom = torch.clamp_min(active.sum(), 1.0)
    return transport_lib.tree_unflatten(spec, [
        torch.tensordot(active, g, dims=([0], [0])) / denom for g in leaves])


def select_mode_cfgs(driver):
    """The driver's mode table for the select dispatch: kernel rows
    cleared (``transport.clear_kernel_rows``), so a select round runs the
    layered PHY and is not bit-comparable to a bucketed kernel round."""
    return transport_lib.clear_kernel_rows(driver.mode_cfgs)


def resolve_ecrt_analytic(transport_cfg, num_clients: int, device=None):
    """Swap real-FEC ECRT for the calibrated analytic model in an FL loop.

    The real decoder inside every round would only re-measure a constant:
    calibrate instead, with the shared pricing budget
    (``latency.DEFAULT_CALIB_CODEWORDS``/``_MAX_TX``), on ``device``.
    Heterogeneous cohorts get E[tx] per client (``ecrt_expected_tx_profile``),
    the cohort mean drives the transport constant, and the per-client ratio
    comes back as a ``(num_clients,)`` airtime scale (the analytic model is
    linear in E[tx]). Returns ``(transport_cfg, air_scale_or_None)``.
    """
    if not (transport_cfg.mode == "ecrt" and transport_cfg.simulate_fec):
        return transport_cfg, None
    snr_vec = np.asarray(transport_cfg.channel.snr_db, np.float32).reshape(-1)
    e_tx = latency_lib.ecrt_expected_tx_profile(
        snr_vec, transport_cfg.modulation,
        n_codewords=latency_lib.DEFAULT_CALIB_CODEWORDS,
        max_tx=latency_lib.DEFAULT_CALIB_MAX_TX, device=device)
    e_mean = float(e_tx.mean())
    transport_cfg = dataclasses.replace(
        transport_cfg, simulate_fec=False, ecrt_expected_tx=e_mean)
    air_scale = None
    if e_tx.size == num_clients and e_tx.size > 1:
        air_scale = torch.from_numpy(e_tx / np.float32(e_mean)).to(
            resolve_device(device))
    return transport_cfg, air_scale


class RowStaging:
    """The minibatch gather behind both algorithms' ``sample``: whole rows
    of the clients' data, copied to the device through pinned staging.

    ``client_x`` ``(M, n, ...)`` is viewed once per array as ``(M * n,
    prod(...))`` rows (a view when it is C-contiguous, else one copy), and
    ``client_y`` as ``(M * n,)``. A round's draws ``take`` ``(M, ...)``
    become the flat row indices ``arange(M) * n + take``, and
    ``np.take(..., mode="clip")`` copies those rows: the indices lie in
    range by construction, and ``clip`` writes straight into ``out``
    (``raise`` buffers it). The rows are those of the reference's
    ``np.take_along_axis`` bit for bit, without its index arrays broadcast
    to the whole output.

    On CUDA the rows land in one of two pinned host buffers for each
    (shape, dtype), taken in turn, and cross with a non-blocking copy; a
    CUDA event recorded after the copy guards the buffer, and the host
    waits on it before it writes there again (the buffered engine makes no
    round-end synchronise of its own). The device tensors returned are
    fresh, never a staging buffer. On any other device there is no
    staging: the gather returns fresh tensors, as a copy from numpy does.
    """

    def __init__(self):
        self._src = (None, None)  # the (client_x, client_y) _rows views
        self._rows = None
        self._slots = {}  # (x shape, dtype, y shape) -> two (x, y, event)

    def _flat(self, client_x, client_y):
        if self._src[0] is not client_x or self._src[1] is not client_y:
            m, n = client_x.shape[:2]
            self._src = (client_x, client_y)
            self._rows = (np.ascontiguousarray(client_x).reshape(m * n, -1),
                          np.asarray(client_y).reshape(m * n))
        return self._rows

    def gather(self, client_x, client_y, take, device):
        """``(xb, yb, staged)``: each client's rows ``take[c]`` of
        ``client_x`` (``take.shape + client_x.shape[2:]``) and of
        ``client_y`` as int64 (``take.shape``) on ``device``; ``staged``
        is True where they crossed through pinned staging."""
        flat_x, flat_y = self._flat(client_x, client_y)
        m, n = client_x.shape[:2]
        idx = (np.arange(m)[:, None] * n + take.reshape(m, -1)).ravel()
        x_shape = take.shape + tuple(client_x.shape[2:])
        dev = None if device is None else torch.device(device)
        if dev is None or dev.type != "cuda":
            xb = np.take(flat_x, idx, axis=0, mode="clip").reshape(x_shape)
            yb = np.take(flat_y, idx, mode="clip").astype(np.int64)
            return (torch.from_numpy(xb).to(device),
                    torch.from_numpy(yb.reshape(take.shape)).to(device),
                    False)
        key = (x_shape, flat_x.dtype.str, take.shape)
        if key not in self._slots:
            self._slots[key] = [
                (torch.from_numpy(np.empty(x_shape, flat_x.dtype))
                 .pin_memory(),
                 torch.empty(take.shape, dtype=torch.int64, pin_memory=True),
                 torch.cuda.Event()) for _ in range(2)]
        slots = self._slots[key]
        slots.append(slots.pop(0))  # the buffer used longest ago
        hx, hy, copied = slots[-1]
        copied.synchronize()  # the last copy out of this buffer is done
        np.take(flat_x, idx, axis=0, out=hx.numpy().reshape(idx.size, -1),
                mode="clip")
        hy.numpy().reshape(-1)[:] = np.take(flat_y, idx, mode="clip")
        xb = hx.to(dev, non_blocking=True)
        yb = hy.to(dev, non_blocking=True)
        copied.record(torch.cuda.current_stream(dev))
        return xb, yb, True


class FedSGD:
    """The paper's algorithm: one gradient per client per round (eq. (4)-(6)).

    Payload = the per-client single-step gradients of the shared global
    model; the PS applies the aggregate through the SGD optimizer.
    """

    name = "fedsgd"

    def __init__(self, cfg, batch_per_round: int = 32):
        self.cfg = cfg
        self.batch_per_round = batch_per_round
        self.opt = make_sgd(cfg.lr)
        grad_fn = grad(cnn.loss_fn)
        self._client_grads = vmap(grad_fn, in_dims=(None, 0, 0))
        self._own_grads = vmap(grad_fn, in_dims=(0, 0, 0))
        self._rows = RowStaging()
        self.staged_samples = 0  # rounds whose sample crossed pinned staging

    def init_params(self, key, device=None):
        """Global model at round 0."""
        return cnn.init_params(key, self.cfg, device)

    def init_opt(self, params):
        """Optimizer state threaded through the rounds."""
        return self.opt.init(params)

    def sample(self, rng, client_x, client_y, device=None):
        """One round's per-client minibatches ``(M, B, ...)`` on ``device``,
        drawn with the reference's numpy calls: a whole-row gather into
        pinned staging and a non-blocking copy on CUDA
        (:class:`RowStaging`; ``staged_samples`` counts those rounds), a
        fresh tensor elsewhere."""
        M = client_x.shape[0]
        take = rng.integers(0, client_x.shape[1], (M, self.batch_per_round))
        xb, yb, staged = self._rows.gather(client_x, client_y, take, device)
        self.staged_samples += staged
        return xb, yb

    def payload(self, params, xb, yb):
        """Per-client gradients of the global model: leaves ``(M, ...)``."""
        return self._client_grads(params, xb, yb)

    def payload_from(self, recv_params, xb, yb):
        """Per-client gradients, each at that client's received model copy
        (leaves ``(M, ...)``; convs become batched-weight convs)."""
        return self._own_grads(recv_params, xb, yb)

    def wrap_uplink(self, payload, transmit):
        """FedSGD uploads raw gradients: no transport-side scaling."""
        return transmit(payload)

    def apply(self, params, opt_state, agg):
        """PS update (eq. (6)): one optimizer step on the aggregate."""
        return self.opt.update(agg, opt_state, params)


# XLA turns the reference's ``/ 0.9`` into a multiply by the float32
# reciprocal (0x3F8E38E4); the port multiplies by the same constant.
_INV_0_9 = float(np.float32(1.0) / np.float32(0.9))


class FedAvg:
    """FedAvg over the approximate uplink (beyond-paper extension).

    Payload = the weight delta after ``local_steps`` local SGD steps, each
    on a fresh minibatch of ``batch_per_step``. ``scale_mode``:

      ``none``     transmit raw deltas (the paper's prior |delta| < 2)
      ``max_abs``  divide each client's delta by ``max|delta| / 0.9``
                   before transmission and multiply it back at the PS; the
                   scalar travels on the error-free control channel.
    """

    name = "fedavg"

    def __init__(self, cfg, local_steps: int = 4, batch_per_step: int = 32,
                 scale_mode: str = "none"):
        self.cfg = cfg
        self.local_steps = local_steps
        self.batch_per_step = batch_per_step
        self.scale_mode = scale_mode
        self.grad_fn = grad(cnn.loss_fn)
        self._shared = vmap(self._local_delta, in_dims=(None, 0, 0))
        self._own = vmap(self._local_delta, in_dims=(0, 0, 0))
        self._rows = RowStaging()
        self.staged_samples = 0  # rounds whose sample crossed pinned staging

    def init_params(self, key, device=None):
        """Global model at round 0."""
        return cnn.init_params(key, self.cfg, device)

    def init_opt(self, params):
        """FedAvg applies deltas directly: no optimizer state."""
        return None

    def sample(self, rng, client_x, client_y, device=None):
        """One round's batches ``(M, local_steps, B, ...)`` on ``device``,
        drawn with the reference's numpy calls: a whole-row gather into
        pinned staging and a non-blocking copy on CUDA
        (:class:`RowStaging`; ``staged_samples`` counts those rounds), a
        fresh tensor elsewhere."""
        M = client_x.shape[0]
        L, B = self.local_steps, self.batch_per_step
        take = rng.integers(0, client_x.shape[1], (M, L, B))
        xb, yb, staged = self._rows.gather(client_x, client_y, take, device)
        self.staged_samples += staged
        return xb, yb

    def _local_delta(self, start, x, y):
        """One client's weight delta after ``local_steps`` SGD steps from
        ``start`` (its copy of the global model); ``x`` is ``(L, B, ...)``.
        Each step is a multiply, then a subtract (no fma)."""
        lr = self.cfg.lr
        p = start
        for i in range(self.local_steps):
            g = self.grad_fn(p, x[i], y[i])
            p = {k: p[k] - lr * g[k] for k in p}
        return {k: p[k] - start[k] for k in p}

    def payload(self, params, xb, yb):
        """Per-client local-step deltas from the shared global model."""
        return self._shared(params, xb, yb)

    def payload_from(self, recv_params, xb, yb):
        """Per-client deltas, each from that client's received copy (the
        PS still adds the aggregate to the true model)."""
        return self._own(recv_params, xb, yb)

    @staticmethod
    def _expand(s, like):
        return s.reshape((s.shape[0],) + (1,) * (like.ndim - 1))

    def _scale_of(self, deltas):
        """``(M,)`` per-client scales ``max(max|delta|, 1e-8) / 0.9``, the
        division taken as XLA takes it (module constant ``_INV_0_9``)."""
        leaves, _ = transport_lib.tree_flatten(deltas)
        M = leaves[0].shape[0]
        flat = torch.cat([l.reshape(M, -1) for l in leaves], dim=1)
        return torch.clamp_min(flat.abs().amax(dim=1), 1e-8) * _INV_0_9

    def _div(self, deltas, scale):
        if isinstance(deltas, torch.Tensor):  # a compressed (M, k) leg
            return deltas / self._expand(scale, deltas)
        return {k: l / self._expand(scale, l) for k, l in deltas.items()}

    def _mul(self, deltas, scale):
        if isinstance(deltas, torch.Tensor):
            return deltas * self._expand(scale, deltas)
        return {k: l * self._expand(scale, l) for k, l in deltas.items()}

    def wrap_uplink(self, deltas, transmit):
        """``scale_mode="max_abs"``: one scalar per client on the
        error-free control channel, the scaled cohort through the uplink,
        the received rows scaled back. ``none``: the uplink as is."""
        if self.scale_mode != "max_abs":
            return transmit(deltas)
        scale = self._scale_of(deltas)
        out, stats = transmit(self._div(deltas, scale))
        return self._mul(out, scale), stats

    def apply(self, params, aux, agg):
        """PS update: add the aggregated delta to the global model."""
        return {k: p + agg[k] for k, p in params.items()}, aux


# The parts of the uplink and the downlink each round reports, 0.0 where a
# leg has no such part (obs/spans.py has the tree).
UPLINK_PARTS = ("keys", "kernel", "codec", "channel", "demod", "mean")
DOWNLINK_PARTS = UPLINK_PARTS[:-1]


def _sync(device: torch.device) -> None:
    """A phase-end synchronise; the spans' device pairs resolve here."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        spans.settle()


def _parts(leg: str, seconds: dict, names) -> dict:
    """``{leg_<part>: seconds}`` of a leg's collected spans: every name in
    ``names`` (0.0 where it did not run), then any other part that ran."""
    out = {f"{leg}_{n}": seconds.get(n, 0.0) for n in names}
    out.update((f"{leg}_{n}", v) for n, v in seconds.items()
               if n not in names)
    return out


def launch_deltas(before: dict) -> dict:
    """Kernel launches since ``before`` (a ``launch_counts()`` dict)."""
    now = ac.launch_counts()
    return {k: now[k] - before[k] for k in now}


class RoundEngine:
    """FL round driver for :class:`FedSGD` or :class:`FedAvg`: driverless
    (the paper's static single-mode uplink) or scenario-driven (per-client
    link adaptation), with or without the downlink broadcast.

    Args mirror the reference's ``RoundEngine``; ``device`` picks where the
    model, payloads, both legs and the sketches run (``None`` is the GPU).
    ``ledger``, ``phase_timers`` and ``sketches`` attach the observability
    sinks (module docstring).
    """

    def __init__(self, algorithm, transport_cfg, client_x, client_y,
                 test_x, test_y, *, n_rounds: int, seed: int = 0,
                 eval_every: int = 2,
                 timings: latency_lib.PhyTimings | None = None,
                 scenario=None, adaptive_dispatch: str = "bucketed",
                 downlink=None, compression=None,
                 fused_aggregate: bool = False, ledger=None,
                 phase_timers=None, sketches=None, device=None):
        if adaptive_dispatch not in ("bucketed", "select"):
            raise ValueError(
                f"adaptive_dispatch must be bucketed|select, got "
                f"{adaptive_dispatch!r}")
        self.dispatch = adaptive_dispatch
        transport_lib._check_mode(transport_cfg)
        self.device = resolve_device(device)
        self.algo = algorithm
        self.num_clients = client_x.shape[0]
        self.fused_aggregate = bool(fused_aggregate)
        self.driver = resolve_scenario(scenario, transport_cfg, self.device)
        # Observability sinks: pure observers of values the round computed.
        self.ledger = ledger_lib.as_ledger(ledger)
        self.phase_timers = timers_lib.resolve_timers(phase_timers)
        self.sketcher = metrics_lib.resolve_sketches(
            sketches, self.num_clients, self.device)
        if self.sketcher is not None and self.driver is None:
            raise ValueError(
                "sketches= needs a scenario — the per-client SNR/mode "
                "distributions being sketched come from the link driver")
        if self.driver is not None:
            self.select_cfgs = select_mode_cfgs(self.driver)
        # Kept pre-resolution: the downlink derives its own transport from
        # it (an ECRT downlink is priced at the shifted SNR).
        self._raw_transport_cfg = transport_cfg
        self.ecrt_air_scale = None
        if self.driver is None:
            transport_cfg, self.ecrt_air_scale = resolve_ecrt_analytic(
                transport_cfg, self.num_clients, self.device)
        self.transport_cfg = transport_cfg
        self.downlink = resolve_downlink(downlink, self.driver)
        if (self.downlink is not None and self.downlink.adaptive
                and self.driver is None):
            raise ValueError(
                "DownlinkConfig(adaptive=True) needs a scenario: the "
                "per-client downlink mode comes from the scenario's policy "
                "table; driverless runs use a single broadcast mode")
        self.dl_air_scale = None
        self.dl_cfg = (None if self.downlink is None
                       else self._downlink_transport_cfg())
        # A lossless single-mode broadcast hands every client the global
        # model bit for bit: the payload is computed once, from it.
        self._dl_lossless = (self.downlink is not None
                             and not self.downlink.adaptive
                             and self.dl_cfg.mode in ("perfect", "ecrt"))
        self.compression = resolve_compression(compression, self.driver)
        if self.fused_aggregate:
            if self.compression is not None:
                raise ValueError(
                    "fused_aggregate=True is incompatible with a compressed "
                    "uplink: the sparse path must scatter per-client "
                    "coordinates before aggregating")
            if getattr(algorithm, "scale_mode", "none") == "max_abs":
                raise ValueError(
                    "fused_aggregate=True is incompatible with "
                    "scale_mode='max_abs': the per-client descale runs "
                    "between demap and aggregate")
            if self.driver is not None and self.dispatch != "bucketed":
                raise ValueError(
                    "fused_aggregate=True needs adaptive_dispatch="
                    "'bucketed' for scenario runs: the select dispatch has "
                    "no kernel rows to fuse into")
        self.client_x, self.client_y = client_x, client_y
        self.test_x = torch.as_tensor(test_x).to(self.device)
        self.test_y = torch.as_tensor(np.asarray(test_y, np.int64)).to(
            self.device)
        self.n_rounds = n_rounds
        self.seed = seed
        self.eval_every = eval_every
        self.timings = timings or latency_lib.PhyTimings()
        # Uniform cohort weights, normalized once (the reference's
        # build-time constant of the fused round).
        self.uniform_w = aggregation_lib.normalize_weights(
            torch.ones((self.num_clients,), dtype=torch.float32)).to(
                self.device)

        key = prng.PRNGKey(seed)
        key, pk = prng.split(key)
        self.params = algorithm.init_params(pk, self.device)
        self.aux = algorithm.init_opt(self.params)
        self._init_compression()
        if self.driver is not None:
            key, lk = prng.split(key)
            self.lstate, self.prev_mode, self.prev_est = self.driver.init(
                lk, self.num_clients)
        self._key = key

    # ----------------------------------------------------------- downlink

    def _downlink_transport_cfg(self):
        """The broadcast ``TransportConfig``: the raw uplink config with the
        downlink's mode and modulation. Driverless: the channel SNR shifted
        by the offset (elementwise for a per-client vector), then ECRT
        resolved to its analytic model at the shifted SNR (setting
        ``dl_air_scale`` for heterogeneous cohorts). Scenario rounds set
        the SNR per round, so the channel stays and an ECRT downlink is
        calibrated at the fleet's mean SNR + offset."""
        dl, raw = self.downlink, self._raw_transport_cfg
        cfg = dataclasses.replace(raw, mode=dl.mode,
                                  modulation=dl.modulation or raw.modulation)
        transport_lib._check_mode(cfg)
        if self.driver is not None:
            if cfg.mode == "ecrt" and cfg.simulate_fec:
                anchor = float(self.driver.scenario.dynamics.mean_snr_db
                               + dl.snr_offset_db)
                e_tx = latency_lib.calibrate_ecrt(
                    anchor, cfg.modulation,
                    n_codewords=latency_lib.DEFAULT_CALIB_CODEWORDS,
                    max_tx=latency_lib.DEFAULT_CALIB_MAX_TX,
                    device=self.device)
                cfg = dataclasses.replace(cfg, simulate_fec=False,
                                          ecrt_expected_tx=float(e_tx))
            return cfg
        ch = cfg.channel
        snr = np.asarray(ch.snr_db, np.float32) + np.float32(dl.snr_offset_db)
        snr_val = (float(snr) if snr.ndim == 0
                   else tuple(float(v) for v in snr.reshape(-1)))
        cfg = dataclasses.replace(
            cfg, channel=dataclasses.replace(ch, snr_db=snr_val))
        cfg, self.dl_air_scale = resolve_ecrt_analytic(
            cfg, self.num_clients, self.device)
        return cfg

    def _downlink_modes(self, est_db):
        """Adaptive downlink: each client's mode from the scenario's policy
        table at its shifted CSI (on the host, as the link step)."""
        from repro_torch.link import policy as policy_lib

        return policy_lib.downlink_mode(
            est_db, self.driver.scenario.policy, self.downlink.snr_offset_db)

    def _broadcast(self, params, key, rnd):
        """One round's broadcast leg: ``(received copies, stats)``.
        Scenario rounds transmit at ``rnd.snr_db + offset``; an adaptive
        downlink runs the mode table under the run's dispatch (kernel rows
        cleared for select)."""
        dl, dev = self.downlink, self.device
        if self.driver is None:
            return transport_lib.transmit_pytree_broadcast(
                params, key, self.dl_cfg, self.num_clients, device=dev)
        dl_snr = rnd.snr_db + dl.snr_offset_db
        if dl.adaptive:
            cfgs = (self.driver.mode_cfgs if self.dispatch == "bucketed"
                    else self.select_cfgs)
            return transport_lib.transmit_pytree_broadcast_adaptive(
                params, key, cfgs, self._downlink_modes(rnd.est_db),
                snr_db=dl_snr, dispatch=self.dispatch, device=dev)
        return transport_lib.transmit_pytree_broadcast(
            params, key, self.dl_cfg, self.num_clients, snr_db=dl_snr,
            device=dev)

    def _downlink_record(self, rec, dstats) -> float:
        """Set the round's downlink fields on ``rec`` (the reference's
        ``downlink_*``) and return the broadcast's airtime in seconds (each
        distinct mode transmitted once; see ``latency.broadcast_airtime``)."""
        if self.downlink.adaptive:
            air = latency_lib.round_airtime_adaptive(
                dstats, self.timings, self.driver.mode_cfgs)
            total = latency_lib.broadcast_airtime(air, dstats.mode_idx)
        else:
            air = latency_lib.round_airtime(dstats, self.timings,
                                            self.downlink.mode)
            if self.dl_air_scale is not None:
                # Heterogeneous analytic-ECRT downlink: per-client E[tx]
                # rescale, as on the uplink.
                air = air * self.dl_air_scale
            total = latency_lib.broadcast_airtime(air)
        rec.downlink_airtime_s = total
        rec.downlink_ber = float(np.mean(dstats.ber.cpu().numpy()))
        if dstats.mode_idx is not None:
            rec.downlink_mode_counts = np.bincount(
                dstats.mode_idx.cpu().numpy(),
                minlength=len(self.driver.mode_cfgs)).tolist()
        return total

    # ------------------------------------------------------------- uplink

    def _transmit(self, payload, key, rnd, member=None):
        """One round's (or wave's) uplink, without the PS mean: ``(hat,
        agg, stats)`` with ``hat`` the per-client received tree (layered
        and compressed rounds) or ``agg`` the fused aggregate (K1 or K2 on
        a ``use_kernel`` config). ``member`` (a host ``(M,)`` 0/1 tensor,
        ``None`` for the whole cohort) weights a fused wave and keeps
        absent clients' EF residuals; the rows of absent clients are still
        sent and dropped."""
        if self.compression is not None:
            return self._uplink_compressed(payload, key, rnd, member)
        tcfg, dev, drv = self.transport_cfg, self.device, self.driver
        if drv is None:
            if self.fused_aggregate:
                w = (self.uniform_w if member is None
                     else aggregation_lib.normalize_weights(member).to(dev))
                agg, stats = transport_lib.transmit_pytree_batch_aggregate(
                    payload, key, tcfg, w, device=dev)
                return None, agg, stats
            hat, stats = self.algo.wrap_uplink(
                payload, lambda t: transport_lib.transmit_pytree_batch(
                    t, key, tcfg, device=dev))
            return hat, None, stats
        if self.fused_aggregate:
            eff = rnd.active if member is None else member * rnd.active
            w = aggregation_lib.normalize_weights(eff.to(dev))
            agg, stats = \
                transport_lib.transmit_pytree_batch_adaptive_aggregate(
                    payload, key, drv.mode_cfgs, rnd.mode, w,
                    snr_db=rnd.snr_db, device=dev)
            return None, agg, stats
        cfgs = (self.select_cfgs if self.dispatch == "select"
                else drv.mode_cfgs)
        hat, stats = self.algo.wrap_uplink(
            payload, lambda t: transport_lib.transmit_pytree_batch_adaptive(
                t, key, cfgs, rnd.mode, snr_db=rnd.snr_db,
                dispatch=self.dispatch, device=dev))
        return hat, None, stats

    def _aggregate(self, hat, rnd):
        """The sync round's PS mean of a per-client tree: the mean over
        clients driverless, :func:`dropout_weighted_mean` over the active
        clients in scenario rounds."""
        if rnd is None:
            return {k: g.mean(dim=0) for k, g in hat.items()}
        return dropout_weighted_mean(hat, rnd.active.to(self.device))

    # -------------------------------------------------------- compression

    def _init_compression(self):
        """Slot budgets and the EF residual of a compressed run: ``k`` from
        ``resolve_k``; scenario runs get a per-mode table from the policy's
        ``compress_ratios`` (bucketed dispatch only) unless ``k`` is
        explicit; the residual is carried even with ``error_feedback=False``
        (as zeros), as in the reference."""
        comp = self.compression
        self._ef_residual, self._comp_ks = None, None
        self._comp_dim = self._comp_k = 0
        if comp is None:
            return
        self._comp_dim = sum(p.numel() for p in self.params.values())
        self._comp_k = sparsify_lib.resolve_k(comp, self._comp_dim)
        if self.driver is not None:
            from repro_torch.link import policy as policy_lib

            pol = self.driver.scenario.policy
            if comp.k is not None:
                # An explicit budget wins everywhere, so bucketed and
                # select agree on the slots per client.
                self._comp_ks = (self._comp_k,) * len(pol.modes)
            else:
                if (pol.compress_ratios is not None
                        and self.dispatch != "bucketed"):
                    raise ValueError(
                        "PolicyConfig.compress_ratios (per-mode slot "
                        "budgets) needs adaptive_dispatch='bucketed'")
                self._comp_ks = policy_lib.compress_k_table(
                    pol, self._comp_dim, comp.ratio)
        self._ef_residual = torch.zeros(
            (self.num_clients, self._comp_dim), dtype=torch.float32,
            device=self.device)

    def _selection_keys(self, keys):
        """rand-k selection keys: the client transport keys ``(C, 2)`` on
        the selection lane (``None`` for the deterministic methods)."""
        if self.compression.method != "randk":
            return None
        with spans.span("keys"):
            return prng.fold_in(keys, sparsify_lib.SELECT_KEY_LANE)

    def _uplink_compressed(self, payload, key, rnd, member=None):
        """One compressed round's uplink under the run's round shape:
        ``(hat, None, stats)``; updates the EF residual (absent clients'
        rows, ``member`` 0, keep theirs)."""
        comp, algo, dev = self.compression, self.algo, self.device
        leaves, spec = transport_lib.tree_flatten(payload)
        flat, D = transport_lib.pack(leaves, 1)
        M = flat.shape[0]
        old = self._ef_residual
        with spans.span("keys"):
            keys = transport_lib.client_keys(key, M)
        if rnd is None:
            vals, idx, new = sparsify_lib.ef_select_batch(
                old, flat, self._comp_k, comp, self._selection_keys(keys),
                active=member)
            hat_flat, stats = algo.wrap_uplink(
                vals, lambda v: framing_lib.sparse_batch_with_keys(
                    v, idx, D, keys, self.transport_cfg,
                    transport_lib._resolve_batch_snr(
                        self.transport_cfg, M, None, dev), comp))
        else:
            # Select rounds run the table with its kernel rows cleared and
            # one budget for every mode; a row does not depend on the rest
            # of its batch, so both dispatches run each mode on exactly its
            # clients.
            cfgs = (self.select_cfgs if self.dispatch == "select"
                    else self.driver.mode_cfgs)
            eff = rnd.active if member is None else member * rnd.active
            acc = old + flat if comp.error_feedback else flat
            hat_flat, stats, sent = self._sparse_bucketed_uplink(
                acc, keys, rnd, cfgs)
            new = (acc - sent * eff.to(dev)[:, None] if comp.error_feedback
                   else torch.zeros_like(acc))
        if member is not None:
            new = torch.where(member.to(dev)[:, None] > 0, new, old)
        self._ef_residual = new
        hat = transport_lib.tree_unflatten(
            spec, transport_lib.unpack(hat_flat, leaves, 1))
        return hat, None, stats

    def _sparse_bucketed_uplink(self, acc, keys, rnd, cfgs):
        """Per-mode-budget sparse uplink over the round's mode buckets:
        each bucket selects ``k_m`` coordinates of its rows of ``acc``,
        rides ``algorithm.wrap_uplink`` and its row of ``cfgs`` (one K1
        launch per uncoded ``use_kernel`` bucket), and the rows scatter back
        to client order. Returns ``(dense_hat (M, D), stats, sent (M, D))``
        with ``sent`` the transmitter-side scatter that error feedback
        subtracts."""
        comp, algo = self.compression, self.algo
        M, D = acc.shape
        mode_np = rnd.mode.cpu().numpy()
        snr_vec = transport_lib._resolve_batch_snr(cfgs[0], M, rnd.snr_db,
                                                   acc.device)
        order, buckets = transport_lib._buckets(mode_np, len(cfgs))
        parts_x, parts_sent, parts_st = [], [], []
        for m, count, idx in buckets:
            xb, kb, sb = transport_lib._gather_bucket(acc, keys, snr_vec,
                                                      idx, count, count)
            vals, sidx = sparsify_lib.select_batch(
                xb, self._comp_ks[m], comp, self._selection_keys(kb))
            parts_sent.append(sparsify_lib.scatter_dense_batch(vals, sidx, D))
            hat_m, st_m = algo.wrap_uplink(
                vals, lambda v, sidx=sidx, kb=kb, sb=sb, cfg=cfgs[m]: (
                    framing_lib.sparse_batch_with_keys(
                        v, sidx, D, kb, cfg, sb, comp)))
            parts_x.append(hat_m)
            parts_st.append(st_m)
        dense_hat, stats = transport_lib._scatter_bucket_parts(
            parts_x, parts_st, order)
        inv = torch.as_tensor(transport_lib._inverse(order),
                              device=acc.device)
        sent = torch.cat(parts_sent)[inv]
        stats.mode_idx = torch.as_tensor(mode_np, device=acc.device)
        return dense_hat, stats, sent

    def _compression_record(self, rec, stats, rnd) -> None:
        """Set the round's compression fields on ``rec``: the mean kept
        fraction (per-mode budgets through the round's mode vector), the
        active clients' bits on air (float32 numpy reductions, as the
        reference), and the mean per-client L2 norm of the EF residual
        (reduced on the device)."""
        if rnd is not None:
            k_vec = np.asarray(self._comp_ks)[np.asarray(rnd.mode.cpu())]
            active = rnd.active.cpu().numpy()
        else:
            k_vec = np.full(self.num_clients, self._comp_k)
            active = np.ones(self.num_clients, np.float32)
        boa = stats.bits_on_air.cpu().numpy().astype(np.float32)
        res = self._ef_residual
        rec.comp_ratio = float(k_vec.mean() / max(self._comp_dim, 1))
        rec.comp_bits_on_air = float((boa * active).sum())
        rec.comp_residual_norm = float(torch.sqrt(torch.mean(torch.sum(
            res * res, dim=1))))

    # ------------------------------------------------------- observability

    @contextlib.contextmanager
    def _scope(self, name: str):
        """One phase-timer scope; with timers attached it closes after a
        device synchronise, so on CUDA it times the device's work."""
        with self.phase_timers.scope(name):
            yield
            if self.phase_timers is not timers_lib.NULL_TIMERS:
                _sync(self.device)

    def _manifest(self) -> dict:
        """The manifest line of an attached ledger: the reference's keys
        (config fingerprint, the run's shape, config summaries) and the
        provenance block of this device."""
        scen = None if self.driver is None else self.driver.scenario
        man = {
            "fingerprint": ledger_lib.config_fingerprint(
                type(self.algo).__name__, self._raw_transport_cfg, scen,
                self.downlink, self.compression, self.dispatch,
                self.n_rounds, self.num_clients, self.seed),
            "engine": "sync",
            "algorithm": self.algo.name,
            "n_rounds": self.n_rounds,
            "num_clients": self.num_clients,
            "seed": self.seed,
            "eval_every": self.eval_every,
            "dispatch": self.dispatch,
            "transport_mode": self.transport_cfg.mode,
        }
        if scen is not None:
            from repro_torch.link import policy as policy_lib

            man["scenario"] = scen.name
            man["mode_names"] = policy_lib.mode_names(scen.policy)
        if self.downlink is not None:
            man["downlink"] = dataclasses.asdict(self.downlink)
        if self.compression is not None:
            man["compression"] = dataclasses.asdict(self.compression)
        if self.fused_aggregate:
            # Derived again, as the reference, so a layered run keeps the
            # fingerprint it had before fused rounds existed.
            man["fused_aggregate"] = True
            man["fingerprint"] = ledger_lib.config_fingerprint(
                man["fingerprint"], "fused_aggregate")
        man["provenance"] = ledger_lib.provenance(self.device)
        return man

    def _finish_record(self, res, rec, stats) -> None:
        """Close one round's record: the ``uplink_*`` aggregates (with a
        ledger only: a host copy the link view does not need), then the
        record, its link view and its ledger line."""
        if self.ledger is not None:
            for name, value in stats.round_summary().items():
                setattr(rec, name, value)
        res.records.append(rec)
        if rec.has_link_fields():
            res.link.append(rec.to_link_dict())
        if self.ledger is not None:
            self.ledger.write_round(rec)

    def _finish_run(self, res) -> None:
        """The ledger's summary line (with the phase-timer and run-level
        sketch summaries when attached), then close the ledger."""
        if self.ledger is None:
            return
        summary = {
            "final_accuracy": res.final_accuracy,
            "wall_s": res.wall_s,
            "airtime_s": res.airtime_s[-1] if res.airtime_s else 0.0,
            "n_evals": len(res.accuracy),
        }
        phases = self.phase_timers.summary()
        if phases:
            summary["phases"] = phases
        if self.sketcher is not None:
            summary["sketches"] = self.sketcher.summary()
        self.ledger.write_summary(summary)
        self.ledger.close()

    # ---------------------------------------------------------------- run

    def _round_body(self, params, xb, yb, rk, member=None, aggregate=True):
        """One round's (or wave's) work from the link step through the
        uplink: ``(hat, agg, stats, dstats, rnd, phases)``, with ``phases``
        the ``FLResult.phase_s`` entries of those steps (spans; the device
        ones resolved at the phase-end synchronises). ``aggregate`` folds a
        per-client ``hat`` into ``agg`` inside the uplink phase (the sync
        round); ``member`` (a host 0/1 ``(M,)`` tensor) marks a wave's
        clients: the link step observes only them, and only their previous
        estimate and EF residual move."""
        algo, dev, driver = self.algo, self.device, self.driver
        rnd, up_key, recv, dstats = None, rk, None, None
        dparts: dict = {}
        with spans.collect(dev) as body:
            if driver is not None:
                with spans.span("link"):
                    k_link, up_key = prng.split(rk)
                    self.lstate, rnd = driver.round(
                        self.lstate, self.prev_mode, self.prev_est, k_link,
                        observed=member)
                    self.prev_mode = rnd.mode
                    self.prev_est = (rnd.est_db if member is None
                                     else torch.where(member > 0, rnd.est_db,
                                                      self.prev_est))
            if self.downlink is not None:
                with spans.span("downlink", device=True), \
                        spans.collect(dev) as dparts:
                    recv, dstats = self._broadcast(params, up_key, rnd)
                _sync(dev)
            with spans.span("gradients", device=True):
                if self.downlink is None or self._dl_lossless:
                    payload = algo.payload(params, xb, yb)
                else:
                    payload = algo.payload_from(recv, xb, yb)
            _sync(dev)
            with spans.span("uplink", device=True), \
                    spans.collect(dev) as parts:
                hat, agg, stats = self._transmit(payload, up_key, rnd, member)
                if aggregate and agg is None:
                    with spans.span("mean", device=True):
                        agg = self._aggregate(hat, rnd)
            _sync(dev)
        phases = {"link": body["link"]} if driver is not None else {}
        if self.downlink is not None:
            phases["downlink"] = body["downlink"]
            phases.update(_parts("downlink", dparts, DOWNLINK_PARTS))
        phases.update(gradients=body["gradients"], uplink=body["uplink"])
        phases.update(_parts("uplink", parts, UPLINK_PARTS))
        return hat, agg, stats, dstats, rnd, phases

    def _eval_acc(self, params) -> float:
        """Test-set accuracy of ``params``, timed as the span ``eval`` (its
        pair resolves at the read of the result, a synchronise)."""
        with spans.span("eval", device=True):
            acc = cnn.accuracy(params, self.test_x, self.test_y)
        return float(acc)

    def run(self) -> FLResult:
        """Drive ``n_rounds`` rounds and return the :class:`FLResult`."""
        algo, dev = self.algo, self.device
        params, aux, key = self.params, self.aux, self._key
        rng = np.random.default_rng(self.seed)
        res = FLResult([], [], [], 0.0, 0.0)
        t_start = time.perf_counter()
        if self.ledger is not None:
            self.ledger.write_manifest(self._manifest())
        cum_air = 0.0
        driver = self.driver
        for r in range(self.n_rounds):
            before = ac.launch_counts()
            with spans.collect(dev) as top, spans.span("round", id=r):
                with spans.span("key"):
                    key, rk = prng.split(key)
                with self._scope("sample"), spans.span("sample"):
                    xb, yb = algo.sample(rng, self.client_x, self.client_y,
                                         dev)
                with self._scope("round"):
                    _, agg, stats, dstats, rnd, phases = self._round_body(
                        params, xb, yb, rk)
                    with spans.span("apply", device=True):
                        params, aux = algo.apply(params, aux, agg)
                    _sync(dev)
                with self._scope("telemetry"), spans.span("telemetry"):
                    cum_air = self._telemetry(res, r, rk, stats, dstats, rnd,
                                              cum_air)
                if r % self.eval_every == 0 or r == self.n_rounds - 1:
                    with self._scope("eval"):
                        acc = self._eval_acc(params)
                    res.rounds.append(r)
                    res.accuracy.append(acc)
                    res.airtime_s.append(cum_air)
                    if self.ledger is not None:
                        self.ledger.write_eval(r, acc, cum_air)
            phases.update(telemetry=top["telemetry"], apply=top["apply"],
                          eval=top.get("eval", 0.0))
            res.phase_s.append({"key": top["key"], "sample": top["sample"],
                                **phases})
            res.counters.append(launch_deltas(before))
        self.params, self.aux, self._key = params, aux, key
        res.wall_s = time.perf_counter() - t_start
        res.final_accuracy = res.accuracy[-1]
        self._finish_run(res)
        return res

    def _telemetry(self, res, r, rk, stats, dstats, rnd, cum_air) -> float:
        """A sync round's airtime, record, ledger line and sketches; returns
        the cumulative airtime."""
        driver = self.driver
        # TDMA uplink: total airtime is the sum over clients.
        if driver is not None:
            per_client_air = driver.airtime(stats, rnd, self.timings)
            rec = records_lib.scenario_round_record(
                r, rnd, per_client_air, len(driver.mode_cfgs))
        else:
            per_client_air = latency_lib.round_airtime(
                stats, self.timings, self.transport_cfg.mode)
            if self.ecrt_air_scale is not None:
                # Heterogeneous analytic ECRT: rescale each client's
                # airtime from the cohort-mean E[tx] to its own.
                per_client_air = per_client_air * self.ecrt_air_scale
            rec = records_lib.RoundRecord(round=r)
        cum_air += float(torch.sum(per_client_air))
        if self.compression is not None:
            self._compression_record(rec, stats, rnd)
        if dstats is not None:
            cum_air += self._downlink_record(rec, dstats)
        if self.sketcher is not None:
            rec.sketches = self.sketcher.round_group(
                rk, snr_db=rnd.snr_db, est_db=rnd.est_db,
                ber=stats.client_metrics()["ber"],
                airtime_s=per_client_air, mode=rnd.mode,
                active=rnd.active,
                downlink_ber=None if dstats is None else dstats.ber)
        self._finish_record(res, rec, stats)
        return cum_air
