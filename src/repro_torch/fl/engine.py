"""FL round engine (port, part): FedSGD rounds over the wireless uplink.

Counterpart of ``repro.fl.engine`` for :class:`RoundEngine` with the
:class:`FedSGD` algorithm. Driverless runs (no ``scenario=``) are the
paper's own experiment, in both of its round shapes:

* **layered** (``fused_aggregate=False``): per-client gradients ->
  ``transport.transmit_pytree_batch`` (one K1 launch on the kernel path,
  the layered PHY or the ECRT model otherwise) -> mean over clients -> SGD
  step;
* **fused** (``fused_aggregate=True``): per-client gradients ->
  ``transport.transmit_pytree_batch_aggregate`` with uniform normalized
  weights (one K2 launch on the kernel path) -> SGD step.

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

The per-client airtime is the driver's (mode-priced, straggler-scaled,
zero for dropped clients), and ``FLResult.link`` holds the reference's
per-round telemetry dicts. A scenario that brings its own downlink or
compression raises ``NotImplementedError`` (ROADMAP Queue 1, items 5 and
6): running it without them would be another experiment.

ECRT with ``simulate_fec=True`` is priced, not decoded, in rounds, as in
the reference: :func:`resolve_ecrt_analytic` calibrates E[tx] once with
the real LDPC chain and swaps in the analytic model; a heterogeneous-SNR
cohort also gets a per-client airtime scale.

The key schedule is the reference's: ``key -> (key, params key)`` at
start, then (scenario runs) ``key -> (key, link-init key)``, then ``key ->
(key, round key)`` each round, and inside a scenario round ``round key ->
(link key, uplink key)``; minibatches come from
``numpy.random.default_rng(seed)`` exactly as in the reference.

Each round is timed in phases — gradients, uplink, apply, eval — on the
host clock after a device synchronise (``FLResult.phase_s``), so the
numbers are device time for the phase, not enqueue time. The uplink also
reports two of its parts, timed as spans (``repro_torch.obs.spans``):
``uplink_keys``, the per-client key schedule and kernel seeds, and
``uplink_kernel``, the K1/K2 launches (or their plain versions on the
CPU; 0 on the layered PHY and ECRT, which launch no kernel). Scenario
rounds add ``link``, the link step on the host.

The round key stays on the CPU, so the key schedule (a few hundred int64
ops on ``num_clients`` elements) and the link step run on the host and
only the seeds, the SNRs and the ``active`` weights cross to the device:
each op costs less there than a launch on the GPU (measured by
``chip_smoke.py``, phases 5d and 6; see PERF.md). ``prng`` follows
its key's device, so moving the key moves the schedule; the layered PHY
moves the client keys to the payload's device, where it draws per symbol.

Not ported yet (raise ``NotImplementedError`` naming the ROADMAP item):
``downlink=``, ``compression=``, ``ledger=``, ``phase_timers=`` and
``sketches=``; ``FedAvg`` and the asynchronous engine; the typed
``RoundRecord`` view of ``FLResult.link`` (item 8).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch import resolve_device
from repro_torch.core import aggregation as aggregation_lib
from repro_torch.core import latency as latency_lib
from repro_torch.core import prng
from repro_torch.core import transport as transport_lib
from repro_torch.fl import cnn
from repro_torch.obs import spans
from repro_torch.optim.sgd import sgd as make_sgd

__all__ = ["FLResult", "FedSGD", "RoundEngine", "resolve_ecrt_analytic",
           "resolve_scenario", "select_mode_cfgs", "dropout_weighted_mean",
           "link_telemetry"]

_NOT_PORTED = {
    "downlink": "ROADMAP Queue 1, item 5 'FedAvg and the downlink'",
    "compression": "ROADMAP Queue 1, item 6 'compress/'",
    "ledger": "ROADMAP Queue 1, item 8 'obs/'",
    "phase_timers": "ROADMAP Queue 1, item 8 'obs/'",
    "sketches": "ROADMAP Queue 1, item 8 'obs/'",
}


@dataclasses.dataclass
class FLResult:
    """Outcome of one FL run."""

    rounds: list
    accuracy: list
    airtime_s: list  # cumulative airtime: TDMA uplink sum over clients
    wall_s: float
    final_accuracy: float
    # One dict per round: seconds spent in "gradients", "uplink", "apply"
    # and "eval" (0.0 on rounds without an eval), each closed by a device
    # synchronise; "uplink_keys" and "uplink_kernel" are parts of "uplink";
    # scenario rounds add "link", the host-side link step.
    phase_s: list = dataclasses.field(default_factory=list)
    # Scenario runs: one dict per round, {round, mean_snr_db, mean_est_db,
    # mode_counts, n_active, n_stragglers, airtime_s} (mode_counts indexes
    # the driver's mode table). [] otherwise.
    link: list = dataclasses.field(default_factory=list)


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


def link_telemetry(r: int, rnd, per_client_air, n_modes: int) -> dict:
    """One ``FLResult.link`` record from a round's ``LinkRound`` and
    airtime; numpy reductions as the reference's."""
    def host(t):
        return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)

    mode = host(rnd.mode)
    return {
        "round": r,
        "mean_snr_db": float(np.mean(host(rnd.snr_db))),
        "mean_est_db": float(np.mean(host(rnd.est_db))),
        "mode_counts": np.bincount(mode, minlength=n_modes).tolist(),
        "n_active": int(host(rnd.active).sum()),
        "n_stragglers": int(host(rnd.straggler).sum()),
        "airtime_s": float(host(per_client_air).sum()),
    }


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
        self._client_grads = vmap(grad(cnn.loss_fn), in_dims=(None, 0, 0))

    def init_params(self, key, device=None):
        """Global model at round 0."""
        return cnn.init_params(key, self.cfg, device)

    def init_opt(self, params):
        """Optimizer state threaded through the rounds."""
        return self.opt.init(params)

    def sample(self, rng, client_x, client_y, device=None):
        """One round's per-client minibatches ``(M, B, ...)`` on ``device``,
        drawn with the reference's numpy calls."""
        M = client_x.shape[0]
        take = rng.integers(0, client_x.shape[1], (M, self.batch_per_round))
        xb = np.take_along_axis(client_x, take[:, :, None, None], axis=1)
        yb = np.take_along_axis(client_y, take, axis=1)
        return (torch.from_numpy(np.ascontiguousarray(xb)).to(device),
                torch.from_numpy(yb.astype(np.int64)).to(device))

    def payload(self, params, xb, yb):
        """Per-client gradients of the global model: leaves ``(M, ...)``."""
        return self._client_grads(params, xb, yb)

    def apply(self, params, opt_state, agg):
        """PS update (eq. (6)): one optimizer step on the aggregate."""
        return self.opt.update(agg, opt_state, params)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class RoundEngine:
    """FL round driver: driverless (the paper's static single-mode uplink)
    or scenario-driven (per-client link adaptation).

    Args mirror the reference's ``RoundEngine``; ``device`` picks where the
    model, gradients and uplink run (``None`` is the GPU). The arguments of
    parts not ported yet must stay at their defaults.
    """

    def __init__(self, algorithm, transport_cfg, client_x, client_y,
                 test_x, test_y, *, n_rounds: int, seed: int = 0,
                 eval_every: int = 2,
                 timings: latency_lib.PhyTimings | None = None,
                 scenario=None, adaptive_dispatch: str = "bucketed",
                 downlink=None, compression=None,
                 fused_aggregate: bool = False, ledger=None,
                 phase_timers=None, sketches=None, device=None):
        given = dict(downlink=downlink, compression=compression,
                     ledger=ledger, phase_timers=phase_timers,
                     sketches=sketches)
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"{name}= is not ported yet: {_NOT_PORTED[name]}")
        if not isinstance(algorithm, FedSGD):
            raise NotImplementedError(
                "only FedSGD is ported: FedAvg is ROADMAP Queue 1, item 5 "
                "'FedAvg and the downlink'")
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
        if self.driver is not None:
            scen = self.driver.scenario
            for name in ("downlink", "compression"):
                if getattr(scen, name) is not None:
                    raise NotImplementedError(
                        f"scenario {scen.name!r} brings its own {name}, "
                        f"which is not ported yet: {_NOT_PORTED[name]}")
            if self.fused_aggregate and self.dispatch != "bucketed":
                raise ValueError(
                    "fused_aggregate=True needs adaptive_dispatch="
                    "'bucketed' for scenario runs: the select dispatch has "
                    "no kernel rows to fuse into")
            self.select_cfgs = select_mode_cfgs(self.driver)
            self.ecrt_air_scale = None
        else:
            transport_cfg, self.ecrt_air_scale = resolve_ecrt_analytic(
                transport_cfg, self.num_clients, self.device)
        self.transport_cfg = transport_cfg
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
        if self.driver is not None:
            key, lk = prng.split(key)
            self.lstate, self.prev_mode, self.prev_est = self.driver.init(
                lk, self.num_clients)
        self._key = key

    def _uplink(self, payload, key):
        """One round's uplink + aggregation: ``(aggregate tree, stats)``."""
        tcfg = self.transport_cfg
        if self.fused_aggregate:
            return transport_lib.transmit_pytree_batch_aggregate(
                payload, key, tcfg, self.uniform_w, device=self.device)
        hat, stats = transport_lib.transmit_pytree_batch(
            payload, key, tcfg, device=self.device)
        return {k: g.mean(dim=0) for k, g in hat.items()}, stats

    def _uplink_scenario(self, payload, key, rnd):
        """One scenario round's mixed-mode uplink + aggregation under the
        engine's dispatch: ``(aggregate tree, stats)``."""
        dev, drv = self.device, self.driver
        active = rnd.active.to(dev)
        if self.dispatch == "select":
            hat, stats = transport_lib.transmit_pytree_batch_adaptive(
                payload, key, self.select_cfgs, rnd.mode, snr_db=rnd.snr_db,
                dispatch="select", device=dev)
            return dropout_weighted_mean(hat, active), stats
        if self.fused_aggregate:
            return transport_lib.transmit_pytree_batch_adaptive_aggregate(
                payload, key, drv.mode_cfgs, rnd.mode,
                aggregation_lib.normalize_weights(active), snr_db=rnd.snr_db,
                device=dev)
        hat, stats = transport_lib.transmit_pytree_batch_adaptive(
            payload, key, drv.mode_cfgs, rnd.mode, snr_db=rnd.snr_db,
            dispatch="bucketed", device=dev)
        return dropout_weighted_mean(hat, active), stats

    def run(self) -> FLResult:
        """Drive ``n_rounds`` rounds and return the :class:`FLResult`."""
        algo, dev = self.algo, self.device
        params, aux, key = self.params, self.aux, self._key
        rng = np.random.default_rng(self.seed)
        res = FLResult([], [], [], 0.0, 0.0)
        t_start = time.perf_counter()
        cum_air = 0.0
        driver = self.driver
        for r in range(self.n_rounds):
            key, rk = prng.split(key)
            xb, yb = algo.sample(rng, self.client_x, self.client_y, dev)
            phases = {}
            if driver is not None:
                t_link = time.perf_counter()
                k_link, k_tx = prng.split(rk)
                self.lstate, rnd = driver.round(
                    self.lstate, self.prev_mode, self.prev_est, k_link)
                self.prev_mode, self.prev_est = rnd.mode, rnd.est_db
                phases["link"] = time.perf_counter() - t_link
            t0 = time.perf_counter()
            payload = algo.payload(params, xb, yb)
            _sync(dev)
            t1 = time.perf_counter()
            with spans.collect(dev) as parts:
                if driver is None:
                    agg, stats = self._uplink(payload, rk)
                else:
                    agg, stats = self._uplink_scenario(payload, k_tx, rnd)
            _sync(dev)
            t2 = time.perf_counter()
            params, aux = algo.apply(params, aux, agg)
            _sync(dev)
            t3 = time.perf_counter()
            phases.update(gradients=t1 - t0, uplink=t2 - t1,
                          uplink_keys=parts.get("keys", 0.0),
                          uplink_kernel=parts.get("kernel", 0.0),
                          apply=t3 - t2, eval=0.0)
            # TDMA uplink: total airtime is the sum over clients.
            if driver is not None:
                per_client_air = driver.airtime(stats, rnd, self.timings)
                res.link.append(link_telemetry(r, rnd, per_client_air,
                                               len(driver.mode_cfgs)))
            else:
                per_client_air = latency_lib.round_airtime(
                    stats, self.timings, self.transport_cfg.mode)
                if self.ecrt_air_scale is not None:
                    # Heterogeneous analytic ECRT: rescale each client's
                    # airtime from the cohort-mean E[tx] to its own value.
                    per_client_air = per_client_air * self.ecrt_air_scale
            cum_air += float(torch.sum(per_client_air))
            if r % self.eval_every == 0 or r == self.n_rounds - 1:
                t4 = time.perf_counter()
                acc = float(cnn.accuracy(params, self.test_x, self.test_y))
                phases["eval"] = time.perf_counter() - t4
                res.rounds.append(r)
                res.accuracy.append(acc)
                res.airtime_s.append(cum_air)
            res.phase_s.append(phases)
        self.params, self.aux, self._key = params, aux, key
        res.wall_s = time.perf_counter() - t_start
        res.final_accuracy = res.accuracy[-1]
        return res
