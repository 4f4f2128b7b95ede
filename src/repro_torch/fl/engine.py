"""FL round engine (port, part): FedSGD rounds over the wireless uplink.

Counterpart of ``repro.fl.engine`` for the driverless path of
:class:`RoundEngine` with the :class:`FedSGD` algorithm — the paper's own
experiment — in both of its round shapes:

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

ECRT with ``simulate_fec=True`` is priced, not decoded, in rounds, as in
the reference: :func:`resolve_ecrt_analytic` calibrates E[tx] once with
the real LDPC chain and swaps in the analytic model; a heterogeneous-SNR
cohort also gets a per-client airtime scale.

The key schedule is the reference's: ``key -> (key, params key)`` at
start, then ``key -> (key, round key)`` each round; minibatches come from
``numpy.random.default_rng(seed)`` exactly as in the reference.

Each round is timed in phases — gradients, uplink, apply, eval — on the
host clock after a device synchronise (``FLResult.phase_s``), so the
numbers are device time for the phase, not enqueue time. The uplink also
reports two of its parts, timed as spans (``repro_torch.obs.spans``):
``uplink_keys``, the per-client key schedule and kernel seeds, and
``uplink_kernel``, the K1/K2 launch (or its plain version on the CPU; 0 on
the layered PHY and ECRT, which launch no kernel).

The round key stays on the CPU, so the key schedule (a few hundred int64
ops on ``num_clients`` elements) runs on the host and only the seeds
cross to the device: each op costs less there than a launch on the GPU
(measured by ``chip_smoke.py``, phase 6; see PERF.md). ``prng`` follows
its key's device, so moving the key moves the schedule; the layered PHY
moves the client keys to the payload's device, where it draws per symbol.

Not ported yet (raise ``NotImplementedError`` naming the ROADMAP item):
``scenario=``, ``downlink=``, ``compression=``, ``ledger=``,
``phase_timers=`` and ``sketches=``; ``FedAvg`` and the asynchronous
engine.
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

__all__ = ["FLResult", "FedSGD", "RoundEngine", "resolve_ecrt_analytic"]

_NOT_PORTED = {
    "scenario": "ROADMAP Queue 1, item 4 'Link adaptation'",
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
    # synchronise; "uplink_keys" and "uplink_kernel" are parts of "uplink".
    phase_s: list = dataclasses.field(default_factory=list)


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
    """Driverless FL round driver (the paper's static single-mode uplink).

    Args mirror the reference's ``RoundEngine``; ``device`` picks where the
    model, gradients and uplink run (``None`` is the GPU). The arguments of
    parts not ported yet must stay at their defaults; ``adaptive_dispatch``,
    which only shapes ``scenario=`` rounds, comes with ``scenario=``.
    """

    def __init__(self, algorithm, transport_cfg, client_x, client_y,
                 test_x, test_y, *, n_rounds: int, seed: int = 0,
                 eval_every: int = 2,
                 timings: latency_lib.PhyTimings | None = None,
                 scenario=None, downlink=None, compression=None,
                 fused_aggregate: bool = False, ledger=None,
                 phase_timers=None, sketches=None, device=None):
        given = dict(scenario=scenario, downlink=downlink,
                     compression=compression, ledger=ledger,
                     phase_timers=phase_timers, sketches=sketches)
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"{name}= is not ported yet: {_NOT_PORTED[name]}")
        if not isinstance(algorithm, FedSGD):
            raise NotImplementedError(
                "only FedSGD is ported: FedAvg is ROADMAP Queue 1, item 5 "
                "'FedAvg and the downlink'")
        transport_lib._check_mode(transport_cfg)
        self.device = resolve_device(device)
        self.algo = algorithm
        self.num_clients = client_x.shape[0]
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
        self.fused_aggregate = bool(fused_aggregate)
        # Uniform cohort weights, normalized once (the reference's
        # build-time constant of the fused round).
        self.uniform_w = aggregation_lib.normalize_weights(
            torch.ones((self.num_clients,), dtype=torch.float32)).to(
                self.device)

        key = prng.PRNGKey(seed)
        key, pk = prng.split(key)
        self.params = algorithm.init_params(pk, self.device)
        self.aux = algorithm.init_opt(self.params)
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

    def run(self) -> FLResult:
        """Drive ``n_rounds`` rounds and return the :class:`FLResult`."""
        algo, dev = self.algo, self.device
        params, aux, key = self.params, self.aux, self._key
        rng = np.random.default_rng(self.seed)
        res = FLResult([], [], [], 0.0, 0.0)
        t_start = time.perf_counter()
        cum_air = 0.0
        for r in range(self.n_rounds):
            key, rk = prng.split(key)
            xb, yb = algo.sample(rng, self.client_x, self.client_y, dev)
            phases = {}
            t0 = time.perf_counter()
            payload = algo.payload(params, xb, yb)
            _sync(dev)
            t1 = time.perf_counter()
            with spans.collect(dev) as parts:
                agg, stats = self._uplink(payload, rk)
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
