"""The paper's FL simulation: FedSGD over a noisy wireless uplink (port).

One round (paper Sec. II):
  1. every client computes a single-step gradient on its local shard (4)
  2. the stacked (M, D) gradients go through the batched uplink — M
     independent fading channels: the layered PHY, or with
     ``use_kernel=True`` one K1 launch (one K2 launch with
     ``fused_aggregate=True``, which also aggregates); ECRT is priced by
     its calibrated analytic model
  3. the PS aggregates (5) and updates the global model (6)
  4. airtime for the round = the TDMA sum of the clients' uplinks

The paper's Fig. 3 compares three arms at one SNR: ``approx`` and
``naive`` on the layered PHY, and ``ecrt`` (``simulate_fec=True``, which
the engine resolves to the calibrated analytic model). With
``scenario=`` each round first moves every client's SNR, estimates it
and picks each client's mode (ECRT / approx QPSK / 16-QAM / 256-QAM) with
dropouts and stragglers; the uplink then runs per mode bucket. With
``downlink=`` (or a scenario that brings one) each round first broadcasts
the global model through every client's own downlink (one K1 launch on a
``use_kernel`` config) and each client computes its gradient at its
received copy.

Counterpart of ``repro.fl.loop.run_fl``: a thin façade over
:class:`~repro_torch.fl.engine.RoundEngine` with :class:`FedSGD`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import latency as latency_lib
from repro_torch.core import transport as transport_lib
from repro_torch.fl import engine as engine_lib
from repro_torch.fl.engine import FLResult

__all__ = ["FLResult", "run_fl"]


def run_fl(
    cfg,
    transport_cfg: transport_lib.TransportConfig,
    client_x: np.ndarray,  # (M, n, 28, 28)
    client_y: np.ndarray,  # (M, n)
    test_x: np.ndarray,
    test_y: np.ndarray,
    n_rounds: int = 40,
    batch_per_round: int = 32,
    seed: int = 0,
    eval_every: int = 2,
    timings: latency_lib.PhyTimings | None = None,
    scenario=None,
    adaptive_dispatch: str = "bucketed",
    downlink=None,
    compression=None,
    fused_aggregate: bool = False,
    ledger=None,
    phase_timers=None,
    sketches=None,
    device=None,
) -> FLResult:
    """FedSGD over the simulated wireless uplink (paper Sec. II eq. (4)-(6)).

    Args mirror the reference's ``run_fl``:
      cfg: CNN model/optimizer config (``configs.mnist_cnn``).
      transport_cfg: uplink transport (``perfect``, ``naive``, ``approx``
        or ``ecrt``).
      client_x / client_y: stacked per-client shards, ``(M, n, ...)``.
      test_x / test_y: held-out eval set (accuracy every ``eval_every``).
      n_rounds / batch_per_round / seed: round count, per-round minibatch
        size, and the seed driving params/keys/batch sampling.
      timings: PHY timing model for airtime pricing.
      scenario: ``None`` for the paper's static single-mode uplink, else a
        scenario name, ``Scenario`` or ``ScenarioDriver``: per-round link
        adaptation, with telemetry in ``FLResult.records`` and
        ``FLResult.link``. A scenario that brings compression (or a
        downlink) runs it.
      adaptive_dispatch: ``"bucketed"`` (one batch per mode bucket, one
        K1/K2 launch per uncoded bucket on ``use_kernel`` tables) or
        ``"select"`` (kernel rows cleared; layered PHY).
      downlink: ``None`` (error-free downlink) or a ``DownlinkConfig``:
        the broadcast leg at the top of each round; ``adaptive=True``
        needs a scenario. Overrides a scenario's own downlink.
      compression: ``None`` (dense uplinks) or a ``CompressionConfig``:
        sparse uplinks with error feedback and a protected index header.
        Overrides a scenario's own compression.
      fused_aggregate: fold the PS aggregation into the uplink (K2);
        scenario runs need the bucketed dispatch for it.
      ledger: ``None``, a path or a ``repro_torch.obs.RunLedger``: the
        run's JSONL ledger in the reference's format (manifest, one line a
        round and an eval, summary), readable by ``tools/report.py``.
      phase_timers: ``None`` or a ``repro_torch.obs.PhaseTimers``: the
        ``sample`` / ``round`` / ``telemetry`` / ``eval`` scopes, each
        closed after a device synchronise on CUDA.
      sketches: ``None``, ``True``, a layout dict or a
        ``repro_torch.obs.RoundSketcher``: per-round per-client
        distribution sketches in ``FLResult.records`` (and the ledger);
        needs a scenario (``ValueError`` otherwise).
      device: where to run; ``None`` is the GPU.

    The three sinks are observers: the run's numbers are bit for bit those
    of the same run without them.

    Returns:
      :class:`~repro_torch.fl.engine.FLResult`.
    """
    algo = engine_lib.FedSGD(cfg, batch_per_round=batch_per_round)
    return engine_lib.RoundEngine(
        algo, transport_cfg, client_x, client_y, test_x, test_y,
        n_rounds=n_rounds, seed=seed, eval_every=eval_every, timings=timings,
        scenario=scenario, adaptive_dispatch=adaptive_dispatch,
        downlink=downlink, compression=compression,
        fused_aggregate=fused_aggregate, ledger=ledger,
        phase_timers=phase_timers, sketches=sketches, device=device,
    ).run()
