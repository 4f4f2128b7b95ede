"""FedAvg over the simulated wireless uplink (port; beyond-paper extension).

The paper evaluates FedSGD (one gradient per round). FedAvg transmits the
weight delta after ``local_steps`` local SGD steps instead; deltas stay
bounded (|delta| <= eta * sum|g| over the steps), so the same exponent
clamp applies, optionally after a per-client scale (``scale_mode``):

  ``none``     transmit raw deltas (the paper's prior |delta| < 2)
  ``max_abs``  scale by ``0.9 / max|delta|`` before transmission and undo
               it at the PS; the scalar travels on the error-free control
               channel.

Counterpart of ``repro.fl.fedavg.run_fedavg``: a thin façade over
:class:`~repro_torch.fl.engine.RoundEngine` with
:class:`~repro_torch.fl.engine.FedAvg`, so scenarios, both dispatches,
ECRT pricing, the downlink leg, airtime and telemetry are the engine's.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import latency as latency_lib
from repro_torch.core import transport as transport_lib
from repro_torch.fl import engine as engine_lib
from repro_torch.fl.engine import FLResult

__all__ = ["FLResult", "run_fedavg"]


def run_fedavg(
    cfg,
    transport_cfg: transport_lib.TransportConfig,
    client_x: np.ndarray,
    client_y: np.ndarray,
    test_x: np.ndarray,
    test_y: np.ndarray,
    n_rounds: int = 30,
    local_steps: int = 4,
    batch_per_step: int = 32,
    scale_mode: str = "none",  # "none" | "max_abs"
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
    """FedAvg over the simulated uplink: ``local_steps`` SGD steps per
    client per round, weight deltas on the wire.

    Arguments as :func:`repro_torch.fl.loop.run_fl`'s, plus the local
    schedule (``local_steps``, ``batch_per_step``) and ``scale_mode``.
    ``fused_aggregate=True`` needs ``scale_mode="none"`` (the ``max_abs``
    descale runs between demap and aggregate; ``ValueError`` otherwise).
    ``device`` is where to run (``None`` is the GPU). ``compression``
    selects sparse uplinks; ``ledger`` (a path or a ``RunLedger``),
    ``phase_timers`` (a ``PhaseTimers``) and ``sketches`` (``True``, a
    layout dict or a ``RoundSketcher``; needs a scenario) attach the
    observability sinks, which change no number of the run.
    """
    algo = engine_lib.FedAvg(cfg, local_steps=local_steps,
                             batch_per_step=batch_per_step,
                             scale_mode=scale_mode)
    return engine_lib.RoundEngine(
        algo, transport_cfg, client_x, client_y, test_x, test_y,
        n_rounds=n_rounds, seed=seed, eval_every=eval_every, timings=timings,
        scenario=scenario, adaptive_dispatch=adaptive_dispatch,
        downlink=downlink, compression=compression,
        fused_aggregate=fused_aggregate, ledger=ledger,
        phase_timers=phase_timers, sketches=sketches, device=device,
    ).run()
