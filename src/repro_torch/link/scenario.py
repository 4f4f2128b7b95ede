"""End-to-end link scenarios: dynamics + CSI + policy + availability (port).

Counterpart of ``repro.link.scenario``. A :class:`Scenario` bundles how
per-client SNR evolves (``link.dynamics``), how noisily the PS observes it
(``link.estimator``), how the mode policy reacts (``link.policy``) and
which clients drop out or straggle; :class:`ScenarioDriver` binds one to a
base transport config. The registry holds the reference's eleven presets,
field for field.

The driver's ``init`` and ``round`` run on the device of the key they are
given. The FL engine gives them its host-side round key: a round's link
step is about a hundred elements (dynamics, the gamma rejection loop,
policy, Bernoullis), and the bucketed dispatch needs the mode vector on
the host anyway, so only the SNR (as kernel noise powers) and the
``active`` weights cross to the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.compress.sparsify import CompressionConfig
from repro_torch.core import latency as latency_lib
from repro_torch.core import prng
from repro_torch.core import transport as transport_lib
from repro_torch.link import dynamics as dynamics_lib
from repro_torch.link import estimator as estimator_lib
from repro_torch.link import policy as policy_lib

__all__ = [
    "DownlinkConfig",
    "Scenario",
    "LinkRound",
    "ScenarioDriver",
    "SCENARIOS",
    "get_scenario",
    "register_scenario",
    "list_scenarios",
]


@dataclasses.dataclass(frozen=True)
class DownlinkConfig:
    """The broadcast leg of an FL round (Qu et al., arXiv:2310.16652):
    ``mode`` (``"perfect"`` or a transport mode), ``modulation`` (``None``
    inherits the uplink's), ``snr_offset_db`` (downlink SNR = uplink SNR +
    offset) and ``adaptive`` (per-client mode from the scenario's policy
    at the shifted CSI; scenario runs only)."""

    mode: str = "approx"
    modulation: str | None = None
    snr_offset_db: float = 0.0
    adaptive: bool = False


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, fully specified link environment for an FL run.

    ``dropout_prob``: per-round probability that a client is absent (no
    airtime, no weight in the aggregate). ``straggler_prob`` /
    ``straggler_slowdown``: clients whose uplink takes ``slowdown`` times
    its airtime. ``ecrt_expected_tx = None`` calibrates E[tx] with the real
    LDPC chain and interpolates airtime per client over an SNR grid; a
    float prices with that constant. ``downlink`` and ``compression`` are
    the run's defaults for those legs; ``compute`` and ``arrival`` are the
    buffered engine's event layer, which the synchronous engine ignores.
    """

    name: str
    dynamics: dynamics_lib.LinkDynamicsConfig
    estimator: estimator_lib.EstimatorConfig = estimator_lib.EstimatorConfig()
    policy: policy_lib.PolicyConfig = policy_lib.PolicyConfig()
    dropout_prob: float = 0.0
    straggler_prob: float = 0.0
    straggler_slowdown: float = 3.0
    ecrt_expected_tx: float | None = None
    downlink: DownlinkConfig | None = None
    compression: CompressionConfig | None = None
    compute: dynamics_lib.ComputeTimeConfig | None = None
    arrival: dynamics_lib.ArrivalConfig | None = None
    description: str = ""


@dataclasses.dataclass
class LinkRound:
    """One round's link telemetry; every field is ``(num_clients,)``:
    ``snr_db`` the truth that drives the channel, ``est_db`` what the
    policy saw, ``mode`` the int32 table index, ``active`` and
    ``straggler`` 0/1 float32."""

    snr_db: torch.Tensor
    est_db: torch.Tensor
    mode: torch.Tensor
    active: torch.Tensor
    straggler: torch.Tensor


class ScenarioDriver:
    """A scenario bound to a transport config: the FL engine's link step.

    Construction resolves the mode table (``policy.build_mode_cfgs``,
    calibrating ECRT's E[tx] on ``device`` when the scenario asks for it).
    :meth:`round` advances dynamics, estimates CSI, runs the policy and
    draws availability. With calibrated ECRT, :meth:`airtime` rescales each
    ECRT client's airtime from the anchor constant to E[tx] interpolated at
    its SNR that round, over a small calibrated curve built on first use.
    """

    def __init__(self, scenario: Scenario,
                 base_cfg: transport_lib.TransportConfig,
                 *, calib_codewords: int = policy_lib.DEFAULT_CALIB_CODEWORDS,
                 calib_max_tx: int = policy_lib.DEFAULT_CALIB_MAX_TX,
                 calib_grid_points: int = 3, device=None):
        self.scenario = scenario
        self.device = device
        self._calib = (calib_codewords, calib_max_tx, calib_grid_points)
        self._ecrt_curve = None
        ecrt_mods = {mod for m, mod in scenario.policy.modes if m == "ecrt"}
        # One interpolation curve serves one ECRT constellation; tables
        # with several keep their per-row calibrated constants.
        self._interp_ecrt_airtime = (len(ecrt_mods) == 1) and (
            scenario.ecrt_expected_tx is None)
        self.mode_cfgs = policy_lib.build_mode_cfgs(
            base_cfg, scenario.policy,
            ecrt_expected_tx=scenario.ecrt_expected_tx,
            calib_codewords=calib_codewords, calib_max_tx=calib_max_tx,
            anchor_fallback_db=scenario.dynamics.mean_snr_db, device=device)
        self._ecrt_rows = tuple(
            i for i, c in enumerate(self.mode_cfgs) if c.mode == "ecrt")

    def _ecrt_modulation(self) -> str:
        return next(mod for m, mod in self.scenario.policy.modes
                    if m == "ecrt")

    def _ecrt_tx_curve(self):
        """Calibrated ``(grid_db, E[tx])`` over ECRT's operating band, from
        the dynamics' SNR floor to the first threshold plus the hysteresis
        (the whole dynamics range for a threshold-less table), with at
        least one point per 12 dB and the anchor on the grid; cached."""
        if self._ecrt_curve is None:
            scen = self.scenario
            codewords, max_tx, points = self._calib
            thr = scen.policy.thresholds_db
            lo = scen.dynamics.snr_floor_db
            hi = (thr[0] + scen.policy.hysteresis_db) if thr \
                else scen.dynamics.snr_ceil_db
            hi = max(hi, lo + 1.0)
            points = max(points, int(np.ceil((hi - lo) / 12.0)) + 1)
            anchor = policy_lib.ecrt_anchor_snr_db(
                scen.policy, scen.dynamics.mean_snr_db)
            grid = np.unique(np.concatenate(
                [np.linspace(lo, hi, points), [anchor]]))
            self._ecrt_curve = latency_lib.ecrt_expected_tx_curve(
                grid, self._ecrt_modulation(), n_codewords=codewords,
                max_tx=max_tx, device=self.device)
        return self._ecrt_curve

    def init(self, key: torch.Tensor, num_clients: int):
        """``(state, round-0 modes, round-0 CSI)``: the stationary link
        state, the hysteresis-free modes of each client's static operating
        point (mean SNR + frozen offset), and that operating point as the
        first "previous estimate"."""
        state = dynamics_lib.init_state(key, num_clients,
                                        self.scenario.dynamics)
        op_point = (torch.tensor(self.scenario.dynamics.mean_snr_db,
                                 dtype=torch.float32, device=key.device)
                    + state.offset_db)
        mode0 = policy_lib.initial_mode(op_point, self.scenario.policy)
        return state, mode0, op_point

    def round(self, state: dynamics_lib.LinkState, prev_mode, prev_est_db,
              key: torch.Tensor, observed=None):
        """One link round: ``key -> (dynamics, estimator, dropout,
        stragglers)``; returns ``(new state, LinkRound)``. ``observed``
        (0/1 per client) keeps unobserved clients at their previous
        mode."""
        scen = self.scenario
        k_dyn, k_est, k_drop, k_strag = prng.split(key, 4)
        state, snr = dynamics_lib.step(state, k_dyn, scen.dynamics)
        est = estimator_lib.step_estimate(snr, prev_est_db, k_est,
                                          scen.estimator)
        mode = policy_lib.choose_mode(est, prev_mode, scen.policy,
                                      observed=observed)
        shape = tuple(snr.shape)
        active = prng.bernoulli(k_drop, 1.0 - scen.dropout_prob,
                                shape).to(torch.float32)
        straggler = prng.bernoulli(k_strag, scen.straggler_prob,
                                   shape).to(torch.float32)
        return state, LinkRound(snr, est, mode, active, straggler)

    def airtime(self, stats: transport_lib.TxStats, rnd: LinkRound,
                timings: latency_lib.PhyTimings) -> torch.Tensor:
        """Per-client airtime of the round, ``(num_clients,)`` seconds on
        the stats' device: mode-priced (``round_airtime_adaptive``),
        straggler-scaled, zero for dropped clients; with calibrated ECRT,
        each ECRT client's symbols and transmissions rescaled by its
        interpolated E[tx] over the anchor constant."""
        dev = stats.data_symbols.device
        mode_idx = None if stats.mode_idx is None else stats.mode_idx.to(
            device=dev, dtype=torch.int64)
        if (self._interp_ecrt_airtime and self._ecrt_rows
                and mode_idx is not None):
            grid, vals = self._ecrt_tx_curve()
            e_tx = latency_lib.interp_expected_tx(rnd.snr_db.to(dev), grid,
                                                  vals)
            anchor = torch.tensor(
                [c.ecrt_expected_tx for c in self.mode_cfgs],
                dtype=torch.float32, device=dev)[mode_idx]
            is_ecrt = (mode_idx[:, None] == torch.tensor(
                self._ecrt_rows, device=dev)).any(dim=-1)
            floor = torch.tensor(1e-6, dtype=torch.float32, device=dev)
            ratio = torch.where(is_ecrt, e_tx / torch.maximum(anchor, floor),
                                torch.ones_like(e_tx))
            stats = transport_lib.TxStats(
                stats.data_symbols * ratio, stats.transmissions * ratio,
                stats.bit_errors, stats.n_bits, stats.mode_idx,
                bits_on_air=None if stats.bits_on_air is None
                else stats.bits_on_air * ratio)
        air = latency_lib.round_airtime_adaptive(stats, timings,
                                                 self.mode_cfgs)
        slowdown = 1.0 + (self.scenario.straggler_slowdown - 1.0) \
            * rnd.straggler.to(dev)
        return air * slowdown * rnd.active.to(dev)


SCENARIOS: dict[str, Scenario] = {}


def register_scenario(scenario: Scenario) -> Scenario:
    """Add (or replace) a scenario in the registry; returns it."""
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    """Look up a registered scenario; unknown names list what exists."""
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: "
            f"{', '.join(sorted(SCENARIOS))}"
        ) from None


def list_scenarios() -> list[str]:
    """Registered scenario names, sorted."""
    return sorted(SCENARIOS)


def _preset(name: str, **kw) -> Scenario:
    return register_scenario(Scenario(
        name=name, dynamics=dynamics_lib.DYNAMICS_PRESETS[kw.pop("dyn", name)],
        **kw))


_preset("static",
        description="the paper's setup: one SNR, all clients, whole run")
_preset("pedestrian",
        description="walking users: slow fading drift + moderate shadowing")
_preset("vehicular",
        description="driving users: fast fading, wide per-client spread")
_preset("shadowed-urban",
        description="urban canyon: slowly-decorrelating deep shadowing")
_preset("bursty",
        description="IoT links: good on average with Markov blockage spells")
_preset("iot-flaky", dyn="bursty",
        estimator=estimator_lib.EstimatorConfig(n_pilots=16, stale_prob=0.2),
        dropout_prob=0.1, straggler_prob=0.1, straggler_slowdown=3.0,
        description="bursty links + few pilots, stale CSI, dropout, stragglers")
_preset("vehicular-noisy-dl", dyn="vehicular",
        downlink=DownlinkConfig(mode="approx", snr_offset_db=3.0,
                                adaptive=True),
        description="vehicular links with a noisy adaptive broadcast "
                    "downlink 3 dB above the uplink (per-client mode via "
                    "the policy table)")
_preset("static-noisy-dl", dyn="static",
        downlink=DownlinkConfig(mode="approx", snr_offset_db=0.0),
        description="the paper's static setup plus a matched-SNR uncoded "
                    "broadcast downlink (the Qu et al. error-budget axis)")
_preset("iot-lowrate",
        estimator=estimator_lib.EstimatorConfig(n_pilots=16),
        policy=policy_lib.PolicyConfig(
            compress_ratios=(0.01, 0.02, 0.05, 0.10)),
        dropout_prob=0.05,
        compression=CompressionConfig(method="topk", ratio=0.02),
        description="narrowband low-SNR IoT links; top-k+EF sparse uplinks "
                    "on by default, compressed deepest in the protected "
                    "low-SNR modes (CSI-adaptive ratio column)")
_preset("metro-rush", dyn="vehicular",
        dropout_prob=0.05, straggler_prob=0.10, straggler_slowdown=3.0,
        compute=dynamics_lib.ComputeTimeConfig(
            mean_s=0.5, speed_spread=0.4, jitter=0.3,
            straggler_prob=0.15, straggler_factor=20.0),
        arrival=dynamics_lib.ArrivalConfig(mean_idle_s=0.25),
        description="rush-hour metro cell: vehicular links, heavy-tailed "
                    "compute stragglers (20x spells), Poisson re-arrival "
                    "gaps — the buffered engine's home turf")
_preset("global-churn", dyn="shadowed-urban",
        dropout_prob=0.05,
        compute=dynamics_lib.ComputeTimeConfig(
            mean_s=1.0, speed_spread=0.5, jitter=0.2,
            straggler_prob=0.05, straggler_factor=8.0),
        arrival=dynamics_lib.ArrivalConfig(
            mean_idle_s=1.0, p_leave=0.10, p_rejoin=0.30),
        description="planet-scale cohort: urban-canyon shadowing with "
                    "clients leaving and rejoining between waves (EF "
                    "residuals and hysteresis state must survive the gaps)")
