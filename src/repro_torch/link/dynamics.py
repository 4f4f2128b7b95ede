"""Temporally correlated per-client link quality (port).

Counterpart of ``repro.link.dynamics``: per-round, per-client average-SNR
trajectories (dB) built from a frozen per-client offset, a Gauss-Markov
fast track, AR(1) shadowing and a two-state Markov blockage process. The
draws are the reference's, key for key (``core/prng.py``): the uniform
offsets and the Bernoulli blockage are Exact, the normal-derived tracks
agree to the few ULP of ``prng.normal``.

Everything runs on the device of the key or the state it is given; the
FL engine keeps the link step on the host beside its key schedule.

The event layer of the buffered engine (``fl/async_engine.py``):
``client_speed_factors``, ``compute_times``, ``churn_step`` and
``idle_gaps``. Client ``i`` draws from ``fold_in(key, LANE + i)`` on its
own reserved lane (``COMPUTE_KEY_LANE``, ``EVENT_KEY_LANE``,
``EVENT_GAP_KEY_LANE``), so a client's draw does not depend on the cohort
it is drawn with. ``churn_step`` compares uniforms and is Exact; the other
three pass through ``exp``, ``log1p`` or ``erfinv`` and agree with the
reference to a few ULP. Degenerate configs give exactly ``mean_s``,
``1.0`` and ``0.0``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import keylanes
from repro_torch.core import prng

__all__ = [
    "LinkDynamicsConfig",
    "LinkState",
    "DYNAMICS_PRESETS",
    "COMPUTE_KEY_LANE",
    "EVENT_KEY_LANE",
    "EVENT_GAP_KEY_LANE",
    "ComputeTimeConfig",
    "ArrivalConfig",
    "jakes_rho",
    "init_state",
    "step",
    "trajectory",
    "client_speed_factors",
    "compute_times",
    "churn_step",
    "idle_gaps",
]

COMPUTE_KEY_LANE = keylanes.COMPUTE_KEY_LANE
EVENT_KEY_LANE = keylanes.EVENT_KEY_LANE
EVENT_GAP_KEY_LANE = keylanes.EVENT_GAP_KEY_LANE

@dataclasses.dataclass(frozen=True)
class ComputeTimeConfig:
    """Per-client local-computation time model of the buffered engine:
    ``mean_s * speed_i * exp(jitter * z) * straggler`` seconds a wave. The
    synchronous engine ignores it."""

    mean_s: float = 1.0
    speed_spread: float = 0.0
    jitter: float = 0.0
    straggler_prob: float = 0.0
    straggler_factor: float = 10.0


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    """Client availability between waves of the buffered engine: mean
    exponential idle gap and Markov join/leave churn. The synchronous
    engine ignores it."""

    mean_idle_s: float = 0.0
    p_leave: float = 0.0
    p_rejoin: float = 1.0


@dataclasses.dataclass(frozen=True)
class LinkDynamicsConfig:
    """Parameters of the per-client SNR process (dB quantities in dB).

    Stationary SNR, ignoring blockage and clipping: ``N(mean_snr_db +
    offset, fast_std_db^2 + shadow_std_db^2)`` with a per-client ``offset
    ~ U(-spread_db, +spread_db)`` frozen at init.
    """

    mean_snr_db: float = 10.0
    spread_db: float = 0.0
    fast_rho: float = 1.0
    fast_std_db: float = 0.0
    shadow_rho: float = 1.0
    shadow_std_db: float = 0.0
    onoff: bool = False
    p_block: float = 0.0
    p_recover: float = 1.0
    off_penalty_db: float = 18.0
    snr_floor_db: float = -5.0
    snr_ceil_db: float = 40.0


@dataclasses.dataclass
class LinkState:
    """Per-client dynamics state; every field is ``(num_clients,)``
    float32 (``blocked`` is 0/1)."""

    offset_db: torch.Tensor
    fast_db: torch.Tensor
    shadow_db: torch.Tensor
    blocked: torch.Tensor


def jakes_rho(doppler_hz: float, round_interval_s: float) -> float:
    """Round-to-round fading correlation ``J0(2 pi f_d T)`` (Jakes/Clarke),
    by the Abramowitz & Stegun 9.4.1/9.4.3 polynomials, clipped to
    ``[0, 1]``; plain Python floats, as the reference."""
    x = abs(2.0 * math.pi * doppler_hz * round_interval_s)
    if x <= 3.0:
        t = (x / 3.0) ** 2
        j0 = (1.0 + t * (-2.2499997 + t * (1.2656208 + t * (-0.3163866
              + t * (0.0444479 + t * (-0.0039444 + t * 0.0002100))))))
    else:
        t = 3.0 / x
        f0 = (0.79788456 + t * (-0.00000077 + t * (-0.00552740
              + t * (-0.00009512 + t * (0.00137237 + t * (-0.00072805
              + t * 0.00014476))))))
        th = (x - 0.78539816 + t * (-0.04166397 + t * (-0.00003954
              + t * (0.00262573 + t * (-0.00054125 + t * (-0.00029333
              + t * 0.00013558))))))
        j0 = f0 * math.cos(th) / math.sqrt(x)
    return min(max(j0, 0.0), 1.0)


def _stationary_blocked_prob(cfg: LinkDynamicsConfig) -> float:
    if not cfg.onoff:
        return 0.0
    denom = cfg.p_block + cfg.p_recover
    return cfg.p_block / denom if denom > 0 else 0.0


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def init_state(key: torch.Tensor, num_clients: int,
               cfg: LinkDynamicsConfig) -> LinkState:
    """Draw the stationary initial state for ``num_clients`` links, on the
    key's device."""
    k_off, k_fast, k_shadow, k_block = prng.split(key, 4)
    shape = (num_clients,)
    offset = prng.uniform(k_off, shape, -cfg.spread_db, cfg.spread_db)
    fast = prng.normal(k_fast, shape) * _f32(cfg.fast_std_db, key)
    shadow = prng.normal(k_shadow, shape) * _f32(cfg.shadow_std_db, key)
    blocked = prng.bernoulli(k_block, _stationary_blocked_prob(cfg),
                             shape).to(torch.float32)
    return LinkState(offset, fast, shadow, blocked)


def _ar1(x: torch.Tensor, key: torch.Tensor, rho: float,
         std: float) -> torch.Tensor:
    """One Gauss-Markov step preserving the stationary std."""
    innov = math.sqrt(max(1.0 - rho * rho, 0.0)) * std
    return (_f32(rho, x) * x
            + _f32(innov, x) * prng.normal(key, tuple(x.shape)))


def step(state: LinkState, key: torch.Tensor,
         cfg: LinkDynamicsConfig) -> tuple[LinkState, torch.Tensor]:
    """Advance one FL round: ``(new_state, snr_db (num_clients,))``, the
    true average link quality this round, clipped to the configured
    floor and ceiling."""
    k_fast, k_shadow, k_block = prng.split(key, 3)
    fast = _ar1(state.fast_db, k_fast, cfg.fast_rho, cfg.fast_std_db)
    shadow = _ar1(state.shadow_db, k_shadow, cfg.shadow_rho,
                  cfg.shadow_std_db)
    if cfg.onoff:
        u = prng.uniform(k_block, tuple(state.blocked.shape))
        was = state.blocked > 0.5
        blocked = torch.where(was, u >= _f32(cfg.p_recover, u),
                              u < _f32(cfg.p_block, u)).to(torch.float32)
    else:
        blocked = torch.zeros_like(state.blocked)
    new = LinkState(state.offset_db, fast, shadow, blocked)
    snr = (_f32(cfg.mean_snr_db, fast) + state.offset_db + fast + shadow
           - _f32(cfg.off_penalty_db, fast) * blocked)
    return new, torch.clamp(snr, _f32(cfg.snr_floor_db, snr),
                            _f32(cfg.snr_ceil_db, snr))


def trajectory(key: torch.Tensor, cfg: LinkDynamicsConfig, num_clients: int,
               n_rounds: int) -> torch.Tensor:
    """Full ``(n_rounds, num_clients)`` SNR trajectory: ``key -> (init,
    rounds)``, round ``r`` stepping with ``split(rounds key, n_rounds)[r]``."""
    k_init, k_scan = prng.split(key)
    state = init_state(k_init, num_clients, cfg)
    snrs = []
    for kr in prng.split(k_scan, n_rounds):
        state, snr = step(state, kr, cfg)
        snrs.append(snr)
    return torch.stack(snrs) if snrs else torch.zeros(
        (0, num_clients), dtype=torch.float32, device=key.device)


def _lane_keys(key: torch.Tensor, lane: keylanes.Lane,
               num_clients: int) -> torch.Tensor:
    """``(num_clients, 2)`` keys ``fold_in(key, lane + i)``."""
    keylanes.check_cohort(lane, num_clients)
    idx = torch.arange(num_clients, dtype=torch.int64, device=key.device)
    return prng.fold_in(key, idx + int(lane))


def client_speed_factors(key: torch.Tensor, num_clients: int,
                         cfg: ComputeTimeConfig) -> torch.Tensor:
    """Frozen per-client lognormal speed multipliers ``exp(speed_spread *
    z)``, ``(num_clients,)``. Callers pass ``fold_in(run_key,
    COMPUTE_KEY_LANE)``, which consumes no split; ``speed_spread = 0``
    gives exactly 1.0 (``exp(+-0.0)``)."""
    z = prng.normal(_lane_keys(key, COMPUTE_KEY_LANE, num_clients), ())
    return torch.exp(_f32(cfg.speed_spread, z) * z)


def compute_times(key: torch.Tensor, cfg: ComputeTimeConfig,
                  num_clients: int, speed=None) -> torch.Tensor:
    """Per-(wave, client) local-computation seconds, ``(num_clients,)``:
    client ``i`` splits ``fold_in(key, COMPUTE_KEY_LANE + i)`` into ``(kz,
    ku)``, draws a normal from ``kz`` and a uniform from ``ku``, and takes
    ``mean_s * exp(jitter * z) * slow`` (``slow`` the straggler factor
    where ``u < straggler_prob``), then ``* speed``. The default config
    gives exactly ``mean_s``."""
    kz, ku = prng.split_batched(
        _lane_keys(key, COMPUTE_KEY_LANE, num_clients))
    z, u = prng.normal(kz, ()), prng.uniform(ku, ())
    slow = torch.where(u < _f32(cfg.straggler_prob, u),
                       _f32(cfg.straggler_factor, u), _f32(1.0, u))
    t = _f32(cfg.mean_s, z) * torch.exp(_f32(cfg.jitter, z) * z) * slow
    if speed is not None:
        t = t * torch.as_tensor(speed, dtype=torch.float32).to(t.device)
    return t


def churn_step(key: torch.Tensor, joined, cfg: ArrivalConfig) -> torch.Tensor:
    """One dispatch attempt's join/leave update, ``(num_clients,)`` 0/1
    float32: a joined client stays while ``u >= p_leave``, an absent one
    rejoins where ``u < p_rejoin``, with ``u`` from ``fold_in(key,
    EVENT_KEY_LANE + i)``."""
    joined = torch.as_tensor(joined).to(key.device)
    u = prng.uniform(_lane_keys(key, EVENT_KEY_LANE, int(joined.shape[0])),
                     ())
    return torch.where(joined > 0, u >= _f32(cfg.p_leave, u),
                       u < _f32(cfg.p_rejoin, u)).to(torch.float32)


def idle_gaps(key: torch.Tensor, num_clients: int,
              cfg: ArrivalConfig) -> torch.Tensor:
    """Per-client exponential post-upload idle gaps in seconds,
    ``(num_clients,)``, from ``fold_in(key, EVENT_GAP_KEY_LANE + i)``;
    ``mean_idle_s = 0`` gives exactly 0.0."""
    g = prng.exponential(_lane_keys(key, EVENT_GAP_KEY_LANE, num_clients),
                         ())
    return g * _f32(cfg.mean_idle_s, g)


# Named mobility profiles (round interval ~1 s assumed for the rho values).
DYNAMICS_PRESETS: dict[str, LinkDynamicsConfig] = {
    "static": LinkDynamicsConfig(mean_snr_db=10.0),
    "pedestrian": LinkDynamicsConfig(
        mean_snr_db=12.0, spread_db=4.0,
        fast_rho=0.9, fast_std_db=2.5,
        shadow_rho=0.98, shadow_std_db=3.0),
    "vehicular": LinkDynamicsConfig(
        mean_snr_db=10.0, spread_db=6.0,
        fast_rho=0.35, fast_std_db=5.0,
        shadow_rho=0.9, shadow_std_db=4.0),
    "shadowed-urban": LinkDynamicsConfig(
        mean_snr_db=9.0, spread_db=3.0,
        fast_rho=0.95, fast_std_db=1.5,
        shadow_rho=0.995, shadow_std_db=7.0),
    "bursty": LinkDynamicsConfig(
        mean_snr_db=14.0, spread_db=3.0,
        fast_rho=0.8, fast_std_db=2.0,
        onoff=True, p_block=0.08, p_recover=0.35, off_penalty_db=18.0),
    "iot-lowrate": LinkDynamicsConfig(
        mean_snr_db=6.0, spread_db=2.0,
        fast_rho=0.9, fast_std_db=1.5,
        shadow_rho=0.98, shadow_std_db=2.0,
        onoff=True, p_block=0.05, p_recover=0.5, off_penalty_db=12.0),
}
