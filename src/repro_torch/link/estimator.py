"""Pilot-based SNR estimation: the policy acts on noisy CSI (port).

Counterpart of ``repro.link.estimator``. With ``N_p`` coherent pilots the
method-of-moments noise-power estimate is ``sigma^2 * G`` with ``G ~
Gamma(N_p, 1/N_p)``; ``G`` is drawn directly (``prng.gamma``), so the
estimate in dB is ``snr_db - 10 log10(G) + bias_db``. ``stale_prob`` is
the chance that a client's report this round is last round's estimate
(``prng.bernoulli``, Exact against the reference). ``n_pilots = 0`` is the
oracle.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng

__all__ = ["EstimatorConfig", "estimate_snr_db", "step_estimate"]


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Pilot/CSI quality knobs; ``n_pilots = 0`` returns the true SNR."""

    n_pilots: int = 64
    bias_db: float = 0.0
    stale_prob: float = 0.0


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def estimate_snr_db(true_snr_db, key: torch.Tensor,
                    cfg: EstimatorConfig) -> torch.Tensor:
    """One fresh per-client estimate, shaped like ``true_snr_db``, on the
    key's device. ``log10`` is ``log(x) / log(10)`` in float32, as
    ``jnp.log10`` computes it."""
    snr = torch.as_tensor(true_snr_db, dtype=torch.float32).to(key.device)
    if cfg.n_pilots <= 0:
        return snr + _f32(cfg.bias_db, snr)
    n_p = _f32(float(cfg.n_pilots), snr)
    g = prng.gamma(key, float(cfg.n_pilots), tuple(snr.shape)) / n_p
    log10_g = (torch.log(torch.maximum(g, _f32(1e-12, g)))
               / torch.log(_f32(10.0, g)))
    return snr - _f32(10.0, g) * log10_g + _f32(cfg.bias_db, g)


def step_estimate(true_snr_db, prev_est_db, key: torch.Tensor,
                  cfg: EstimatorConfig) -> torch.Tensor:
    """Fresh estimate with per-client staleness: stale links reuse
    ``prev_est_db``. Returns the ``(num_clients,)`` CSI the policy sees
    (also the next round's ``prev_est_db``)."""
    k_est, k_stale = prng.split(key)
    fresh = estimate_snr_db(true_snr_db, k_est, cfg)
    if cfg.stale_prob <= 0.0:
        return fresh
    stale = prng.bernoulli(k_stale, cfg.stale_prob, tuple(fresh.shape))
    prev = torch.as_tensor(prev_est_db, dtype=torch.float32).to(fresh.device)
    return torch.where(stale, prev, fresh)
