"""Dual-averaging step-size tuner (Hoffman & Gelman 2014).

Counterpart of the tuner in ``mceik_tpu/samplers/hmc.py``; adaptive
Metropolis, full-covariance AM and MALA use it with gamma 0.1 and t0 20.
HMC itself is slice 4 of the port.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class DualAveraging:
    mu: torch.Tensor
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor


def dual_averaging_update(da: DualAveraging, accept_prob: torch.Tensor, t,
                          target: float = 0.8, gamma: float = 0.05,
                          t0: float = 10.0,
                          kappa: float = 0.75) -> DualAveraging:
    """One update from the pooled acceptance at warmup step ``t`` (0-based)."""
    tt = torch.as_tensor(t, dtype=torch.float32, device=da.h_bar.device) + 1.0
    eta = 1.0 / (tt + t0)
    h_bar = (1.0 - eta) * da.h_bar + eta * (target - accept_prob)
    log_eps = da.mu - torch.sqrt(tt) / gamma * h_bar
    w = tt ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * da.log_eps_bar
    return dataclasses.replace(da, log_eps=log_eps, log_eps_bar=log_eps_bar,
                               h_bar=h_bar)
