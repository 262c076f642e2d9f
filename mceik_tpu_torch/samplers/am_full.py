"""Full-covariance adaptive Metropolis (Haario et al. 2001) with a pooled
cross-chain covariance, and dual-averaging step tuning.

Counterpart of ``mceik_tpu/samplers/am_full.py``, with the chain axis
written out: the proposal works on the flattened parameter vector,
``(C, d)`` for C chains, and one kernel call advances every chain with one
batched logpost. The Cholesky factor of the pooled covariance is taken once
per step for all chains. Frozen coordinates (prior scale 0) keep zero
proposal variance.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from mceik_tpu_torch.io.trace import device_tensor
from mceik_tpu_torch.samplers.base import MHState
from mceik_tpu_torch.samplers.hmc import DualAveraging, dual_averaging_update
from mceik_tpu_torch.utils import tree_leaves, tree_map, tree_where


@dataclasses.dataclass
class AMFullHyper:
    log_step: torch.Tensor
    count: torch.Tensor        # pooled sample count
    mean: torch.Tensor         # (d,) running mean
    m2: torch.Tensor           # (d, d) running scatter (sum of outer products)
    scales_flat: torch.Tensor  # (d,) prior scales; 0 marks frozen coords
    reg: torch.Tensor
    da: DualAveraging          # dual-averaging state for the step tuner


def _ravel(params: Any, batch_dims: int = 0) -> torch.Tensor:
    """Concatenate the leaves, flattened after ``batch_dims`` leading axes:
    ``(d,)``, or ``(C, d)`` with ``batch_dims=1``."""
    leaves = tree_leaves(params)
    lead = tuple(leaves[0].shape[:batch_dims])
    return torch.cat([x.reshape(lead + (-1,)) for x in leaves], dim=-1)


def _unravel_fn(example: Any, batch_dims: int = 0) -> Callable:
    """Inverse of :func:`_ravel` for trees shaped like ``example`` (whose
    first ``batch_dims`` axes are dropped): maps ``(..., d)`` to a tree with
    the same leading axes."""
    shapes = [tuple(x.shape[batch_dims:]) for x in tree_leaves(example)]
    sizes = [math.prod(s) for s in shapes]

    def unravel(v: torch.Tensor):
        lead = tuple(v.shape[:-1])
        parts = iter(x.reshape(lead + s)
                     for x, s in zip(torch.split(v, sizes, dim=-1), shapes))
        return tree_map(lambda _: next(parts), example)

    return unravel


def _scalar(x: float, device) -> torch.Tensor:
    return device_tensor(x, torch.float32, device)


# Haario regularization of the pooled covariance, relative to the prior
# scales.
REG = 1e-6


def init_hyper(scales: Any, step_size: float) -> AMFullHyper:
    """``scales``: per-leaf prior scales, a tree like one chain's params;
    0 marks a frozen coordinate."""
    sf = _ravel(scales).to(torch.float32)
    d, dev = sf.shape[0], sf.device
    log_eps = _scalar(math.log(step_size), dev)
    return AMFullHyper(
        log_step=log_eps.clone(),
        count=_scalar(0.0, dev),
        mean=torch.zeros(d, dtype=torch.float32, device=dev),
        m2=torch.zeros((d, d), dtype=torch.float32, device=dev),
        scales_flat=sf,
        reg=_scalar(REG, dev),
        da=DualAveraging(mu=log_eps.clone(), log_eps=log_eps.clone(),
                         log_eps_bar=log_eps.clone(), h_bar=_scalar(0.0, dev)),
    )


def _pooled_cov(hyper: AMFullHyper) -> torch.Tensor:
    """The regularized pooled covariance with frozen rows/columns masked
    (prior scales until the accumulator holds more than 2d samples), plus a
    unit diagonal at frozen coordinates so that a Cholesky succeeds."""
    d = hyper.scales_flat.shape[0]
    n = hyper.count
    ready = n > 2.0 * d
    active = (hyper.scales_flat > 0).to(torch.float32)
    cov = hyper.m2 / torch.clamp(n - 1.0, min=1.0)
    floor = (hyper.reg + 1e-4) * hyper.scales_flat ** 2
    cov = cov * active[:, None] * active[None, :] + torch.diag(floor)
    prior_cov = torch.diag(hyper.scales_flat ** 2)
    cov = torch.where(ready, cov, prior_cov)
    return cov + torch.diag(1.0 - active)


def _proposal_chol(hyper: AMFullHyper) -> torch.Tensor:
    """Cholesky of the pooled covariance with frozen columns zeroed (no
    proposal component there)."""
    active = (hyper.scales_flat > 0).to(torch.float32)
    L = torch.linalg.cholesky(_pooled_cov(hyper))
    return L * active[None, :] * active[:, None]


def make_kernel(logpost_fn: Callable) -> Callable:
    """AM-full transition over all chains: ``(state, hyper, normal,
    uniform) -> (state, info)``; ``normal`` is a tree like the params,
    ``uniform`` is ``(C,)``."""

    def kernel(state: MHState, hyper: AMFullHyper, normal: Any,
               uniform: torch.Tensor):
        unravel = _unravel_fn(state.params, batch_dims=1)
        x = _ravel(state.params, batch_dims=1)
        d_active = (hyper.scales_flat > 0).to(torch.float32).sum()
        step = torch.exp(hyper.log_step) * 2.38 / torch.sqrt(
            torch.clamp(d_active, min=1.0))
        L = _proposal_chol(hyper)
        eps = _ravel(normal, batch_dims=1)
        prop = unravel(x + step * (eps @ L.T))
        lp = logpost_fn(prop)
        log_ratio = lp - state.logpost
        accept_prob = torch.exp(torch.clamp(log_ratio, max=0.0))
        accept = torch.log(uniform) < log_ratio
        new_params = tree_where(accept, prop, state.params)
        new_lp = torch.where(accept, lp, state.logpost)
        info = {"accept_prob": accept_prob,
                "accepted": accept.to(torch.float32)}
        return MHState(params=new_params, logpost=new_lp), info

    return kernel


def welford_merge_positions(hyper: AMFullHyper, params: Any) -> AMFullHyper:
    """Batch Welford merge of every chain's position into the pooled
    full-covariance accumulator."""
    X = _ravel(params, batch_dims=1)                  # (C, d)
    C = X.shape[0]
    n0, mean0, m20 = hyper.count, hyper.mean, hyper.m2
    bmean = X.mean(0)
    Xc = X - bmean[None, :]
    bm2 = Xc.T @ Xc
    n = n0 + C
    delta = bmean - mean0
    mean = mean0 + delta * (C / torch.clamp(n, min=1.0))
    m2 = m20 + bm2 + torch.outer(delta, delta) * (n0 * C / torch.clamp(n, min=1.0))
    return dataclasses.replace(hyper, count=n, mean=mean, m2=m2)


def make_adapter(target_accept: float = 0.234) -> Callable:
    """Warmup adapter: dual-averaging step tuner plus the pooled
    full-covariance Welford."""

    def adapt(hyper: AMFullHyper, pooled, states: MHState, t):
        da = dual_averaging_update(hyper.da, pooled["accept_prob"], t,
                                   target=target_accept, gamma=0.1, t0=20.0)
        hyper = welford_merge_positions(hyper, states.params)
        return dataclasses.replace(hyper, log_step=da.log_eps, da=da)

    return adapt


def finalize(hyper: AMFullHyper) -> AMFullHyper:
    """Post-warmup: freeze the step at the dual-averaged iterate."""
    return dataclasses.replace(hyper, log_step=hyper.da.log_eps_bar)
