"""Preconditioned Metropolis-adjusted Langevin (MALA) with a full
covariance as preconditioner.

Counterpart of ``mceik_tpu/samplers/mala.py``, with the chain axis written
out. Proposal, with ``C = L L^T`` the pooled (or pinned Laplace) covariance
and ``eps`` the adapted step:

    y = x + (eps^2 / 2) C grad(x) + eps L xi,   xi ~ N(0, I)

and the exact MH correction, computed in the whitened space so that no
triangular solve is needed: with ``a = L^T grad(x)`` and
``a_y = L^T grad(y)`` the reverse residual is ``-xi - eps/2 (a + a_y)``.
The gradient at the current point is cached in the state, so a step pays
one batched ``value_and_grad``: one forward solve and one transport solve
of ``C x n_src`` fields. The Cholesky factor is taken once per step for
all chains. A non-finite log-ratio (a NaN gradient from a diverged
transport solve, say) is a rejection.

Frozen coordinates (prior scale 0): their gradient and noise components
are masked to zero, and the covariance gets a unit diagonal there, so they
never move.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from mceik_tpu_torch.io.trace import host_sync
from mceik_tpu_torch.model.posterior import value_and_grad
from mceik_tpu_torch.samplers.am_full import (AMFullHyper, _pooled_cov,
                                              _ravel, _unravel_fn,
                                              welford_merge_positions)
# MALA's accumulator is full-covariance AM's; its log_step is log(eps)
# itself (no 2.38/sqrt(d) scaling).
from mceik_tpu_torch.samplers.am_full import init_hyper  # noqa: F401
from mceik_tpu_torch.samplers.hmc import dual_averaging_update
from mceik_tpu_torch.utils import tree_where

# Effective count cap of the adapting covariance (the burn-in flushes).
MEM_SAMPLES = 5000.0
# Sample count a pinned covariance is primed with: adaptation then only
# retunes the step.
N_PRIME = 1e6


@dataclasses.dataclass
class MALAState:
    """MH chain state plus the cached gradient at the current point (every
    leaf with a leading chain axis)."""

    params: Any
    logpost: torch.Tensor
    grad: Any            # tree like params


def init_states(logpost_fn: Callable, init_params_fn: Callable,
                gen: torch.Generator, n_chains: int) -> MALAState:
    """Draw the chains' starts and evaluate their gradients (``logpost_fn``
    built with ``differentiable=True``)."""
    params = init_params_fn(gen, n_chains)
    logpost, grad = value_and_grad(logpost_fn)(params)
    return MALAState(params=params, logpost=logpost, grad=grad)


def from_mh_states(logpost_fn: Callable, states) -> MALAState:
    """Lift plain MHState chains into MALA states by evaluating gradients."""
    logpost, grad = value_and_grad(logpost_fn)(states.params)
    return MALAState(params=states.params, logpost=logpost, grad=grad)


def _chol_unmasked(hyper: AMFullHyper) -> torch.Tensor:
    """Cholesky of the pooled covariance with a UNIT diagonal at frozen
    coordinates (full-covariance AM zeroes those columns instead; MALA's
    whitened algebra needs L invertible)."""
    host_sync()   # the factor's check of its result
    return torch.linalg.cholesky(_pooled_cov(hyper))


def make_kernel(logpost_fn: Callable) -> Callable:
    """MALA transition over all chains: ``(state, hyper, normal, uniform) ->
    (state, info)``; ``normal`` is a tree like the params, ``uniform``
    ``(C,)``."""
    vag = value_and_grad(logpost_fn)

    def kernel(state: MALAState, hyper: AMFullHyper, normal: Any,
               uniform: torch.Tensor):
        unravel = _unravel_fn(state.params, batch_dims=1)
        x = _ravel(state.params, batch_dims=1)                  # (C, d)
        active = hyper.scales_flat > 0
        g = torch.where(active, _ravel(state.grad, batch_dims=1), 0.0)
        eps = torch.exp(hyper.log_step)
        L = _chol_unmasked(hyper)

        a = g @ L                                               # rows L^T g
        xi = torch.where(active, _ravel(normal, batch_dims=1), 0.0)
        y = x + (0.5 * eps * eps * a + eps * xi) @ L.T

        prop = unravel(y)
        lp_y, grad_y = vag(prop)
        ay = torch.where(active, _ravel(grad_y, batch_dims=1), 0.0) @ L

        # Whitened reverse residual: no solve.
        z = xi + 0.5 * eps * (a + ay)
        log_ratio = (lp_y - state.logpost
                     + 0.5 * (xi * xi).sum(1) - 0.5 * (z * z).sum(1))
        log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio,
                                torch.full_like(log_ratio, -float("inf")))
        accept_prob = torch.exp(torch.clamp(log_ratio, max=0.0))
        accept = torch.log(uniform) < log_ratio

        new_state = MALAState(
            params=tree_where(accept, prop, state.params),
            logpost=torch.where(accept, lp_y, state.logpost),
            grad=tree_where(accept, grad_y, state.grad))
        info = {"accept_prob": accept_prob,
                "accepted": accept.to(torch.float32),
                "divergent": (log_ratio < -1000.0).to(torch.float32)}
        return new_state, info

    return kernel


def make_adapter(target_accept: float = 0.574,
                 adapt_cov: bool = True) -> Callable:
    """Warmup adapter: dual-averaging step tuner toward the Langevin-optimal
    acceptance, plus the pooled full-covariance Welford with its effective
    count capped at ``MEM_SAMPLES`` (the burn-in transient flushes).

    ``adapt_cov=False`` tunes only the step: required when the covariance
    was pinned by :func:`prime_covariance` (the Laplace preconditioner),
    which the forgetting cap would otherwise crush on the first step."""

    def adapt(hyper: AMFullHyper, pooled, states: MALAState, t):
        da = dual_averaging_update(hyper.da, pooled["accept_prob"], t,
                                   target=target_accept, gamma=0.1, t0=20.0)
        hyper = dataclasses.replace(hyper, log_step=da.log_eps, da=da)
        if not adapt_cov:
            return hyper
        hyper = welford_merge_positions(hyper, states.params)
        f = torch.clamp(MEM_SAMPLES / torch.clamp(hyper.count, min=1.0),
                        max=1.0)
        return dataclasses.replace(hyper, count=hyper.count * f,
                                   m2=hyper.m2 * f)

    return adapt


def finalize(hyper: AMFullHyper) -> AMFullHyper:
    """Post-warmup: freeze the step at the dual-averaged iterate."""
    return dataclasses.replace(hyper, log_step=hyper.da.log_eps_bar)


def prime_covariance(hyper: AMFullHyper, cov: torch.Tensor) -> AMFullHyper:
    """Pin a covariance (the Laplace fit) as the preconditioner; adaptation
    can then only retune the global step."""
    dev = hyper.m2.device
    cov = torch.as_tensor(cov, dtype=torch.float32, device=dev)
    return dataclasses.replace(
        hyper, count=torch.tensor(N_PRIME, dtype=torch.float32, device=dev),
        m2=(N_PRIME - 1.0) * cov)
