"""Hamiltonian Monte Carlo with a dual-averaging step size and a diagonal
mass matrix adapted from pooled position moments.

Counterpart of ``mceik_tpu/samplers/hmc.py``, with the chain axis written
out: one kernel call advances every chain, and each leapfrog step is ONE
batched ``value_and_grad`` for all C chains (one forward solve and one
transport solve of the whole batch). Every chain takes its own jittered
step size. The NUTS kernel (``samplers/nuts.py``) shares this module's
hyper, adapter and finalize. The dual-averaging tuner here is also the one
am, am_full, mala and pcn use (with gamma 0.1 and t0 20).

A kernel takes its draws as tensors (``draw`` below gives them from a
``torch.Generator``), so a test can replay the JAX package's: the momentum
normals (a tree like the params), one acceptance uniform and one step
jitter uniform per chain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from mceik_tpu_torch.diag.moments import Welford, welford_init, welford_update_batch
from mceik_tpu_torch.io.trace import device_tensor
from mceik_tpu_torch.model.posterior import value_and_grad
from mceik_tpu_torch.samplers.base import MHState
from mceik_tpu_torch.utils import (per_chain, tree_axpy, tree_dot, tree_leaves,
                                   tree_map, tree_mul, tree_random_normal,
                                   tree_where)


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
    tt = device_tensor(t, torch.float32, da.h_bar.device) + 1.0
    eta = 1.0 / (tt + t0)
    h_bar = (1.0 - eta) * da.h_bar + eta * (target - accept_prob)
    log_eps = da.mu - torch.sqrt(tt) / gamma * h_bar
    w = tt ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * da.log_eps_bar
    return dataclasses.replace(da, log_eps=log_eps, log_eps_bar=log_eps_bar,
                               h_bar=h_bar)


@dataclasses.dataclass
class HMCHyper:
    da: DualAveraging
    inv_mass: Any        # diagonal inverse mass, a tree like one chain's params
    welford: Welford     # pooled position moments -> mass adaptation
    scales: Any          # prior scales (the mass until the Welford is ready)


def init_hyper(scales: Any, step_size: float, example_params: Any) -> HMCHyper:
    """``scales`` and ``example_params`` have no chain axis. The inverse
    mass starts at ``scales**2``; dual averaging pulls toward
    ``log(10 * step_size)``."""
    dev = tree_leaves(scales)[0].device
    log_eps = torch.tensor(math.log(step_size), dtype=torch.float32,
                           device=dev)
    da = DualAveraging(mu=math.log(10.0) + log_eps, log_eps=log_eps.clone(),
                       log_eps_bar=log_eps.clone(),
                       h_bar=torch.tensor(0.0, dtype=torch.float32,
                                          device=dev))
    return HMCHyper(da=da, inv_mass=tree_map(lambda s: s * s, scales),
                    welford=welford_init(example_params), scales=scales)


def kinetic(p: Any, inv_mass: Any) -> torch.Tensor:
    """Per-chain kinetic energy ``0.5 p^T M^-1 p``: ``(C,)``."""
    return 0.5 * tree_dot(p, tree_mul(inv_mass, p))


def momentum(normal: Any, inv_mass: Any) -> Any:
    """``p ~ N(0, M)`` with ``M = diag(1 / inv_mass)`` from standard
    normals: ``p = xi / sqrt(inv_mass)``."""
    return tree_map(lambda x, mi: x * torch.rsqrt(torch.clamp(mi, min=1e-12)),
                    normal, inv_mass)


def leapfrog(value_and_grad: Callable, q: Any, p: Any, eps: torch.Tensor,
             inv_mass: Any, n_steps: int):
    """``n_steps`` of leapfrog with one step size per chain (``eps``:
    ``(C,)``); returns ``(q, p, logpost(q), grad(q))``. The gradient at the
    start is evaluated afresh, as the reference does."""
    lp, g = value_and_grad(q)
    for _ in range(n_steps):
        p = tree_axpy(0.5 * eps, g, p)
        q = tree_map(lambda qi, pi, mi: qi + per_chain(eps, qi) * mi * pi,
                     q, p, inv_mass)
        lp, g = value_and_grad(q)
        p = tree_axpy(0.5 * eps, g, p)
    return q, p, lp, g


def make_kernel(logpost_fn: Callable, n_leapfrog: int,
                jitter: float = 0.2) -> Callable:
    """HMC transition over all chains: ``(state, hyper, normal, u_accept,
    u_jitter) -> (state, info)``. ``jitter`` randomizes each chain's step
    by U(1 - jitter, 1 + jitter). ``logpost_fn`` is built with
    ``differentiable=True``."""
    vag = value_and_grad(logpost_fn)

    def kernel(state: MHState, hyper: HMCHyper, normal: Any,
               u_accept: torch.Tensor, u_jitter: torch.Tensor):
        inv_mass = hyper.inv_mass
        eps = torch.exp(hyper.da.log_eps) * (
            1.0 + jitter * (2.0 * u_jitter - 1.0))
        p0 = momentum(normal, inv_mass)
        q1, p1, lp1, _ = leapfrog(vag, state.params, p0, eps, inv_mass,
                                  n_leapfrog)
        h0 = -state.logpost + kinetic(p0, inv_mass)
        h1 = -lp1 + kinetic(p1, inv_mass)
        log_ratio = h0 - h1
        log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio,
                                torch.full_like(log_ratio, -math.inf))
        accept_prob = torch.exp(torch.clamp(log_ratio, max=0.0))
        accept = torch.log(u_accept) < log_ratio
        info = {"accept_prob": accept_prob,
                "accepted": accept.to(torch.float32),
                "divergent": (log_ratio < -1000.0).to(torch.float32)}
        return MHState(params=tree_where(accept, q1, state.params),
                       logpost=torch.where(accept, lp1, state.logpost)), info

    def draw(gen: torch.Generator, state: MHState):
        u = lambda: torch.rand(state.logpost.shape, generator=gen,
                               dtype=torch.float32,
                               device=state.logpost.device)
        return tree_random_normal(gen, state.params), u(), u()

    kernel.draw = draw
    return kernel


def make_adapter(target_accept: float = 0.8,
                 mass_start: float = 100.0) -> Callable:
    """Warmup adapter: dual-averaging step (gamma 0.05, t0 10) on the
    pooled acceptance, plus every chain's position merged into a pooled
    Welford; once it holds more than ``mass_start`` positions the inverse
    mass is the pooled variance (+ 1e-6 scale^2). A zero prior scale marks
    a frozen coordinate, whose inverse mass stays 0."""

    def adapt(hyper: HMCHyper, pooled, states: MHState, t):
        da = dual_averaging_update(hyper.da, pooled["accept_prob"], t,
                                   target=target_accept)
        welford = welford_update_batch(hyper.welford, states.params, axis=0)
        n = welford.count
        ready = n > mass_start

        def im(m2, s):
            var = m2 / torch.clamp(n - 1.0, min=1.0)
            return torch.where(s > 0, torch.where(ready, var + 1e-6 * s * s,
                                                  s * s),
                               torch.zeros_like(s))

        return dataclasses.replace(hyper, da=da, welford=welford,
                                   inv_mass=tree_map(im, welford.m2,
                                                     hyper.scales))

    return adapt


def finalize(hyper: HMCHyper) -> HMCHyper:
    """Post-warmup: switch to the averaged step size."""
    return dataclasses.replace(
        hyper, da=dataclasses.replace(hyper.da, log_eps=hyper.da.log_eps_bar))
