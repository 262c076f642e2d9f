"""Adaptive Metropolis with a diagonal proposal adapted from a pooled
cross-chain Welford, and dual-averaging step tuning. Config 2's sampler.

Counterpart of ``mceik_tpu/samplers/am.py``, with the chain axis written
out: the kernel advances all chains in one call (one batched logpost).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from mceik_tpu_torch.diag.moments import Welford, welford_init, welford_update_batch
from mceik_tpu_torch.io.trace import device_tensor
from mceik_tpu_torch.samplers.base import MHState
from mceik_tpu_torch.samplers.hmc import DualAveraging, dual_averaging_update
from mceik_tpu_torch.utils import tree_leaves, tree_map, tree_size, tree_where


@dataclasses.dataclass
class AMHyper:
    log_step: torch.Tensor
    scales: Any          # prior-based fallback scales (tree like params)
    welford: Welford     # pooled running moments of the chain positions
    reg: torch.Tensor    # regularization floor on the adapted std
    da: DualAveraging    # dual-averaging state for the step tuner


def _scalar(x: float, device) -> torch.Tensor:
    return device_tensor(x, torch.float32, device)


def init_hyper(scales: Any, step_size: float, example_params: Any,
               reg: float = 1e-3) -> AMHyper:
    """``scales`` and ``example_params`` have no chain axis."""
    dev = tree_leaves(scales)[0].device
    log_eps = _scalar(math.log(step_size), dev)
    return AMHyper(
        log_step=log_eps.clone(),
        scales=scales,
        welford=welford_init(example_params),
        reg=_scalar(reg, dev),
        da=DualAveraging(mu=log_eps.clone(), log_eps=log_eps.clone(),
                         log_eps_bar=log_eps.clone(),
                         h_bar=_scalar(0.0, dev)),
    )


def _proposal_std(hyper: AMHyper) -> Any:
    """Per-coordinate proposal std: the prior scales until the pooled Welford
    holds more than 50 positions, then the adapted std normalised to the
    prior scales' geometric mean over active coordinates (the global
    magnitude belongs to ``log_step``). Scale 0 marks frozen coordinates."""
    n = hyper.welford.count
    ready = n > 50.0

    def std_leaf(m2, scale):
        var = m2 / torch.clamp(n - 1.0, min=1.0)
        adapted = torch.sqrt(var + (hyper.reg * scale) ** 2)
        return torch.where(scale > 0, adapted, torch.zeros_like(adapted))

    raw = tree_map(std_leaf, hyper.welford.m2, hyper.scales)

    tot, cnt = 0.0, 0.0
    for st, sc in zip(tree_leaves(raw), tree_leaves(hyper.scales)):
        active = sc > 0
        logs = (torch.log(torch.clamp(st, min=1e-30))
                - torch.log(torch.where(active, sc, torch.ones_like(sc))))
        tot = tot + torch.where(active, logs, torch.zeros_like(logs)).sum()
        cnt = cnt + active.to(torch.float32).sum()
    c = torch.exp(-tot / torch.clamp(cnt, min=1.0))

    return tree_map(
        lambda st, sc: torch.where(sc > 0, torch.where(ready, c * st, sc),
                                   torch.zeros_like(st)),
        raw, hyper.scales)


def make_kernel(logpost_fn: Callable) -> Callable:
    """AM transition over all chains. ``logpost_fn`` maps chain-batched
    params to ``(C,)``. ``normal`` is a tree like the params, ``uniform``
    is ``(C,)``."""

    def kernel(state: MHState, hyper: AMHyper, normal: Any,
               uniform: torch.Tensor):
        n_chains = state.logpost.shape[0]
        d = tree_size(state.params) // n_chains
        step = (torch.exp(hyper.log_step) * 2.38
                / torch.sqrt(_scalar(float(d), state.logpost.device)))
        std = _proposal_std(hyper)
        prop = tree_map(lambda p, e, s: p + step * s * e,
                        state.params, normal, std)
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


def make_adapter(target_accept: float = 0.234,
                 mem_samples: float = 2000.0) -> Callable:
    """Warmup adapter: dual averaging on the pooled acceptance, plus every
    chain's position merged into the pooled Welford, whose effective count
    is capped at ``mem_samples`` (exponential forgetting of the burn-in)."""

    def adapt(hyper: AMHyper, pooled, states: MHState, t):
        da = dual_averaging_update(hyper.da, pooled["accept_prob"], t,
                                   target=target_accept, gamma=0.1, t0=20.0)
        welford = welford_update_batch(hyper.welford, states.params, axis=0)
        f = torch.clamp(mem_samples / torch.clamp(welford.count, min=1.0),
                        max=1.0)
        welford = dataclasses.replace(
            welford, count=welford.count * f,
            m2=tree_map(lambda m: m * f, welford.m2))
        return dataclasses.replace(hyper, log_step=da.log_eps, da=da,
                                   welford=welford)

    return adapt


def finalize(hyper: AMHyper) -> AMHyper:
    """Post-warmup: freeze the step at the dual-averaged iterate."""
    return dataclasses.replace(hyper, log_step=hyper.da.log_eps_bar)
