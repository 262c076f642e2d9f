"""Random-walk Metropolis with Robbins-Monro step-size adaptation. Config
1's sampler.

Counterpart of ``mceik_tpu/samplers/rwm.py``, with the chain axis written
out: the kernel advances all chains in one call (one batched logpost). The
proposal is ``params + exp(log_step) * scales * normal`` with ``scales`` the
prior's per-leaf natural scales, and one global log-step adapted toward the
target acceptance during warmup from the acceptance pooled over chains.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from mceik_tpu_torch.samplers.base import MHState
from mceik_tpu_torch.utils import tree_leaves, tree_map, tree_where


@dataclasses.dataclass
class RWMHyper:
    log_step: torch.Tensor
    scales: Any  # tree like the params, no chain axis


def init_hyper(scales: Any, step_size: float) -> RWMHyper:
    dev = tree_leaves(scales)[0].device
    return RWMHyper(log_step=torch.tensor(math.log(step_size),
                                          dtype=torch.float32, device=dev),
                    scales=scales)


def make_kernel(logpost_fn: Callable) -> Callable:
    """RWM transition over all chains. ``logpost_fn`` maps chain-batched
    params to ``(C,)``. ``normal`` is a tree like the params, ``uniform``
    is ``(C,)``."""

    def kernel(state: MHState, hyper: RWMHyper, normal: Any,
               uniform: torch.Tensor):
        step = torch.exp(hyper.log_step)
        prop = tree_map(lambda p, e, s: p + step * s * e,
                        state.params, normal, hyper.scales)
        lp = logpost_fn(prop)
        log_ratio = lp - state.logpost
        accept_prob = torch.exp(torch.clamp(log_ratio, max=0.0))
        accept = torch.log(uniform) < log_ratio
        info = {"accept_prob": accept_prob,
                "accepted": accept.to(torch.float32)}
        return MHState(params=tree_where(accept, prop, state.params),
                       logpost=torch.where(accept, lp, state.logpost)), info

    return kernel


def make_adapter(target_accept: float = 0.234, gamma0: float = 1.5,
                 t0: float = 3.0, kappa: float = 0.5) -> Callable:
    """Robbins-Monro log-step adaptation on the pooled acceptance: gain
    ``gamma0 / (t0 + t)^kappa``, in fp32 as the reference computes it. Its
    cumulative capacity (~ gamma0 * err * 2 sqrt(T)) moves log_step by 5-10
    within a few hundred steps."""

    def adapt(hyper: RWMHyper, pooled, states, t):
        base = torch.tensor(t0 + t, dtype=torch.float32,
                            device=hyper.log_step.device)
        g = gamma0 / base ** kappa
        log_step = hyper.log_step + g * (pooled["accept_prob"] - target_accept)
        return dataclasses.replace(hyper, log_step=log_step)

    return adapt
