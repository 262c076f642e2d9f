"""Preconditioned Crank-Nicolson (pCN) Metropolis.

Counterpart of ``mceik_tpu/samplers/pcn.py``, with the chain axis written
out. For Gaussian-prior leaves the proposal

    theta' = sqrt(1 - rho^2) * theta + rho * sigma_prior * xi

is prior-reversible, so the acceptance uses the likelihood alone (robust
to dimension for a slowness field). Non-Gaussian leaves (the logistic-prior
``hypo_raw``) take a symmetric random walk ``theta + rho * scale * xi``
whose prior term enters the acceptance explicitly. The chain state's
``logpost`` holds the likelihood plus that non-Gaussian prior term. In the
whitened coordinates of a Laplace fit (``model/whitened.py``) the same
kernel on a flat ``(C, d)`` state with a unit reference is generalized pCN.

``rho = sigmoid(log_rho)``; dual averaging (gamma 0.1, t0 20) tunes
``logit(rho)`` toward the target acceptance during warmup.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from mceik_tpu_torch.samplers.base import MHState
from mceik_tpu_torch.samplers.hmc import DualAveraging, dual_averaging_update
from mceik_tpu_torch.utils import tree_leaves, tree_where


@dataclasses.dataclass
class PCNHyper:
    log_rho: torch.Tensor     # logit of the pCN step rho
    gauss_scales: Any         # prior sigmas of the Gaussian leaves (None = RW)
    rw_scales: Any            # scales of the random-walk leaves (None = pCN)
    da: DualAveraging         # dual-averaging state on logit(rho)


def init_hyper(gauss_scales: Any, rw_scales: Any,
               rho: float = 0.1) -> PCNHyper:
    """Scale trees have no chain axis; a ``None`` leaf (or tree) leaves
    that kind of move out."""
    rho = min(max(rho, 1e-4), 0.999)
    dev = tree_leaves(gauss_scales if gauss_scales is not None
                      else rw_scales)[0].device
    lr = torch.tensor(math.log(rho / (1 - rho)), dtype=torch.float32,
                      device=dev)
    return PCNHyper(log_rho=lr, gauss_scales=gauss_scales,
                    rw_scales=rw_scales,
                    da=DualAveraging(mu=lr.clone(), log_eps=lr.clone(),
                                     log_eps_bar=lr.clone(),
                                     h_bar=torch.zeros_like(lr)))


def _field(tree, name):
    return None if tree is None else getattr(tree, name)


def propose(params: Any, normal: Any, hyper: PCNHyper) -> Any:
    """The pCN / random-walk proposal, leaf by leaf. ``params`` is a
    ``Params`` (per-field scales) or one flat tensor (Gaussian scales)."""
    rho = torch.sigmoid(hyper.log_rho)

    def leaf(p, e, gs, rs):
        if p is None:
            return None
        if gs is not None:
            return torch.sqrt(1.0 - rho * rho) * p + rho * gs * e
        if rs is not None:
            return p + rho * rs * e
        return p

    if isinstance(params, torch.Tensor):
        return leaf(params, normal, hyper.gauss_scales, hyper.rw_scales)
    return dataclasses.replace(params, **{
        f.name: leaf(getattr(params, f.name), getattr(normal, f.name),
                     _field(hyper.gauss_scales, f.name),
                     _field(hyper.rw_scales, f.name))
        for f in dataclasses.fields(params)})


def make_kernel(log_lik_fn: Callable,
                log_prior_nongauss_fn: Optional[Callable] = None) -> Callable:
    """pCN-within-MH transition over all chains: ``(state, hyper, normal,
    uniform) -> (state, info)``. ``log_lik_fn`` is the likelihood alone
    (the proposal absorbs the Gaussian prior); ``log_prior_nongauss_fn``
    the prior of the random-walk leaves, or None."""

    def kernel(state: MHState, hyper: PCNHyper, normal: Any,
               uniform: torch.Tensor):
        prop = propose(state.params, normal, hyper)
        ll = log_lik_fn(prop)
        if log_prior_nongauss_fn is not None:
            ll = ll + log_prior_nongauss_fn(prop)
        log_ratio = ll - state.logpost
        accept_prob = torch.exp(torch.clamp(log_ratio, max=0.0))
        accept = torch.log(uniform) < log_ratio
        info = {"accept_prob": accept_prob,
                "accepted": accept.to(torch.float32)}
        return MHState(params=tree_where(accept, prop, state.params),
                       logpost=torch.where(accept, ll, state.logpost)), info

    return kernel


def make_adapter(target_accept: float = 0.234) -> Callable:
    """Warmup adapter: dual averaging on logit(rho)."""

    def adapt(hyper: PCNHyper, pooled, states, t):
        da = dual_averaging_update(hyper.da, pooled["accept_prob"], t,
                                   target=target_accept, gamma=0.1, t0=20.0)
        return dataclasses.replace(hyper, log_rho=da.log_eps, da=da)

    return adapt


def finalize(hyper: PCNHyper) -> PCNHyper:
    """Post-warmup: freeze rho at the dual-averaged iterate."""
    return dataclasses.replace(
        hyper, log_rho=hyper.da.log_eps_bar,
        da=dataclasses.replace(hyper.da, log_eps=hyper.da.log_eps_bar))
