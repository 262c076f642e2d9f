"""Whitened (Laplace-referenced) reparameterization of a posterior.

Counterpart of ``mceik_tpu/model/whitened.py``. With ``x_map`` the MAP and
``C = L L^T`` the Gauss-Newton covariance (``model/laplace.py``), chains
live in the coordinates ``x = x_map + L u``, a flat ``(C, d)`` state, and
the target is ``logpost(x(u))`` (the constant Jacobian drops). Unit scales
on ``u`` then amount to the dense GN covariance on ``x``: HMC and NUTS with
unit mass are dense-mass HMC and NUTS, and pCN with a unit reference is
generalized pCN with respect to N(x_map, C), whose acceptance sees only the
non-Gaussian residual ``logpost(x(u)) + |u_active|^2 / 2``.

Frozen coordinates (prior scale 0): C has a unit diagonal there, the
active mask zeroes their ``u`` inside the map, and ``scales_u`` is 0 there
so the samplers never move them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mceik_tpu_torch.samplers.am_full import _ravel, _unravel_fn


@dataclasses.dataclass(frozen=True)
class WhitenedView:
    """u-space view of a posterior (see the module docstring)."""

    logpost_u: Callable      # (C, d) -> (C,), the whitened log target
    resid_u: Callable        # logpost_u + |u_active|^2 / 2 (gpCN's target)
    params_of: Callable      # (C, d) -> Params with the chain axis
    init_u: Callable         # (gen, n) -> (n, d), MAP-jittered starts
    scales_u: torch.Tensor   # (d,) 1.0 active / 0.0 frozen
    zero_u: torch.Tensor     # (d,) zeros (example params for init_hyper)
    d: int


def whitened_view(posterior, p_map, cov: torch.Tensor,
                  init_jitter: float = 0.3) -> WhitenedView:
    """The u-space view from a MAP (params of one chain, leading axis 1)
    and a GN covariance. Chains start at ``u ~ init_jitter * N(0, I)`` on
    the active coordinates, the 0.3x Laplace overdispersion of the MALA
    path."""
    x_map = _ravel(p_map, batch_dims=1)                      # (1, d)
    active = (_ravel(posterior.prior_scales) > 0).to(torch.float32)
    L = torch.linalg.cholesky(torch.as_tensor(cov, dtype=torch.float32,
                                              device=x_map.device))
    unravel = _unravel_fn(p_map, batch_dims=1)
    d = int(x_map.shape[1])

    def params_of(u):
        return unravel(x_map + (active * u) @ L.T)

    def logpost_u(u):
        return posterior.logpost(params_of(u))

    def resid_u(u):
        ua = active * u
        return logpost_u(u) + 0.5 * (ua * ua).sum(1)

    def init_u(gen: torch.Generator, n: int):
        return init_jitter * active * torch.randn(
            (n, d), generator=gen, dtype=torch.float32, device=x_map.device)

    return WhitenedView(logpost_u=logpost_u, resid_u=resid_u,
                        params_of=params_of, init_u=init_u, scales_u=active,
                        zero_u=torch.zeros_like(active), d=d)
