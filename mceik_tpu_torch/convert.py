"""Carry state across from the JAX package.

Each function takes objects of the JAX package (``Params``, ``TomoData``,
``EventData``, ``RWMHyper``, ``AMHyper``, ``AMFullHyper``, ``MALAState``,
``SMCState``, ``HMCHyper``, ``PCNHyper``) whose leaves are array-likes,
reads them as numpy arrays, and
returns the port's dataclasses on ``device``; every ``Params`` leaf comes
across, the noise leaves ``log_sigma`` and ``noise_z`` included. Attribute access only: this
module imports neither ``jax`` nor ``mceik_tpu``. The parity tests use it
so that both packages compute on the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from mceik_tpu_torch.diag.moments import Welford
from mceik_tpu_torch.model.data import EventData, TomoData
from mceik_tpu_torch.model.params import Params
from mceik_tpu_torch.samplers.am import AMHyper
from mceik_tpu_torch.samplers.am_full import AMFullHyper
from mceik_tpu_torch.samplers.hmc import DualAveraging, HMCHyper
from mceik_tpu_torch.samplers.mala import MALAState
from mceik_tpu_torch.samplers.pcn import PCNHyper
from mceik_tpu_torch.samplers.rwm import RWMHyper
from mceik_tpu_torch.samplers.smc import SMCState


def _t(x, device):
    if x is None:
        return None
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


def params_from_jax(p, device="cpu") -> Params:
    """JAX ``Params`` (any leading batch axes kept) -> port ``Params``."""
    return Params(u=_t(p.u, device), hypo_raw=_t(p.hypo_raw, device),
                  t0=_t(p.t0, device), log_sigma=_t(p.log_sigma, device),
                  noise_z=_t(p.noise_z, device))


def _tree(x, device):
    """A JAX ``Params``, or a bare array (a toy target's state), or None."""
    if x is None:
        return None
    return params_from_jax(x, device) if hasattr(x, "u") else _t(x, device)


def tomo_data_from_jax(d, device="cpu") -> TomoData:
    return TomoData(src_xyz=_t(d.src_xyz, device), rec_xyz=_t(d.rec_xyz, device),
                    t_obs=_t(d.t_obs, device), mask=_t(d.mask, device))


def event_data_from_jax(d, device="cpu") -> EventData:
    return EventData(sta_xyz=_t(d.sta_xyz, device), t_obs=_t(d.t_obs, device),
                     mask=_t(d.mask, device))


def _da_from_jax(da, device) -> DualAveraging:
    return DualAveraging(mu=_t(da.mu, device), log_eps=_t(da.log_eps, device),
                         log_eps_bar=_t(da.log_eps_bar, device),
                         h_bar=_t(da.h_bar, device))


def am_hyper_from_jax(h, device="cpu") -> AMHyper:
    w = h.welford
    return AMHyper(
        log_step=_t(h.log_step, device),
        scales=params_from_jax(h.scales, device),
        welford=Welford(count=_t(w.count, device),
                        mean=params_from_jax(w.mean, device),
                        m2=params_from_jax(w.m2, device)),
        reg=_t(h.reg, device),
        da=_da_from_jax(h.da, device),
    )


def am_full_hyper_from_jax(h, device="cpu") -> AMFullHyper:
    """Full-covariance AM's (and MALA's) hyper."""
    return AMFullHyper(
        log_step=_t(h.log_step, device), count=_t(h.count, device),
        mean=_t(h.mean, device), m2=_t(h.m2, device),
        scales_flat=_t(h.scales_flat, device), reg=_t(h.reg, device),
        da=_da_from_jax(h.da, device))


def mala_state_from_jax(s, device="cpu") -> MALAState:
    """Chain-batched MALA state, cached gradient included."""
    return MALAState(params=params_from_jax(s.params, device),
                     logpost=_t(s.logpost, device),
                     grad=params_from_jax(s.grad, device))


def rwm_hyper_from_jax(h, device="cpu") -> RWMHyper:
    return RWMHyper(log_step=_t(h.log_step, device),
                    scales=params_from_jax(h.scales, device))


def hmc_hyper_from_jax(h, device="cpu") -> HMCHyper:
    """HMC's (and NUTS's) hyper: tuner, inverse mass, pooled Welford and
    prior scales."""
    w = h.welford
    return HMCHyper(da=_da_from_jax(h.da, device),
                    inv_mass=_tree(h.inv_mass, device),
                    welford=Welford(count=_t(w.count, device),
                                    mean=_tree(w.mean, device),
                                    m2=_tree(w.m2, device)),
                    scales=_tree(h.scales, device))


def pcn_hyper_from_jax(h, device="cpu") -> PCNHyper:
    return PCNHyper(log_rho=_t(h.log_rho, device),
                    gauss_scales=_tree(h.gauss_scales, device),
                    rw_scales=_tree(h.rw_scales, device),
                    da=_da_from_jax(h.da, device))


def smc_state_from_jax(s, device="cpu") -> SMCState:
    """A particle population: params, log prior, log likelihood and the
    shared mutation log-step. Non-``Params`` particles (a bare array, as in
    a toy target) come across as one tensor."""
    return SMCState(params=_tree(s.params, device), log_prior=_t(s.log_prior, device),
                    log_lik=_t(s.log_lik, device),
                    log_step=_t(s.log_step, device))
