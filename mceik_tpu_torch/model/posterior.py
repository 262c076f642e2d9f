"""Posterior builder: prior + Gaussian traveltime likelihood.

Counterpart of ``mceik_tpu/model/posterior.py`` for tomo mode with fixed
noise. Every function takes parameters with a leading chain axis
(``u``: ``(C,) + inv_shape``) and returns one value per chain; one
``logpost`` call makes one batched eikonal solve of ``C x n_src`` fields.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mceik_tpu_torch.config import EikonalCfg, ModelCfg
from mceik_tpu_torch.eikonal.solve import EikonalConfig
from mceik_tpu_torch.forward.predict import predict_tomo
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.data import TomoData
from mceik_tpu_torch.model.params import Params, slowness_from_u


def _eik_config(cfg: EikonalCfg) -> EikonalConfig:
    return EikonalConfig(
        method=cfg.method, tol=cfg.tol, max_iters=cfg.max_iters,
        n_inner=cfg.n_inner, seed_radius=cfg.seed_radius,
        use_pallas=cfg.use_pallas,
    )


@dataclasses.dataclass(frozen=True)
class PosteriorModel:
    """Bundle of functions defining the posterior (all chain-batched)."""

    logpost: Callable[[Params], torch.Tensor]          # -> (C,)
    init_params: Callable[..., Params]                  # (gen, n_chains, jitter)
    slowness_of: Callable[[Params], torch.Tensor]       # -> (C,) + grid
    n_dim: int                    # sampled scalars per chain
    prior_scales: Params          # per-leaf natural scales (no chain axis)
    log_prior: Callable[[Params], torch.Tensor]
    log_lik: Callable[[Params], torch.Tensor]


def _gaussian_loglik(r, sigma, mask):
    """Per-chain Gaussian log-likelihood of residuals ``(C, n_src, n_rec)``."""
    if mask is None:
        mask = torch.ones_like(r)
    z = r / sigma
    return (-0.5 * (mask * z * z).flatten(1).sum(1)
            - (mask * torch.log(sigma)).flatten(1).sum(1))


def build_posterior(cfg: ModelCfg, data: TomoData, grid: Grid,
                    eik_cfg: EikonalCfg = EikonalCfg(),
                    differentiable: bool = False) -> PosteriorModel:
    """Construct the tomo posterior over ``data`` (whose tensors set the
    device)."""
    if differentiable:
        raise NotImplementedError(
            "gradient samplers need the implicit adjoint: slice 3 of the port")
    if cfg.mode != "tomo":
        raise NotImplementedError(
            f"model mode {cfg.mode!r}: joint mode is slice 3 and locate mode "
            "slice 4 of the port")
    noise_model = cfg.resolved_noise_model()
    if noise_model != "fixed":
        raise NotImplementedError(
            f"noise_model {noise_model!r}: hierarchical and spike-slab noise "
            "are slice 3 of the port")
    if not isinstance(data, TomoData):
        raise TypeError(f"tomo mode needs TomoData, got {type(data).__name__}")

    econf = _eik_config(eik_cfg)
    device = data.t_obs.device
    bg = torch.tensor(cfg.background_slowness, dtype=torch.float32,
                      device=device)
    sigma = torch.tensor(cfg.sigma, dtype=torch.float32, device=device)
    inv_shape = tuple(cfg.inv_shape)

    def log_prior(params: Params) -> torch.Tensor:
        return -0.5 * ((params.u / cfg.prior_sigma_u) ** 2).flatten(1).sum(1)

    def slowness_of(params: Params) -> torch.Tensor:
        return slowness_from_u(params.u, grid, bg)

    def predict(params: Params) -> torch.Tensor:
        return predict_tomo(slowness_of(params), data.src_xyz, data.rec_xyz,
                            grid, econf)

    def log_lik(params: Params) -> torch.Tensor:
        r = data.t_obs - predict(params)
        mask = data.mask
        if mask is not None:
            mask = mask.expand_as(r)
        return _gaussian_loglik(r, sigma.expand_as(r), mask)

    def logpost(params: Params) -> torch.Tensor:
        return log_prior(params) + log_lik(params)

    def init_params(gen: torch.Generator, n_chains: int,
                    jitter: float = 1.0) -> Params:
        u = jitter * 0.1 * cfg.prior_sigma_u * torch.randn(
            (n_chains,) + inv_shape, generator=gen, dtype=torch.float32,
            device=device)
        return Params(u=u)

    prior_scales = Params(u=torch.full(inv_shape, cfg.prior_sigma_u,
                                       dtype=torch.float32, device=device))
    n_dim = 1
    for n in inv_shape:
        n_dim *= n

    return PosteriorModel(
        logpost=logpost, init_params=init_params, slowness_of=slowness_of,
        n_dim=n_dim, prior_scales=prior_scales, log_prior=log_prior,
        log_lik=log_lik)
