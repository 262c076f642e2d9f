"""Posterior builder: prior + Gaussian traveltime likelihood.

Counterpart of ``mceik_tpu/model/posterior.py`` for tomo mode with fixed
noise. Every function takes parameters with a leading chain axis
(``u``: ``(C,) + inv_shape``) and returns one value per chain; one
``logpost`` call makes one batched eikonal solve of ``C x n_src`` fields.
Built with ``differentiable=True`` the solve is the implicit-adjoint one,
and :func:`value_and_grad` gives every chain's gradient from one backward
pass: one batched transport solve of the same ``C x n_src`` fields.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from mceik_tpu_torch.config import EikonalCfg, ModelCfg
from mceik_tpu_torch.eikonal.adjoint import solve_eikonal_diff_batched
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.solve import EikonalConfig
from mceik_tpu_torch.forward.predict import predict_tomo
from mceik_tpu_torch.grid import Grid, sample_linear
from mceik_tpu_torch.model.data import TomoData
from mceik_tpu_torch.model.params import Params, slowness_from_u
from mceik_tpu_torch.utils import tree_leaves, tree_map


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
    predict: Callable[[Params], torch.Tensor]           # -> (C, n_src, n_rec)
    grid: Grid
    cfg: ModelCfg
    n_dim: int                    # sampled scalars per chain
    prior_scales: Params          # per-leaf natural scales (no chain axis)
    log_prior: Callable[[Params], torch.Tensor]
    log_lik: Callable[[Params], torch.Tensor]
    # Params of ONE chain (leading axis 1) -> (t_pred (n_obs,), J (n_obs, d))
    # with J = d t_pred / d params, raveled. None unless differentiable.
    jacobian: Optional[Callable[[Params], Tuple[torch.Tensor, torch.Tensor]]] = None


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
    device). ``differentiable=True`` routes the solves through the implicit
    adjoint, for the gradient samplers and the Laplace fit."""
    if cfg.mode != "tomo":
        raise NotImplementedError(
            f"model mode {cfg.mode!r}: joint mode is slice 4 and locate mode "
            "slice 5 of the port")
    noise_model = cfg.resolved_noise_model()
    if noise_model != "fixed":
        raise NotImplementedError(
            f"noise_model {noise_model!r}: hierarchical and spike-slab noise "
            "are slice 4 of the port")
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
                            grid, econf, differentiable=differentiable)

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

    def jacobian(params: Params):
        """Every row of ``d t_pred / d u`` from ONE forward solve and ONE
        transport batch: row ``k`` is the VJP of observation ``k`` alone,
        whose cotangent lives in one table field, so the rows' fields are
        gathered into a batch of ``n_obs`` and pulled back together (the
        reference pulls back one-hot cotangents one row at a time)."""
        u = params.u
        if u.shape[0] != 1:
            raise ValueError(f"jacobian takes one chain, got {u.shape[0]}")
        n_src, n_rec = data.src_xyz.shape[0], data.rec_xyz.shape[0]
        if n_src <= n_rec:          # predict_tomo's "auto" choice
            tab_xyz, pt_xyz = data.src_xyz, data.rec_xyz
            tab = torch.arange(n_src, device=device).repeat_interleave(n_rec)
            pt = torch.arange(n_rec, device=device).repeat(n_src)
        else:
            tab_xyz, pt_xyz = data.rec_xyz, data.src_xyz
            tab = torch.arange(n_rec, device=device).repeat(n_src)
            pt = torch.arange(n_src, device=device).repeat_interleave(n_rec)
        n_obs = n_src * n_rec
        with torch.no_grad():
            s = slowness_of(params)[0]
            T = solve_eikonal_batched(s, tab_xyz, grid, econf)
        with torch.enable_grad():
            u_rows = u.detach().expand((n_obs,) + inv_shape).requires_grad_(True)
            T_rows = solve_eikonal_diff_batched(
                slowness_of(Params(u=u_rows)), tab_xyz[tab], grid, econf,
                T=T[tab])
            idx = grid.to_index_coords(pt_xyz[pt]).unsqueeze(1)
            t_rows = sample_linear(T_rows, idx)[:, 0]
            (J,) = torch.autograd.grad(t_rows.sum(), u_rows)
        return t_rows.detach(), J.reshape(n_obs, -1)

    prior_scales = Params(u=torch.full(inv_shape, cfg.prior_sigma_u,
                                       dtype=torch.float32, device=device))
    n_dim = 1
    for n in inv_shape:
        n_dim *= n

    return PosteriorModel(
        logpost=logpost, init_params=init_params, slowness_of=slowness_of,
        predict=predict, grid=grid, cfg=cfg, n_dim=n_dim,
        prior_scales=prior_scales, log_prior=log_prior, log_lik=log_lik,
        jacobian=jacobian if differentiable else None)


def value_and_grad(logpost_fn: Callable[[Params], torch.Tensor]):
    """``params -> (lp (C,), grad)``: every chain's logpost and its gradient
    (a tree like ``params``) from one backward pass of ``lp.sum()`` (chains
    are independent). The logpost must be built with ``differentiable=True``.
    A chain whose transport solve diverged gets a NaN gradient."""

    def vag(params):
        with torch.enable_grad():
            p = tree_map(lambda x: x.detach().requires_grad_(True), params)
            lp = logpost_fn(p)
            grads = iter(torch.autograd.grad(lp.sum(), tree_leaves(p)))
        return lp.detach(), tree_map(lambda _: next(grads), p)

    return vag
