"""Posterior builder: prior + Gaussian traveltime likelihood.

Counterpart of ``mceik_tpu/model/posterior.py`` in three modes: ``tomo``
(slowness only, known sources; configs 1, 2 and 4), ``joint`` (slowness,
hypocentres and origin times; configs 3 and 5) and ``locate`` (hypocentres
and origin times over a fixed slowness, whose station tables are solved
once when the posterior is built, so a logpost is interpolation and
reduction alone and there is no ``u``), the last two with sampled ``t0``
or with ``t0`` marginalized exactly. Three noise models:
``fixed`` (``cfg.sigma``), ``hierarchical`` (``sigma * exp(log_sigma)``,
one ``log_sigma`` or one per station, under an ``N(0, sigma_hyper^2)``
hyperprior) and ``spike_slab`` (per station, an indicator ``z`` switches
the noise between ``sigma`` and ``sigma * exp(log_sigma)``, the slab
``N(noise_slab_mu, sigma_hyper^2)`` doubling as the pseudo-prior of
inactive stations; the indicators move only through :func:`noise_gibbs`'s
exact Gibbs scan). Every function takes parameters with a leading chain
axis (``u``: ``(C,) + inv_shape``, ``hypo_raw``: ``(C, n_ev, D)``, ``t0``:
``(C, n_ev)``, ``log_sigma``: ``(C,)`` or ``(C, n_sta)``, ``noise_z``:
``(C, n_sta)``; stations are the receivers in tomo mode) and returns one
value per chain; one ``logpost`` call makes one batched eikonal solve of
``C x n_src`` (tomo) or ``C x n_sta`` (joint, tables solved from the
stations) fields, and none in locate mode. Built with
``differentiable=True`` the solve is the implicit-adjoint one, and
:func:`value_and_grad` gives every chain's gradient from one backward
pass: one batched transport solve of the same fields. Hypocentre gradients
come from the table interpolation alone.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from mceik_tpu_torch.config import EikonalCfg, ModelCfg
from mceik_tpu_torch.eikonal.adjoint import solve_eikonal_diff_batched
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.solve import EikonalConfig
from mceik_tpu_torch.forward.predict import (interp_tables, predict_events,
                                             predict_tomo, traveltime_tables)
from mceik_tpu_torch.forward.tables_cache import cached_traveltime_tables
from mceik_tpu_torch.grid import Grid, sample_linear
from mceik_tpu_torch.io.loaders import load_slowness
from mceik_tpu_torch.model.data import EventData, TomoData
from mceik_tpu_torch.model.params import (Params, box_from_raw, box_logjac,
                                          slowness_from_u)
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
    slowness_of: Callable[[Params], Optional[torch.Tensor]]  # (C,) + grid, or None (locate)
    predict: Callable[[Params], torch.Tensor]           # -> (C, n_src, n_rec) or (C, n_ev, n_sta)
    grid: Grid
    cfg: ModelCfg
    n_dim: int                    # sampled scalars per chain
    prior_scales: Params          # per-leaf natural scales (no chain axis)
    log_prior: Callable[[Params], torch.Tensor]
    log_lik: Callable[[Params], torch.Tensor]
    sample_prior: Callable[..., Params]                 # (gen, n) exact prior draws
    # Params of ONE chain (leading axis 1) -> (t_pred (n_obs,), J (n_obs, d))
    # with J = d t_pred / d params, raveled. None unless differentiable.
    jacobian: Optional[Callable[[Params], Tuple[torch.Tensor, torch.Tensor]]] = None
    # Spike-slab noise: the exact systematic-scan Gibbs sweep over the
    # station indicators, (params, uniforms (C, n_sta), fresh normals
    # (C, n_sta), beta=1.0) -> (params, log_prior, log_lik). None unless
    # noise_model="spike_slab".
    noise_gibbs: Optional[Callable] = None


def _per_chain_sum(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).sum(1)


def _gaussian_loglik(r, sigma, mask):
    """Per-chain Gaussian log-likelihood of residuals ``(C, n_a, n_b)``."""
    if mask is None:
        mask = torch.ones_like(r)
    z = r / sigma
    return (-0.5 * _per_chain_sum(mask * z * z)
            - _per_chain_sum(mask * torch.log(sigma)))


def _marginalized_t0_loglik(r, sigma, mask):
    """Exact origin-time marginalization under a flat t0 prior, per chain,
    for residuals ``(C, n_ev, n_sta)``: precision-weighted demeaning per
    event plus the ``-0.5 log(sum_j w_j)`` Gaussian-integral term, with
    ``w_j = mask_j / sigma_j^2``."""
    if mask is None:
        mask = torch.ones_like(r)
    w = mask / (sigma * sigma)
    sw = torch.clamp(w.sum(-1, keepdim=True), min=1e-20)
    t0_hat = (w * r).sum(-1, keepdim=True) / sw
    quad = _per_chain_sum(w * (r - t0_hat) ** 2)
    return (-0.5 * quad - _per_chain_sum(mask * torch.log(sigma))
            - 0.5 * _per_chain_sum(torch.log(sw[..., 0])))


def build_posterior(cfg: ModelCfg, data, grid: Grid,
                    eik_cfg: EikonalCfg = EikonalCfg(),
                    differentiable: bool = False,
                    fixed_slowness=None) -> PosteriorModel:
    """Construct the tomo, joint or locate posterior over ``data`` (whose
    tensors set the device). ``differentiable=True`` routes the solves
    through the implicit adjoint, for the gradient samplers and the Laplace
    fit.

    ``fixed_slowness`` (locate mode): the given velocity model the station
    tables are solved over, an array or tensor of the grid's shape; None
    takes ``cfg.fixed_slowness_path`` (HDF5 or ``.pt``, by extension), else
    the homogeneous background. The tables come through the on-disk cache
    when ``cfg.table_cache_dir`` is set."""
    if cfg.mode not in ("tomo", "joint", "locate"):
        raise ValueError(f"unknown model mode {cfg.mode!r}")
    noise_model = cfg.resolved_noise_model()
    if noise_model not in ("fixed", "hierarchical", "spike_slab"):
        raise ValueError(f"unknown noise_model {noise_model!r}")
    want = TomoData if cfg.mode == "tomo" else EventData
    if not isinstance(data, want):
        raise TypeError(f"{cfg.mode} mode needs {want.__name__}, got "
                        f"{type(data).__name__}")

    econf = _eik_config(eik_cfg)
    device = data.t_obs.device
    bg = torch.tensor(cfg.background_slowness, dtype=torch.float32,
                      device=device)
    sigma = torch.tensor(cfg.sigma, dtype=torch.float32, device=device)
    inv_shape = tuple(cfg.inv_shape)
    joint = cfg.mode == "joint"
    locate = cfg.mode == "locate"
    events = joint or locate           # hypocentres and origin times
    sample_t0 = events and not cfg.marginalize_t0
    if events:
        n_ev, n_sta = data.t_obs.shape
    else:
        n_sta = data.t_obs.shape[1]          # the receivers
    D = grid.ndim
    hier = noise_model == "hierarchical"
    slab = noise_model == "spike_slab"
    # Shape of one chain's log_sigma (None: no noise leaves).
    ls_shape = None
    if slab or (hier and cfg.per_station_noise):
        ls_shape = (n_sta,)
    elif hier:
        ls_shape = ()

    fixed_tables = None
    if locate:
        if fixed_slowness is not None:
            s_fixed = torch.as_tensor(fixed_slowness, dtype=torch.float32,
                                      device=device)
        elif cfg.fixed_slowness_path:
            s_fixed = load_slowness(cfg.fixed_slowness_path, grid,
                                    device=device)
        else:
            s_fixed = bg * torch.ones(grid.shape, dtype=torch.float32,
                                      device=device)
        if tuple(s_fixed.shape) != tuple(grid.shape):
            raise ValueError(f"fixed slowness shape {tuple(s_fixed.shape)} "
                             f"!= grid {tuple(grid.shape)}")
        fixed_tables = cached_traveltime_tables(
            s_fixed, data.sta_xyz, grid, econf,
            cache_dir=cfg.table_cache_dir or None)

    def randn(gen, shape):
        # Drawn where the generator lives (a host generator gives the same
        # starts on every device).
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=gen.device).to(device)

    def slab_sigma(z, ls):
        """Spike-slab noise per chain and station, ``(C, 1, n_sta)``."""
        return sigma * torch.exp(z * ls)[:, None, :]

    def sigma_of(params: Params) -> torch.Tensor:
        """The noise, broadcastable against residuals ``(C, n_a, n_sta)``:
        the base sigma, times ``exp(log_sigma)`` (hierarchical) or
        ``exp(noise_z * log_sigma)`` per station (spike-slab)."""
        if hier:
            ls = params.log_sigma
            return sigma * torch.exp(ls.reshape(ls.shape[0], 1, -1))
        if slab:
            return slab_sigma(params.noise_z, params.log_sigma)
        return sigma

    def log_prior(params: Params) -> torch.Tensor:
        lp = 0.0
        if params.u is not None:
            lp = -0.5 * _per_chain_sum((params.u / cfg.prior_sigma_u) ** 2)
        if params.hypo_raw is not None:
            lp = lp + box_logjac(params.hypo_raw)
        if params.t0 is not None:
            lp = lp - 0.5 * _per_chain_sum((params.t0 / cfg.prior_sigma_t0) ** 2)
        if hier:
            lp = lp - 0.5 * _per_chain_sum((params.log_sigma / cfg.sigma_hyper) ** 2)
        elif slab:
            z = params.noise_z
            lp = lp + _per_chain_sum(z * math.log(cfg.noise_p0)
                                     + (1.0 - z) * math.log1p(-cfg.noise_p0))
            # The slab doubles as the pseudo-prior of inactive stations, so
            # one Gaussian term covers all of them.
            lp = lp - 0.5 * _per_chain_sum(
                ((params.log_sigma - cfg.noise_slab_mu) / cfg.sigma_hyper) ** 2)
        return lp

    def slowness_of(params: Params) -> Optional[torch.Tensor]:
        if locate:
            return None
        return slowness_from_u(params.u, grid, bg)

    def predict(params: Params) -> torch.Tensor:
        if not events:
            return predict_tomo(slowness_of(params), data.src_xyz,
                                data.rec_xyz, grid, econf,
                                differentiable=differentiable)
        hypo = box_from_raw(params.hypo_raw, grid)
        t0 = (params.t0 if params.t0 is not None
              else torch.zeros(hypo.shape[:-1], dtype=torch.float32,
                               device=device))
        if locate:
            # Every chain's events against the one set of fixed tables.
            C = hypo.shape[0]
            tt = interp_tables(fixed_tables, hypo.reshape(-1, D), grid)
            return tt.reshape(n_sta, C, n_ev).permute(1, 2, 0) + t0[..., None]
        tables = traveltime_tables(slowness_of(params), data.sta_xyz, grid,
                                   econf, differentiable=differentiable)
        return predict_events(tables, hypo, t0, grid)

    def residuals(params: Params):
        """``(r, mask)``: residuals ``(C, n_a, n_sta)`` from one predict,
        and the mask (or None)."""
        r = data.t_obs - predict(params)
        mask = data.mask
        return r, (mask.expand_as(r) if mask is not None else None)

    def lik_term(r, mask, sig):
        sig = sig.expand_as(r)
        if events and cfg.marginalize_t0:
            return _marginalized_t0_loglik(r, sig, mask)
        return _gaussian_loglik(r, sig, mask)

    def log_lik(params: Params) -> torch.Tensor:
        r, mask = residuals(params)
        return lik_term(r, mask, sigma_of(params))

    def logpost(params: Params) -> torch.Tensor:
        return log_prior(params) + log_lik(params)

    def init_noise(gen, n_chains: int, jitter: float):
        """``(log_sigma, noise_z)`` chain starts. Spike-slab chains start
        all-active (``z = 1``): with every station down-weighted alike the
        field converges under balanced weights and clean stations then flip
        off one by one, where an all-clean start lets a transiently misfit
        clean station flip on and lose the pull that would fit it (the
        reference's observation)."""
        if ls_shape is None:
            return None, None
        eps = randn(gen, (n_chains,) + ls_shape)
        if hier:
            return jitter * 0.1 * eps, None
        ls = cfg.noise_slab_mu + jitter * 0.1 * cfg.sigma_hyper * eps
        return ls, torch.ones((n_chains, n_sta), dtype=torch.float32,
                              device=device)

    def init_params(gen: torch.Generator, n_chains: int,
                    jitter: float = 1.0) -> Params:
        """Chain starts near the prior's centre, drawn in the order u (none
        in locate mode), hypo_raw, t0, log_sigma."""
        u = hypo_raw = t0 = None
        if not locate:
            u = (jitter * 0.1 * cfg.prior_sigma_u
                 * randn(gen, (n_chains,) + inv_shape))
        if events:
            hypo_raw = jitter * 0.5 * randn(gen, (n_chains, n_ev, D))
            t0 = (jitter * 0.1 * cfg.prior_sigma_t0
                  * randn(gen, (n_chains, n_ev)) if sample_t0 else None)
        ls, z = init_noise(gen, n_chains, jitter)
        return Params(u=u, hypo_raw=hypo_raw, t0=t0, log_sigma=ls, noise_z=z)

    def sample_prior(gen: torch.Generator, n: int) -> Params:
        """``n`` exact draws from the prior: ``u ~ N(0, prior_sigma_u^2 I)``,
        ``hypo_raw`` standard logistic (the uniform-in-box prior pushed
        through the inverse sigmoid), ``t0 ~ N(0, prior_sigma_t0^2)``,
        ``log_sigma ~ N(mu, sigma_hyper^2)`` (mu = 0, or ``noise_slab_mu``
        under spike-slab) and ``noise_z ~ Bernoulli(noise_p0)``; no ``u`` in
        locate mode."""
        u = hypo_raw = t0 = ls = z = None
        if not locate:
            u = cfg.prior_sigma_u * randn(gen, (n,) + inv_shape)
        if events:
            p = torch.rand((n, n_ev, D), generator=gen, dtype=torch.float32,
                           device=device).clamp(1e-7, 1.0 - 1e-7)
            hypo_raw = torch.log(p) - torch.log1p(-p)
            t0 = (cfg.prior_sigma_t0 * randn(gen, (n, n_ev)) if sample_t0
                  else None)
        if ls_shape is not None:
            mu = cfg.noise_slab_mu if slab else 0.0
            ls = mu + cfg.sigma_hyper * randn(gen, (n,) + ls_shape)
        if slab:
            z = (torch.rand((n, n_sta), generator=gen, dtype=torch.float32,
                            device=device) < cfg.noise_p0).to(torch.float32)
        return Params(u=u, hypo_raw=hypo_raw, t0=t0, log_sigma=ls, noise_z=z)

    def noise_gibbs(params: Params, uniforms: torch.Tensor,
                    fresh: torch.Tensor, beta: float = 1.0):
        """Systematic-scan Gibbs sweep over the station indicators of every
        chain, then a pseudo-prior refresh of the inactive slab values.

        Station ``j`` in turn takes ``z_j = 1`` iff ``uniforms[:, j] <
        sigmoid(log_odds0 + beta * (ll(z_j=1) - ll(z_j=0)))``, the other
        indicators at their current values: an exact conditional draw,
        ``beta`` tempering the likelihood ratio (annealed warmup, SMC). The
        residuals come from ONE predict and serve every toggle (the
        indicators never enter the eikonal solve); with t0 marginalized the
        stations couple, so each toggle recomputes the whole (cheap)
        reduction. Inactive stations' ``log_sigma`` is redrawn from the slab,
        its exact full conditional, as ``noise_slab_mu + sigma_hyper *
        fresh``. Returns ``(params, log_prior, log_lik)`` at the result."""
        with torch.no_grad():
            r, mask = residuals(params)
            ls = params.log_sigma
            z = params.noise_z.clone()

            def ll_z(zz):
                return lik_term(r, mask, slab_sigma(zz, ls))

            for j in range(n_sta):
                z_on, z_off = z.clone(), z.clone()
                z_on[:, j] = 1.0
                z_off[:, j] = 0.0
                logit = log_odds0 + beta * (ll_z(z_on) - ll_z(z_off))
                z[:, j] = (uniforms[:, j] < torch.sigmoid(logit)).to(z.dtype)
            ls_new = torch.where(z > 0, ls,
                                 cfg.noise_slab_mu + cfg.sigma_hyper * fresh)
            new = dataclasses.replace(params, noise_z=z, log_sigma=ls_new)
            return new, log_prior(new), lik_term(r, mask, sigma_of(new))

    log_odds0 = math.log(cfg.noise_p0) - math.log1p(-cfg.noise_p0)

    def jacobian(params: Params):
        """Every row of ``d t_pred / d params`` from ONE forward solve and
        ONE transport batch: row ``k`` is the VJP of observation ``k`` alone,
        whose cotangent lives in one table field, so the rows' fields are
        gathered into a batch of ``n_obs`` and pulled back together (the
        reference pulls back one-hot cotangents one row at a time). In
        joint and locate modes the hypocentre columns of row ``(e, s)`` are
        the slope of table ``s`` at event ``e``, and its ``t0`` column is 1;
        in locate mode those are all the columns (no ``u``, no solve: the
        slopes of the fixed tables)."""
        n_chains = (params.u if params.u is not None
                    else params.hypo_raw).shape[0]
        if n_chains != 1:
            raise ValueError(f"jacobian takes one chain, got {n_chains}")
        if events:
            pt = torch.arange(n_ev, device=device).repeat_interleave(n_sta)
        if locate:
            n_obs = n_ev * n_sta
            with torch.enable_grad():
                # One copy of the events per station, so that each (station,
                # event) slope is its own gradient.
                h = params.hypo_raw[0].detach().unsqueeze(0).expand(
                    n_sta, n_ev, D).clone().requires_grad_(True)
                idx = grid.to_index_coords(box_from_raw(h, grid))
                t_se = sample_linear(fixed_tables, idx)
                (g_h,) = torch.autograd.grad(t_se.sum(), [h])
            t_rows = t_se.detach().T.reshape(n_obs)          # rows (e, s)
            g_rows = g_h.transpose(0, 1).reshape(n_obs, D)
            blocks = []
        else:
            t_rows, J_u, g_rows = u_columns(params)
            n_obs = t_rows.shape[0]
            blocks = [J_u]
        if events:
            rows = torch.arange(n_obs, device=device)
            J_h = torch.zeros((n_obs, n_ev, D), dtype=torch.float32,
                              device=device)
            J_h[rows, pt] = g_rows
            blocks.append(J_h.reshape(n_obs, -1))
            if params.t0 is not None:
                t_rows = t_rows + params.t0[0].detach()[pt]
                J_t = torch.zeros((n_obs, n_ev), dtype=torch.float32,
                                  device=device)
                J_t[rows, pt] = 1.0
                blocks.append(J_t)
        # The noise leaves do not enter the prediction: zero columns.
        n_noise = sum(int(x[0].numel()) for x in (params.log_sigma,
                                                  params.noise_z)
                      if x is not None)
        if n_noise:
            blocks.append(torch.zeros((n_obs, n_noise), dtype=torch.float32,
                                      device=device))
        return t_rows, torch.cat(blocks, dim=1)

    def u_columns(params: Params):
        """``(t_rows, J_u, hypocentre slopes or None)`` of the tomo and
        joint Jacobians: one forward solve, then one transport batch of the
        rows' fields."""
        u = params.u
        if joint:
            n_a, n_b = n_ev, n_sta
            tab_xyz = data.sta_xyz
            pt = torch.arange(n_ev, device=device).repeat_interleave(n_sta)
            tab = torch.arange(n_sta, device=device).repeat(n_ev)
        elif data.src_xyz.shape[0] <= data.rec_xyz.shape[0]:
            # predict_tomo's "auto" choice: tables from the sources.
            n_a, n_b = data.src_xyz.shape[0], data.rec_xyz.shape[0]
            tab_xyz, pt_xyz = data.src_xyz, data.rec_xyz
            tab = torch.arange(n_a, device=device).repeat_interleave(n_b)
            pt = torch.arange(n_b, device=device).repeat(n_a)
        else:
            n_a, n_b = data.src_xyz.shape[0], data.rec_xyz.shape[0]
            tab_xyz, pt_xyz = data.rec_xyz, data.src_xyz
            tab = torch.arange(n_b, device=device).repeat(n_a)
            pt = torch.arange(n_a, device=device).repeat_interleave(n_b)
        n_obs = n_a * n_b
        with torch.no_grad():
            T = solve_eikonal_batched(slowness_of(params)[0], tab_xyz, grid,
                                      econf)
        with torch.enable_grad():
            u_rows = u.detach().expand((n_obs,) + inv_shape).requires_grad_(True)
            T_rows = solve_eikonal_diff_batched(
                slowness_of(Params(u=u_rows)), tab_xyz[tab], grid, econf,
                T=T[tab])
            wrt = [u_rows]
            if joint:
                h_rows = params.hypo_raw[0].detach()[pt].requires_grad_(True)
                wrt.append(h_rows)
                xyz = box_from_raw(h_rows, grid)
            else:
                xyz = pt_xyz[pt]
            idx = grid.to_index_coords(xyz).unsqueeze(1)
            t_rows = sample_linear(T_rows, idx)[:, 0]
            grads = torch.autograd.grad(t_rows.sum(), wrt)
        return (t_rows.detach(), grads[0].reshape(n_obs, -1),
                grads[1] if joint else None)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    # The indicators' scale 0 freezes them for every continuous kernel;
    # they move only through noise_gibbs.
    prior_scales = Params(
        u=None if locate else full(inv_shape, cfg.prior_sigma_u),
        hypo_raw=full((n_ev, D), 1.0) if events else None,
        t0=full((n_ev,), cfg.prior_sigma_t0) if sample_t0 else None,
        log_sigma=(full(ls_shape, cfg.sigma_hyper) if ls_shape is not None
                   else None),
        noise_z=full((n_sta,), 0.0) if slab else None)
    n_dim = sum(int(x.numel()) for x in tree_leaves(prior_scales))

    return PosteriorModel(
        logpost=logpost, init_params=init_params, slowness_of=slowness_of,
        predict=predict, grid=grid, cfg=cfg, n_dim=n_dim,
        prior_scales=prior_scales, log_prior=log_prior, log_lik=log_lik,
        sample_prior=sample_prior, jacobian=jacobian if differentiable else None,
        noise_gibbs=noise_gibbs if slab else None)


def noise_gibbs_draws(gen: torch.Generator, params: Params):
    """The draws of one ``noise_gibbs`` scan: a uniform per chain and
    station, and a standard normal per chain and station for the slab
    refresh."""
    z = params.noise_z
    return (torch.rand(z.shape, generator=gen, dtype=torch.float32,
                       device=z.device),
            torch.randn(z.shape, generator=gen, dtype=torch.float32,
                        device=z.device))


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
