"""Laplace / Gauss-Newton posterior approximation: MAP estimate and the
Gauss-Newton covariance, the preconditioner of MALA.

Counterpart of ``mceik_tpu/model/laplace.py``. The tomography and joint
posteriors over the unconstrained basis are near-Gaussian with covariance

    C = (P + J^T W J)^{-1},   J = d t_pred / d x  (n_obs x d),

P the prior precision and W the noise precision (for a t0-marginalized
joint likelihood, J's rows demeaned per event). The fit works on ONE
chain (params with a leading axis of 1), so these phases solve ``n_src``
fields at a time. The reference pulls J back one row at a time; here all
``n_obs`` rows are one batch (``PosteriorModel.jacobian``): one forward
solve and one transport solve of ``n_obs`` fields. The result is the same
J. The covariance only tunes the proposal: MH keeps the sampler exact
whatever its quality.
"""

from __future__ import annotations

import torch

from mceik_tpu_torch.model.posterior import value_and_grad
from mceik_tpu_torch.samplers.am_full import _ravel, _unravel_fn
from mceik_tpu_torch.utils import tree_leaves


def _flat_value_and_grad(post, example):
    """``x (1, d) -> (lp (1,), grad (1, d))`` for params shaped like
    ``example`` (one chain)."""
    unravel = _unravel_fn(example, batch_dims=1)
    vag = value_and_grad(post.logpost)

    def vg(x):
        lp, g = vag(unravel(x))
        return lp, _ravel(g, batch_dims=1)

    return vg


# Adam's learning rate and the damped Newton step's halving budget.
LR = 0.02
MAX_HALVINGS = 8


def map_estimate(post, n_steps: int = 150):
    """Adam ascent on logpost from the prior mean (one chain), in a plain
    loop of ``n_steps`` steps (the reference runs 25-step scans, so it
    rounds ``n_steps`` up to a multiple of 25). Frozen coordinates take
    zero steps. Returns ``(params_map, logpost trace)``."""
    dev = tree_leaves(post.prior_scales)[0].device
    init_params = post.init_params(
        torch.Generator(device=dev).manual_seed(0), 1, jitter=0.0)
    x = _ravel(init_params, batch_dims=1)
    dev = x.device
    active = (_ravel(post.prior_scales) > 0).to(torch.float32)
    vg = _flat_value_and_grad(post, init_params)
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    b1 = torch.tensor(0.9, dtype=torch.float32, device=dev)
    b2 = torch.tensor(0.999, dtype=torch.float32, device=dev)
    vals = []
    for i in range(n_steps):
        val, g = vg(x)
        g = -g * active
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        t = torch.tensor(float(i + 1), dtype=torch.float32, device=dev)
        mh = m / (1.0 - b1 ** t)
        vh = v / (1.0 - b2 ** t)
        x = x - LR * mh / (torch.sqrt(vh) + 1e-8)
        vals.append(val[0])
    trace = torch.stack(vals).tolist() if vals else []
    return _unravel_fn(init_params, batch_dims=1)(x), trace


def gauss_newton_covariance(post, params) -> torch.Tensor:
    """Gauss-Newton posterior covariance at ``params`` (one chain), over the
    full flattened dimension d, with the model's base noise ``cfg.sigma``
    under every noise model (as the reference: a preconditioner needs no
    more; the noise leaves get their prior variance): frozen coordinates
    get a unit diagonal and zero cross terms, as MALA's Cholesky expects."""
    scales = _ravel(post.prior_scales)
    active = scales > 0
    t_pred, J = post.jacobian(params)
    n_obs = t_pred.shape[0]
    J = torch.where(active[None, :], J, 0.0)
    sig = torch.tensor(post.cfg.sigma, dtype=torch.float32, device=J.device)
    w = (1.0 / sig ** 2).expand(n_obs)
    if post.cfg.mode != "tomo" and post.cfg.marginalize_t0:
        # The exact GN curvature of the t0-marginalized likelihood: per
        # event, the precision-weighted mean of its rows is taken out.
        n_ev = post.prior_scales.hypo_raw.shape[0]
        Je = J.reshape(n_ev, n_obs // n_ev, -1)
        we = w.reshape(n_ev, -1)
        sw = torch.clamp(we.sum(1, keepdim=True), min=1e-20)
        wJ = torch.einsum("es,esd->ed", we, Je) / sw
        J = (Je - wJ[:, None, :]).reshape(n_obs, -1)
    prior_prec = torch.where(active, 1.0 / torch.clamp(scales, min=1e-20) ** 2,
                             1.0)
    H = torch.diag(prior_prec) + (J.T * w[None, :]) @ J
    # Inverted through H's Cholesky factor, not by LU as the reference
    # does: C comes out symmetric and as a Gram product of the factor's
    # inverse, so it stays positive definite at the fp32 conditioning of
    # the c2 problems, where the LU inverse already shows negative
    # eigenvalues and a Cholesky of it can fail.
    C = torch.cholesky_inverse(torch.linalg.cholesky(H))
    act = active.to(C.dtype)
    return C * act[:, None] * act[None, :] + torch.diag(1.0 - act)


def newton_refine(post, params, cov: torch.Tensor, n_steps: int = 12):
    """Damped Gauss-Newton refinement ``x <- x + alpha C grad(x)``, halving
    ``alpha`` until logpost improves (a host loop; each try is one gradient
    of one chain). Stops when no halving improves or the gain falls under
    0.01. Returns ``(params, logpost trace)``."""
    x = _ravel(params, batch_dims=1)
    active = (_ravel(post.prior_scales) > 0).to(torch.float32)
    vg = _flat_value_and_grad(post, params)
    cov = torch.as_tensor(cov, dtype=torch.float32, device=x.device)
    lp, g = vg(x)
    trace = [float(lp[0])]
    for _ in range(n_steps):
        direction = (g * active) @ cov.T
        alpha, ok = 1.0, False
        for _ in range(MAX_HALVINGS):
            x_try = x + alpha * direction
            lp_try, g_try = vg(x_try)
            if bool(lp_try[0] > lp[0]):
                ok = True
                break
            alpha *= 0.5
        if not ok:
            break  # no improving step along this direction: converged
        x, lp, g = x_try, lp_try, g_try
        trace.append(float(lp[0]))
        if trace[-1] - trace[-2] < 0.01:
            break
    return _unravel_fn(params, batch_dims=1)(x), trace


def laplace_preconditioner(post, n_map_steps: int = 150):
    """Adam MAP ascent -> GN covariance -> damped Newton refinement -> the
    covariance again at the refined MAP. Returns
    ``(params_map, cov, logpost trace)``."""
    p_map, trace = map_estimate(post, n_steps=n_map_steps)
    cov = gauss_newton_covariance(post, p_map)
    p_map, ntrace = newton_refine(post, p_map, cov)
    cov = gauss_newton_covariance(post, p_map)
    return p_map, cov, trace + ntrace
