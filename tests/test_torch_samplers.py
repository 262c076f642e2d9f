"""Parity of the PyTorch port's full-covariance AM and MALA with the JAX
package on the CPU: kernel steps with JAX's own random draws replayed (accept
decisions equal, states at fp32 tolerance), the warmup adapters, finalize
and prime_covariance, with hypers both unready (prior-scale proposal) and
primed (a learned covariance in play). State crosses over through
``mceik_tpu_torch.convert``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mceik_tpu.config import DataCfg as JDataCfg
from mceik_tpu.config import EikonalCfg as JEikonalCfg
from mceik_tpu.config import ModelCfg as JModelCfg
from mceik_tpu.datasets.synthetic import checkerboard3d_dataset as j_dataset
from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.model.params import Params as JParams
from mceik_tpu.model.posterior import build_posterior as j_build_posterior
from mceik_tpu.samplers import am_full as jam_full
from mceik_tpu.samplers import mala as jmala
from mceik_tpu.samplers.base import MHState as JMHState

from mceik_tpu_torch.config import EikonalCfg, ModelCfg
from mceik_tpu_torch.convert import (am_full_hyper_from_jax,
                                     mala_state_from_jax, params_from_jax,
                                     tomo_data_from_jax)
from mceik_tpu_torch.eikonal import adjoint_sweep
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.params import Params
from mceik_tpu_torch.model.posterior import build_posterior, value_and_grad
from mceik_tpu_torch.samplers import am_full, mala
from mceik_tpu_torch.samplers.base import MHState


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain CPU solves here are thousands of tiny ops on small grids:
    one intra-op thread runs them as fast, and keeps them from contending
    with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = (16, 16, 16)
INV = (4, 4, 4)
D = 64
N_CHAINS = 3


@pytest.fixture(scope="module")
def models():
    """The small config-2 problem of test_torch_model.py, differentiable, in
    both packages, on JAX's data."""
    kw = dict(dataset="checkerboard3d", n_src=2, n_rec=3, noise=0.01,
              checker_cells=(3, 3, 3), checker_amplitude=0.1)
    mkw = dict(mode="tomo", inv_shape=INV, prior_sigma_u=0.2, sigma=0.01)
    ekw = dict(tol=1e-5, max_iters=60)
    jgrid = JGrid(SHAPE, (1.0,) * 3)
    jdata, _ = j_dataset(jgrid, JDataCfg(**kw), JModelCfg(**mkw))
    jpost = j_build_posterior(JModelCfg(**mkw), jdata, jgrid,
                              JEikonalCfg(**ekw), differentiable=True)
    tpost = build_posterior(ModelCfg(**mkw), tomo_data_from_jax(jdata),
                            Grid(SHAPE, (1.0,) * 3), EikonalCfg(**ekw),
                            differentiable=True)
    return jpost, tpost, jdata


def _u(seed, scale=0.02):
    return np.random.default_rng(seed).normal(
        0, scale, (N_CHAINS,) + INV).astype(np.float32)


# XLA contracts FMAs in its sweep and torch does not, so the two packages'
# fixed points differ at the ulp level (~4e-6 at 16^3, ROADMAP Queue 3).
# The logpost moves by sum_obs |r| / sigma^2 per unit of traveltime, which
# at the 10-40 sigma residuals of these states makes the gap 3e-6 to 3e-4
# relative (measured over the states these replays visit): a relative bar
# does not fit. The bar is that sensitivity times a traveltime gap of 1e-5.
T_GAP = 1e-5
SIGMA = 0.01


def _lp_bar(jpost, jdata, jparams):
    """Per-chain logpost bar at JAX's state: T_GAP * sum |r| / sigma^2."""
    r = np.asarray(jdata.t_obs)[None] - np.asarray(jax.vmap(jpost.predict)(jparams))
    return T_GAP * np.abs(r).reshape(r.shape[0], -1).sum(1) / SIGMA ** 2


def _spd(seed, scale):
    """A random SPD covariance with marginal sd ~ ``scale``."""
    a = np.random.default_rng(seed).normal(0, 1, (D, D))
    c = a @ a.T / D + 0.5 * np.eye(D)
    return (scale ** 2 * c).astype(np.float32)


def _draws(t):
    """JAX's per-chain draws as the kernels take them: k_prop, k_acc =
    split(key); a flat normal from k_prop and a uniform from k_acc."""
    keys = jax.random.split(jax.random.PRNGKey(200 + t), N_CHAINS)
    eps, unif = [], []
    for k in keys:
        k_prop, k_acc = jax.random.split(k)
        eps.append(np.asarray(jax.random.normal(k_prop, (D,), jnp.float32)))
        unif.append(float(jax.random.uniform(k_acc)))
    normal = Params(u=torch.from_numpy(np.stack(eps).reshape((-1,) + INV)))
    return keys, normal, torch.tensor(unif, dtype=torch.float32)


def _close(a, b, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


def _accept_bar(bar_old, bar_new):
    """Accept probabilities are exp(min(log ratio, 0)), 1-Lipschitz in the
    log ratio, a difference of two logposts each within its bar."""
    return float(np.max(bar_old + bar_new))


def _check_adapted(thyper, jhyper, t, accept_bar):
    """The dual-averaging tuner moves log_step by sqrt(t + 1) / gamma
    (gamma 0.1) times the running mean of the pooled accept probability, so
    its bar is that gain times the accept bar. The covariance accumulator
    (positions only) at 1e-5 of its largest entry. Returns the port's hyper
    with JAX's tuner state carried over, so that the next replayed step
    starts from the same step size (a few percent of step size would
    otherwise show in the next proposal)."""
    bar = 10.0 * np.sqrt(t + 1.0) * accept_bar
    for a, b in [(thyper.log_step, jhyper.log_step),
                 (thyper.da.log_eps_bar, jhyper.da.log_eps_bar)]:
        _close(a, b, rtol=0, atol=bar)
    for f in ("count", "mean", "m2"):
        b = np.asarray(getattr(jhyper, f))
        _close(getattr(thyper, f), b, rtol=1e-5,
               atol=1e-5 * float(np.abs(b).max()))
    synced = am_full_hyper_from_jax(jhyper)
    return dataclasses.replace(thyper, log_step=synced.log_step, da=synced.da)


@pytest.mark.parametrize("ready", [False, True])
def test_am_full_steps_replay_jax_draws(models, ready):
    """Four am_full warmup steps (kernel + adapter) with JAX's draws
    replayed. Accept decisions equal; params at atol 1e-5; logpost,
    accept probabilities, the tuner and the covariance accumulator at the
    bars above. ``ready``: the pooled covariance holds more than 2d
    samples, so the learned full covariance drives the proposal."""
    jpost, tpost, jdata = models
    jhyper = jam_full.init_hyper(jpost.prior_scales, 0.3,
                                 jpost.init_params(jax.random.PRNGKey(0)))
    if ready:
        jhyper = jhyper.replace(count=jnp.float32(200.0),
                                mean=jnp.asarray(_u(7)[0].ravel()),
                                m2=jnp.asarray(199.0 * _spd(8, 0.02)))
    thyper = am_full_hyper_from_jax(jhyper)
    u0 = _u(1)
    jlp = jax.jit(jax.vmap(jpost.logpost))
    jstate = JMHState(params=JParams(u=jnp.asarray(u0)),
                      logpost=jlp(JParams(u=jnp.asarray(u0))))
    tstate = MHState(params=params_from_jax(jstate.params),
                     logpost=torch.from_numpy(np.asarray(jstate.logpost)))
    jkernel = jax.jit(jax.vmap(jam_full.make_kernel(jpost.logpost),
                               in_axes=(0, 0, None)))
    jadapt, tadapt = jam_full.make_adapter(), am_full.make_adapter()
    tkernel = am_full.make_kernel(tpost.logpost)
    decisions, bar = [], 0.0
    for t in range(4):
        keys, normal, unif = _draws(t)
        bar_old = _lp_bar(jpost, jdata, jstate.params)
        jstate, jinfo = jkernel(keys, jstate, jhyper)
        bar_new = _lp_bar(jpost, jdata, jstate.params)
        bar = max(bar, _accept_bar(bar_old, bar_new))
        tstate, tinfo = tkernel(tstate, thyper, normal, unif)
        acc = np.asarray(jinfo["accepted"])
        np.testing.assert_array_equal(tinfo["accepted"].numpy(), acc)
        _close(tstate.params.u, jstate.params.u, rtol=0, atol=1e-5)
        assert np.all(np.abs(tstate.logpost.numpy() - np.asarray(jstate.logpost))
                      <= bar_new)
        _close(tinfo["accept_prob"], jinfo["accept_prob"], rtol=0,
               atol=bar)
        decisions.extend(acc.tolist())
        jhyper = jadapt(jhyper, jax.tree.map(lambda x: jnp.mean(x, 0), jinfo),
                        jstate, jnp.int32(t))
        thyper = tadapt(thyper, {k: v.mean(0) for k, v in tinfo.items()},
                        tstate, t)
        thyper = _check_adapted(thyper, jhyper, t, bar)
    assert 0 < sum(decisions) < len(decisions), decisions
    np.testing.assert_array_equal(am_full.finalize(thyper).log_step.numpy(),
                                  thyper.da.log_eps_bar.numpy())
    _close(am_full._proposal_chol(thyper), jam_full._proposal_chol(jhyper),
           rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("primed", [False, True])
def test_mala_steps_replay_jax_draws(models, primed):
    """Three MALA warmup steps (kernel with its cached gradients + adapter)
    with JAX's draws replayed, from one JAX state (gradients included).
    Accept decisions equal; params at atol 1e-5; logpost, accept
    probabilities, the tuner and the covariance accumulator at the bars
    above. ``primed``: a covariance pinned by ``prime_covariance`` (as the
    Laplace setup does) and ``adapt_cov=False``; otherwise the prior-scale
    proposal and the adapting Welford."""
    jpost, tpost, jdata = models
    step = 0.3 if primed else 0.01
    jhyper = jmala.init_hyper(jpost.prior_scales, step,
                              jpost.init_params(jax.random.PRNGKey(0)))
    if primed:
        cov = _spd(9, 0.004)
        jhyper = jmala.prime_covariance(jhyper, jnp.asarray(cov))
        thyper = mala.prime_covariance(
            am_full_hyper_from_jax(jmala.init_hyper(
                jpost.prior_scales, step,
                jpost.init_params(jax.random.PRNGKey(0)))),
            torch.from_numpy(cov))
        _close(thyper.m2, jhyper.m2, rtol=1e-6)
        _close(thyper.count, jhyper.count, rtol=0)
    else:
        thyper = am_full_hyper_from_jax(jhyper)
    u0 = _u(1)
    jvg = jax.jit(jax.vmap(jax.value_and_grad(jpost.logpost)))
    lp0, g0 = jvg(JParams(u=jnp.asarray(u0)))
    jstate = jmala.MALAState(params=JParams(u=jnp.asarray(u0)), logpost=lp0,
                             grad=g0)
    tstate = mala_state_from_jax(jstate)
    jkernel = jax.jit(jax.vmap(jmala.make_kernel(jpost.logpost),
                               in_axes=(0, 0, None)))
    tkernel = mala.make_kernel(tpost.logpost)
    jadapt = jmala.make_adapter(adapt_cov=not primed)
    tadapt = mala.make_adapter(adapt_cov=not primed)
    decisions, bar = [], 0.0
    for t in range(3):
        keys, normal, unif = _draws(t)
        bar_old = _lp_bar(jpost, jdata, jstate.params)
        jstate, jinfo = jkernel(keys, jstate, jhyper)
        bar_new = _lp_bar(jpost, jdata, jstate.params)
        bar = max(bar, _accept_bar(bar_old, bar_new))
        tstate, tinfo = tkernel(tstate, thyper, normal, unif)
        acc = np.asarray(jinfo["accepted"])
        np.testing.assert_array_equal(tinfo["accepted"].numpy(), acc)
        _close(tstate.params.u, jstate.params.u, rtol=0, atol=1e-5)
        assert np.all(np.abs(tstate.logpost.numpy() - np.asarray(jstate.logpost))
                      <= bar_new)
        _close(tinfo["accept_prob"], jinfo["accept_prob"], rtol=0,
               atol=bar)
        decisions.extend(acc.tolist())
        jhyper = jadapt(jhyper, jax.tree.map(lambda x: jnp.mean(x, 0), jinfo),
                        jstate, jnp.int32(t))
        thyper = tadapt(thyper, {k: v.mean(0) for k, v in tinfo.items()},
                        tstate, t)
        thyper = _check_adapted(thyper, jhyper, t, bar)
    assert 0 < sum(decisions) < len(decisions), decisions
    np.testing.assert_array_equal(mala.finalize(thyper).log_step.numpy(),
                                  thyper.da.log_eps_bar.numpy())


def test_nan_lambda_reaches_mala_and_is_rejected(models, monkeypatch):
    """A transport solve that diverges for one field (chain 1's first
    source; made to grow a hundredfold per cycle here) poisons that field's
    lambda with NaN. The NaN must reach the sampler unmasked: chain 1's
    gradient is NaN and only chain 1's, and MALA rejects chain 1 and keeps
    its state, logpost and cached gradient. The state is lifted from a
    plain MH state by ``from_mh_states``. (These CPU tensors take the
    reference's CPU route, the plain transport cycle, which is where the
    divergence is made.)"""
    jpost, tpost, _ = models
    u = Params(u=torch.from_numpy(_u(4)))
    state = mala.from_mh_states(tpost.logpost,
                                MHState(params=u, logpost=tpost.logpost(u)))
    plain = adjoint_sweep.transport_cycle_plain

    def diverging(lam, g, ws, n_inner, done):
        out = plain(lam, g, ws, n_inner, done)
        out[2] = 100.0 * out[2]
        return out

    monkeypatch.setattr(adjoint_sweep, "transport_cycle_plain", diverging)
    lp, grad = value_and_grad(tpost.logpost)(state.params)
    assert torch.isfinite(lp).all()
    assert torch.isnan(grad.u[1]).all()
    assert torch.isfinite(grad.u[[0, 2]]).all()

    hyper = am_full_hyper_from_jax(jmala.init_hyper(
        jpost.prior_scales, 0.01, jpost.init_params(jax.random.PRNGKey(0))))
    _, normal, _ = _draws(0)
    new, info = mala.make_kernel(tpost.logpost)(
        state, hyper, normal, torch.full((N_CHAINS,), 1e-6))
    assert float(info["accepted"][1]) == 0.0
    assert float(info["accept_prob"][1]) == 0.0
    assert torch.isfinite(info["accept_prob"]).all()
    assert torch.equal(new.params.u[1], state.params.u[1])
    assert torch.equal(new.grad.u[1], state.grad.u[1])
    assert float(new.logpost[1]) == float(state.logpost[1])
