"""Parity of the PyTorch port's posterior and adaptive-Metropolis pieces with
the JAX package on the CPU: the chain-batched logpost against JAX's logpost
per chain, AM steps with JAX's own random draws replayed (accept decisions
and states must match in fp32), the warmup adapter, dual averaging and the
Welford moments. State crosses over through ``mceik_tpu_torch.convert``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mceik_tpu.config import DataCfg as JDataCfg
from mceik_tpu.config import EikonalCfg as JEikonalCfg
from mceik_tpu.config import ModelCfg as JModelCfg
from mceik_tpu.datasets.synthetic import checkerboard3d_dataset as j_dataset
from mceik_tpu.diag import moments as jmom
from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.model.params import Params as JParams
from mceik_tpu.model.posterior import build_posterior as j_build_posterior
from mceik_tpu.samplers import am as jam
from mceik_tpu.samplers.base import MHState as JMHState
from mceik_tpu.samplers.hmc import DualAveraging as JDA
from mceik_tpu.samplers.hmc import dual_averaging_update as j_da_update

from mceik_tpu_torch.config import EikonalCfg, ModelCfg
from mceik_tpu_torch.convert import (am_hyper_from_jax, params_from_jax,
                                     tomo_data_from_jax)
from mceik_tpu_torch.diag import moments as tmom
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.params import Params
from mceik_tpu_torch.model.posterior import build_posterior
from mceik_tpu_torch.samplers import am
from mceik_tpu_torch.samplers.base import MHState
from mceik_tpu_torch.samplers.hmc import DualAveraging, dual_averaging_update


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
N_CHAINS = 3


@pytest.fixture(scope="module")
def models():
    """One small config-2 problem in both packages, on JAX's data."""
    kw = dict(dataset="checkerboard3d", n_src=2, n_rec=3, noise=0.01,
              checker_cells=(3, 3, 3), checker_amplitude=0.1)
    mkw = dict(mode="tomo", inv_shape=INV, prior_sigma_u=0.2, sigma=0.01)
    ekw = dict(tol=1e-5, max_iters=60)
    jgrid = JGrid(SHAPE, (1.0,) * 3)
    jdata, _ = j_dataset(jgrid, JDataCfg(**kw), JModelCfg(**mkw))
    jpost = j_build_posterior(JModelCfg(**mkw), jdata, jgrid,
                              JEikonalCfg(**ekw))
    tpost = build_posterior(ModelCfg(**mkw), tomo_data_from_jax(jdata),
                            Grid(SHAPE, (1.0,) * 3), EikonalCfg(**ekw))
    jlp = jax.jit(jax.vmap(jpost.logpost))
    return jpost, tpost, jlp


def _u(seed, scale=0.05):
    return np.random.default_rng(seed).normal(
        0, scale, (N_CHAINS,) + INV).astype(np.float32)


def test_logpost_batched_matches_jax_per_chain(models):
    """One batched call over 3 chains against JAX's logpost per chain, at
    rtol 2e-5: the reference's own CPU-vs-TPU agreement (~2e-5, verify
    SKILL). XLA contracts multiply-adds into FMAs inside its compiled sweep
    loops and torch does not, so the fixed points differ at the ulp level
    (~4e-6 at 16^3), which residuals at sigma 0.01 amplify to up to ~1.3e-5
    relative on logpost (12 chains measured, any solver tol)."""
    jpost, tpost, _ = models
    u = _u(0)
    ref = np.array([float(jpost.logpost(JParams(u=jnp.asarray(x)))) for x in u])
    out = tpost.logpost(Params(u=torch.from_numpy(u)))
    assert out.shape == (N_CHAINS,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5)
    ref_prior = np.array([float(jpost.log_prior(JParams(u=jnp.asarray(x))))
                          for x in u])
    np.testing.assert_allclose(tpost.log_prior(Params(u=torch.from_numpy(u))).numpy(),
                               ref_prior, rtol=1e-6)
    assert tpost.n_dim == jpost.n_dim


def _ready_hyper(jpost):
    """A JAX AM hyper whose pooled Welford is past its 50-sample threshold,
    so the adapted proposal std is in play."""
    rng = np.random.default_rng(9)
    h = jam.init_hyper(jpost.prior_scales, 0.05,
                       jpost.init_params(jax.random.PRNGKey(0)))
    m2 = rng.uniform(0.5, 2.0, INV).astype(np.float32) * 60 * 0.01
    return h.replace(welford=h.welford.replace(
        count=jnp.float32(60.0), m2=JParams(u=jnp.asarray(m2))))


@pytest.mark.parametrize("ready", [False, True])
def test_am_steps_replay_jax_draws(models, ready):
    """Four AM warmup steps (kernel + adapter) with JAX's draws replayed:
    k_prop, k_acc = split(key) per chain as am.py draws them. Accept
    decisions must match; params at atol 1e-6, logpost at rtol 2e-5 (see
    the logpost test), the adapted hyper at rtol 1e-5."""
    jpost, tpost, jlp = models
    jhyper = (_ready_hyper(jpost) if ready else
              jam.init_hyper(jpost.prior_scales, 0.05,
                             jpost.init_params(jax.random.PRNGKey(0))))
    thyper = am_hyper_from_jax(jhyper)
    u0 = _u(1, scale=0.02)
    jstate = JMHState(params=JParams(u=jnp.asarray(u0)),
                      logpost=jlp(JParams(u=jnp.asarray(u0))))
    tstate = MHState(params=params_from_jax(jstate.params),
                     logpost=torch.from_numpy(np.asarray(jstate.logpost)))
    jkernel = jax.jit(jax.vmap(jam.make_kernel(jpost.logpost),
                               in_axes=(0, 0, None)))
    jadapt, tadapt = jam.make_adapter(), am.make_adapter()
    tkernel = am.make_kernel(tpost.logpost)
    decisions = []
    for t in range(4):
        keys = jax.random.split(jax.random.PRNGKey(100 + t), N_CHAINS)
        eps, unif = [], []
        for k in keys:
            k_prop, k_acc = jax.random.split(k)
            eps.append(np.asarray(jax.random.normal(
                jax.random.split(k_prop, 1)[0], INV, jnp.float32)))
            unif.append(float(jax.random.uniform(k_acc)))
        jstate, jinfo = jkernel(keys, jstate, jhyper)
        tstate, tinfo = tkernel(tstate, thyper,
                                Params(u=torch.from_numpy(np.stack(eps))),
                                torch.tensor(unif, dtype=torch.float32))
        acc = np.asarray(jinfo["accepted"])
        np.testing.assert_array_equal(tinfo["accepted"].numpy(), acc)
        np.testing.assert_allclose(tstate.params.u.numpy(),
                                   np.asarray(jstate.params.u), atol=1e-6)
        np.testing.assert_allclose(tstate.logpost.numpy(),
                                   np.asarray(jstate.logpost), rtol=2e-5)
        decisions.extend(acc.tolist())
        jhyper = jadapt(jhyper, jax.tree.map(lambda x: jnp.mean(x, 0), jinfo),
                        jstate, jnp.int32(t))
        thyper = tadapt(thyper, {k: v.mean(0) for k, v in tinfo.items()},
                        tstate, t)
        for a, b in [(thyper.log_step, jhyper.log_step),
                     (thyper.da.log_eps_bar, jhyper.da.log_eps_bar),
                     (thyper.welford.count, jhyper.welford.count),
                     (thyper.welford.m2.u, jhyper.welford.m2.u)]:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
    assert 0 < sum(decisions) < len(decisions), decisions
    np.testing.assert_allclose(am.finalize(thyper).log_step.numpy(),
                               np.asarray(jam.finalize(jhyper).log_step),
                               rtol=1e-6)


def test_dual_averaging_matches_jax():
    """30 updates from random pooled acceptances, gamma 0.1 and t0 20 as AM
    calls it: rtol 1e-6."""
    acc = np.random.default_rng(3).uniform(0, 1, 30).astype(np.float32)
    le = float(np.log(np.float32(0.05)))
    jda = JDA(mu=jnp.float32(le), log_eps=jnp.float32(le),
              log_eps_bar=jnp.float32(le), h_bar=jnp.float32(0.0))
    tda = DualAveraging(*(torch.tensor(x, dtype=torch.float32)
                          for x in (le, le, le, 0.0)))
    for t, a in enumerate(acc):
        jda = j_da_update(jda, jnp.float32(a), jnp.int32(t), target=0.234,
                          gamma=0.1, t0=20.0)
        tda = dual_averaging_update(tda, torch.tensor(a), t, target=0.234,
                                    gamma=0.1, t0=20.0)
    for f in ("log_eps", "log_eps_bar", "h_bar"):
        np.testing.assert_allclose(getattr(tda, f).numpy(),
                                   np.asarray(getattr(jda, f)), rtol=1e-6)


def test_welford_matches_jax():
    """Per-chain updates, batch (Chan) merges, the cross-chain pool and the
    finalized moments, on a tree of params + a derived field: rtol 1e-5."""
    rng = np.random.default_rng(4)
    xs = rng.normal(1.0, 2.0, (7, N_CHAINS, 4, 3)).astype(np.float32)
    ys = rng.normal(-1.0, 0.5, (7, N_CHAINS, 5)).astype(np.float32)

    def jtree(x, y):
        return {"params": JParams(u=jnp.asarray(x)), "slowness": jnp.asarray(y)}

    def ttree(x, y):
        return {"params": Params(u=torch.from_numpy(x)),
                "slowness": torch.from_numpy(y)}

    jw = jmom.welford_init(jtree(xs[0, 0], ys[0, 0]), batch_shape=(N_CHAINS,))
    tw = tmom.welford_init(ttree(xs[0, 0], ys[0, 0]), batch_shape=(N_CHAINS,))
    for x, y in zip(xs, ys):
        jw = jmom.welford_update(jw, jtree(x, y))
        tw = tmom.welford_update(tw, ttree(x, y))
    jp, tp = jmom.welford_merge_chains(jw), tmom.welford_merge_chains(tw)
    jm, jv = jmom.welford_finalize(jp)
    tm, tv = tmom.welford_finalize(tp)
    for a, b in [(tm["params"].u, jm["params"].u), (tv["slowness"], jv["slowness"]),
                 (tv["params"].u, jv["params"].u), (tp.count, jp.count)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)

    jb = jmom.welford_init(JParams(u=jnp.asarray(xs[0, 0])))
    tb = tmom.welford_init(Params(u=torch.from_numpy(xs[0, 0])))
    for x in xs:
        jb = jmom.welford_update_batch(jb, JParams(u=jnp.asarray(x)))
        tb = tmom.welford_update_batch(tb, Params(u=torch.from_numpy(x)))
    np.testing.assert_allclose(tb.mean.u.numpy(), np.asarray(jb.mean.u), rtol=1e-5)
    np.testing.assert_allclose(tb.m2.u.numpy(), np.asarray(jb.m2.u), rtol=1e-5)
    np.testing.assert_allclose(tb.m2.u.numpy() / (tb.count.numpy() - 1),
                               xs.reshape(-1, 4, 3).var(0, ddof=1), rtol=1e-4)


@pytest.mark.parametrize("coarse,fine", [((3, 3, 2), (12, 12, 10)),
                                         ((12, 12, 12), (64, 64, 64)),
                                         ((16, 16), (65, 65))])
def test_upsample_backward_is_the_separable_transpose(coarse, fine):
    """The upsampling of ``slowness_from_u`` (``params._Upsample``): the
    forward is ``F.interpolate``'s bit for bit; the backward, one matrix
    product per axis with ``linear_resample_matrix`` (whose products also
    give the forward within 1e-6 of its max), is ``F.interpolate``'s
    gradient within 2e-6 of its max, and the same bits on every call. The
    matrices are device-independent, and every device runs this code."""
    import torch.nn.functional as F
    from mceik_tpu_torch.model.params import _Upsample, linear_resample_matrix

    gen = torch.Generator().manual_seed(len(fine))
    x = torch.randn((3,) + coarse, generator=gen).requires_grad_(True)
    y = _Upsample.apply(x, fine)
    x_ref = x.detach().clone().requires_grad_(True)
    y_ref = F.interpolate(x_ref.unsqueeze(1), size=fine,
                          mode={2: "bilinear", 3: "trilinear"}[len(fine)],
                          align_corners=False).squeeze(1)
    assert torch.equal(y, y_ref)
    t = x.detach()
    for d in range(len(fine)):
        A = linear_resample_matrix(coarse[d], fine[d], "cpu")
        assert torch.allclose(A.sum(1), torch.ones(fine[d]))
        t = torch.tensordot(t, A, dims=([d + 1], [1])).movedim(-1, d + 1)
    assert float((t - y_ref).abs().max()) <= 1e-6 * float(y_ref.abs().max())
    g = torch.randn(y.shape, generator=gen)
    (a,) = torch.autograd.grad(y, x, g)
    (b,) = torch.autograd.grad(y_ref, x_ref, g)
    assert float((a - b).abs().max()) <= 2e-6 * float(b.abs().max())
    (again,) = torch.autograd.grad(_Upsample.apply(x, fine), x, g)
    assert torch.equal(again, a)
