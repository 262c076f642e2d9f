"""Parity of the PyTorch port's Laplace / Gauss-Newton fit with the JAX
package on the CPU, at the size of tests/test_mala_api.py (12^3 grid, 3^3
basis, 4 sources, 5 receivers, on JAX's data): the Adam MAP trace, the
batched Gauss-Newton Jacobian against a row-by-row one and against JAX's,
the covariance (symmetric, positive definite, frozen coordinates unit and
uncoupled) and the damped Newton refinement."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mceik_tpu.config import DataCfg as JDataCfg
from mceik_tpu.config import EikonalCfg as JEikonalCfg
from mceik_tpu.config import ModelCfg as JModelCfg
from mceik_tpu.datasets import make_dataset as j_make_dataset
from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.model import laplace as jlap
from mceik_tpu.model.params import Params as JParams
from mceik_tpu.model.posterior import build_posterior as j_build_posterior

from mceik_tpu_torch.config import EikonalCfg, ModelCfg
from mceik_tpu_torch.convert import tomo_data_from_jax
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model import laplace
from mceik_tpu_torch.model.params import Params
from mceik_tpu_torch.model.posterior import build_posterior


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain CPU solves here are thousands of tiny ops on small grids:
    one intra-op thread runs them as fast, and keeps them from contending
    with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = (12, 12, 12)
INV = (3, 3, 3)


@pytest.fixture(scope="module")
def models():
    mkw = dict(mode="tomo", inv_shape=INV, background_slowness=1.0,
               prior_sigma_u=0.15, sigma=0.05)
    ekw = dict(method="sweep", tol=1e-3, max_iters=30, use_pallas="off")
    jgrid = JGrid(SHAPE, (1.0,) * 3)
    jdata, _ = j_make_dataset(jgrid, JDataCfg(
        dataset="checkerboard3d_volume", n_src=4, n_rec=5, noise=0.05, seed=42,
        checker_cells=(2, 2, 2), checker_amplitude=0.08), JModelCfg(**mkw))
    jpost = j_build_posterior(JModelCfg(**mkw), jdata, jgrid,
                              JEikonalCfg(**ekw), differentiable=True)
    tpost = build_posterior(ModelCfg(**mkw), tomo_data_from_jax(jdata),
                            Grid(SHAPE, (1.0,) * 3), EikonalCfg(**ekw),
                            differentiable=True)
    u = np.random.default_rng(0).normal(0, 0.05, INV).astype(np.float32)
    return jpost, tpost, u


def test_map_adam_trace_matches_jax(models):
    """Six Adam steps from the prior mean: the logpost trace at rtol 1e-4
    and the end point at atol 1e-5 (JAX runs them as one 6-step scan)."""
    jpost, tpost, _ = models
    jp, jtrace = jlap.map_estimate(jpost, n_steps=6, chunk=6)
    tp, ttrace = laplace.map_estimate(tpost, n_steps=6)
    np.testing.assert_allclose(ttrace, jtrace, rtol=1e-4)
    assert ttrace[-1] > ttrace[0]
    np.testing.assert_allclose(tp.u[0].numpy(), np.asarray(jp.u), atol=1e-5)


def test_batched_jacobian_equals_row_by_row(models):
    """All n_obs = 20 rows of J from one forward and one transport batch
    equal the rows pulled back one at a time through ``predict`` (one
    backward pass per one-hot observation), at rtol 1e-6 of the largest
    entry."""
    _, tpost, u = models
    params = Params(u=torch.from_numpy(u)[None])
    t_pred, J = tpost.jacobian(params)
    rows = []
    for k in range(t_pred.shape[0]):
        p = Params(u=params.u.clone().requires_grad_(True))
        (g,) = torch.autograd.grad(tpost.predict(p).reshape(-1)[k], p.u)
        rows.append(g.reshape(-1))
    J_rows = torch.stack(rows)
    np.testing.assert_allclose(t_pred.numpy(),
                               tpost.predict(params).reshape(-1).numpy(),
                               rtol=1e-6)
    scale = float(J_rows.abs().max())
    np.testing.assert_allclose(J.numpy(), J_rows.numpy(), rtol=0,
                               atol=1e-6 * scale)


def test_jacobian_and_covariance_match_jax(models):
    """J against JAX's rows (its vjp of ``predict`` with one-hot
    cotangents) at relative L2 1e-5, room for the FMA gap of the forward
    fields (ROADMAP Queue 3); the Gauss-Newton covariance at relative
    Frobenius 1e-4 (an fp32 inverse at condition ~900 amplifies J's gap;
    the port inverts through Cholesky, JAX by LU). Measured: 2.4e-7 and
    4.1e-6. The covariance is symmetric and positive definite."""
    jpost, tpost, u = models
    jparams = JParams(u=jnp.asarray(u))
    t_pred, pullback = jax.vjp(lambda x: jpost.predict(JParams(u=x)),
                               jnp.asarray(u))
    eye = np.eye(t_pred.size, dtype=np.float32)
    J_jax = np.stack([np.asarray(pullback(jnp.asarray(e.reshape(t_pred.shape)))[0]).ravel()
                      for e in eye])
    _, J = tpost.jacobian(Params(u=torch.from_numpy(u)[None]))
    rel_J = np.linalg.norm(J.numpy() - J_jax) / np.linalg.norm(J_jax)
    assert rel_J <= 1e-5, rel_J
    C_jax = np.asarray(jlap.gauss_newton_covariance(jpost, jparams))
    C = laplace.gauss_newton_covariance(tpost, Params(u=torch.from_numpy(u)[None]))
    rel_C = np.linalg.norm(C.numpy() - C_jax) / np.linalg.norm(C_jax)
    assert rel_C <= 1e-4, rel_C
    assert torch.equal(C, C.T)
    assert float(torch.linalg.eigvalsh(C.double()).min()) > 0
    torch.linalg.cholesky(C)


def test_gauss_newton_covariance_freezes_zero_scale_coords(models):
    """Coordinates of prior scale 0 get a unit diagonal and zero cross
    terms, as in JAX, and the active block matches JAX's at relative
    Frobenius 1e-4."""
    jpost, tpost, u = models
    scales = np.full(INV, 0.15, np.float32)
    scales[0, 0, :2] = 0.0
    scales[2, 1, 1] = 0.0
    jpost = dataclasses.replace(jpost, prior_scales=JParams(u=jnp.asarray(scales)))
    tpost = dataclasses.replace(tpost, prior_scales=Params(u=torch.from_numpy(scales)))
    C = laplace.gauss_newton_covariance(tpost, Params(u=torch.from_numpy(u)[None]))
    C = C.numpy()
    frozen = np.where(scales.ravel() == 0)[0]
    for i in frozen:
        assert C[i, i] == 1.0
        assert np.all(np.delete(C[i], i) == 0.0)
        assert np.all(np.delete(C[:, i], i) == 0.0)
    C_jax = np.asarray(jlap.gauss_newton_covariance(jpost, JParams(u=jnp.asarray(u))))
    active = np.where(scales.ravel() > 0)[0]
    a, b = C[np.ix_(active, active)], C_jax[np.ix_(active, active)]
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-4


def test_newton_refine_matches_jax(models):
    """Three damped Newton steps from the same point with the same
    covariance: the logpost trace at rtol 1e-4, rising."""
    jpost, tpost, u = models
    C = np.asarray(jlap.gauss_newton_covariance(jpost, JParams(u=jnp.asarray(u))))
    _, jtrace = jlap.newton_refine(jpost, JParams(u=jnp.asarray(u)),
                                   jnp.asarray(C), n_steps=3)
    _, ttrace = laplace.newton_refine(tpost, Params(u=torch.from_numpy(u)[None]),
                                      torch.from_numpy(C), n_steps=3)
    assert len(ttrace) == len(jtrace)
    np.testing.assert_allclose(ttrace, jtrace, rtol=1e-4)
    assert ttrace[-1] > ttrace[0]
