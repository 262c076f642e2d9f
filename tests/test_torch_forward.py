"""Parity of the PyTorch port's forward model with the JAX package on the
CPU: upsampling of the inversion field, receiver interpolation (points
outside the grid included), predicted traveltimes both ways round
(reciprocity), and the noise-free config-2 checkerboard data. Inputs come
from numpy seeds and go through both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mceik_tpu.config import DataCfg as JDataCfg
from mceik_tpu.config import ModelCfg as JModelCfg
from mceik_tpu.datasets.synthetic import checkerboard3d_dataset as j_dataset
from mceik_tpu.eikonal.solve import EikonalConfig as JEikonalConfig
from mceik_tpu.forward import predict as jpred
from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.model.params import slowness_from_u as j_slowness_from_u

from mceik_tpu_torch.config import DataCfg, ModelCfg
from mceik_tpu_torch.datasets.synthetic import checkerboard3d_dataset
from mceik_tpu_torch.eikonal.solve import EikonalConfig
from mceik_tpu_torch.forward import predict as tpred
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.params import slowness_from_u


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain CPU solves here are thousands of tiny ops on small grids:
    one intra-op thread runs them as fast, and keeps them from contending
    with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("inv_shape,shape", [((4, 4, 4), (16, 12, 16)),
                                             ((4, 5), (25, 17))])
def test_slowness_from_u_matches_jax(inv_shape, shape):
    """Trilinear / bilinear upsampling + exp, batched over chains, against
    jax.image.resize(linear) per chain: atol 1e-6 on slowness ~ 1."""
    u = np.random.default_rng(0).normal(0, 0.3, (3,) + inv_shape).astype(np.float32)
    jg, g = JGrid(shape, (1.0,) * len(shape)), Grid(shape, (1.0,) * len(shape))
    ref = np.stack([np.asarray(j_slowness_from_u(jnp.asarray(x), jg,
                                                 jnp.float32(1.3))) for x in u])
    out = slowness_from_u(torch.from_numpy(u), g, torch.tensor(1.3)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_allclose(
        slowness_from_u(torch.from_numpy(u[0]), g, torch.tensor(1.3)).numpy(),
        ref[0], atol=1e-6)


def test_interp_matches_jax_including_outside_points():
    """grid_sample(align_corners=True, border) against
    map_coordinates(order=1, mode="nearest"), on a field of magnitude ~20;
    atol 2e-5 covers grid_sample's fp32 coordinate normalisation."""
    rng = np.random.default_rng(1)
    shape, spacing, origin = (16, 12, 16), (1.0, 1.2, 0.9), (0.5, -1.0, 2.0)
    T = rng.uniform(0, 20, shape).astype(np.float32)
    jg, g = JGrid(shape, spacing, origin), Grid(shape, spacing, origin)
    lo, ext = np.asarray(origin), np.asarray(jg.extent)
    pts = (lo + ext * rng.uniform(-0.2, 1.2, (40, 3))).astype(np.float32)
    pts[:4] = lo + ext * np.array([[0, 0, 0], [1, 1, 1], [1, 0, 0.5],
                                   [-0.5, 2.0, 0.3]])
    ref = np.asarray(jpred.interp_at(jnp.asarray(T), jnp.asarray(pts), jg))
    out = tpred.interp_at(torch.from_numpy(T), torch.from_numpy(pts), g).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)
    tabs = np.stack([T, 2 * T])
    ref_t = np.asarray(jpred.interp_tables(jnp.asarray(tabs),
                                           jnp.asarray(pts[:5]), jg))
    out_t = tpred.interp_tables(torch.from_numpy(tabs),
                                torch.from_numpy(pts[:5]), g).numpy()
    np.testing.assert_allclose(out_t, ref_t, atol=4e-5)


@pytest.mark.parametrize("solve_from", ["src", "rec"])
def test_predict_tomo_matches_jax(solve_from):
    """Predicted arrivals at solver tol 1e-5, both sides of the reciprocity
    switch, for a chain batch of 2 slowness fields: atol 1e-4."""
    rng = np.random.default_rng(2)
    shape = (16, 12, 16)
    u = rng.normal(0, 0.2, (2, 4, 4, 4)).astype(np.float32)
    jg, g = JGrid(shape, (1.0,) * 3), Grid(shape, (1.0,) * 3)
    src = np.array([[1.0, 2.0, 3.0], [1.0, 9.0, 12.0], [0.5, 5.0, 8.0]],
                   np.float32)
    rec = np.array([[14.0, 2.0, 3.0], [14.5, 10.0, 13.0], [15.0, 6.0, 1.0],
                    [13.0, 1.0, 15.0]], np.float32)
    jcfg = JEikonalConfig(tol=1e-5, max_iters=60)
    ref = np.stack([np.asarray(jpred.predict_tomo(
        j_slowness_from_u(jnp.asarray(x), jg, jnp.float32(1.0)),
        jnp.asarray(src), jnp.asarray(rec), jg, jcfg, solve_from=solve_from))
        for x in u])
    s = slowness_from_u(torch.from_numpy(u), g, torch.tensor(1.0))
    out = tpred.predict_tomo(s, torch.from_numpy(src), torch.from_numpy(rec),
                             g, EikonalConfig(tol=1e-5, max_iters=60),
                             solve_from=solve_from).numpy()
    assert out.shape == (2, 3, 4)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_checkerboard3d_clean_data_matches_jax():
    """Noise-free config-2 data on a 16^3 grid: the same truth slowness
    (rtol 1e-6), geometry (exact) and clean arrivals (atol 1e-4 at the
    dataset's solver tol 1e-4)."""
    shape = (16, 16, 16)
    kw = dict(dataset="checkerboard3d", n_src=4, n_rec=6, noise=0.0,
              checker_cells=(3, 3, 3), checker_amplitude=0.1)
    jd, js = j_dataset(JGrid(shape, (1.0,) * 3), JDataCfg(**kw), JModelCfg())
    td, ts = checkerboard3d_dataset(Grid(shape, (1.0,) * 3), DataCfg(**kw),
                                    ModelCfg())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(td.src_xyz.numpy(), np.asarray(jd.src_xyz))
    np.testing.assert_array_equal(td.rec_xyz.numpy(), np.asarray(jd.rec_xyz))
    np.testing.assert_allclose(td.t_obs.numpy(), np.asarray(jd.t_obs),
                               atol=1e-4)
    assert jax.default_backend() == "cpu"
