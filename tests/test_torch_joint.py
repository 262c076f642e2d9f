"""Parity of the PyTorch port's joint slowness + hypocentre posterior
(config 3) with the JAX package on the CPU: the hypocentre box transforms,
the station and event geometries and datasets, the joint logpost per chain
(sampled t0 and marginalized t0) and its gradient against ``jax.grad``,
the plain solve on config 3's non-cube route against the Pallas kernels it
takes there (``sweep_axes01_fused`` + ``sweep_axis0``, interpret mode),
the joint Gauss-Newton Jacobian and covariance (per-event demeaning), the
whitened view, and config 3 through the CLI at a tiny grid. Inputs are made
with numpy from seeds; data cross over with ``convert``."""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mceik_tpu.config import DataCfg as JDataCfg
from mceik_tpu.config import EikonalCfg as JEikonalCfg
from mceik_tpu.config import ModelCfg as JModelCfg
from mceik_tpu.datasets import make_dataset as j_make_dataset
from mceik_tpu.datasets import synthetic as jsyn
from mceik_tpu.eikonal.pallas_sweep import (lane_pack_factor,
                                            sweep_solve_pallas_packed)
from mceik_tpu.eikonal.solve import seed_source as j_seed_source
from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.model import laplace as jlap
from mceik_tpu.model import params as jparams_mod
from mceik_tpu.model.params import Params as JParams
from mceik_tpu.model.posterior import build_posterior as j_build_posterior
from mceik_tpu.model.whitened import whitened_view as j_whitened_view

from mceik_tpu_torch import cli
from mceik_tpu_torch.config import DataCfg, EikonalCfg, ModelCfg
from mceik_tpu_torch.convert import event_data_from_jax, params_from_jax
from mceik_tpu_torch.datasets import make_dataset
from mceik_tpu_torch.datasets import synthetic as tsyn
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.solve import EikonalConfig
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model import laplace
from mceik_tpu_torch.model import params as tparams_mod
from mceik_tpu_torch.model.posterior import build_posterior, value_and_grad
from mceik_tpu_torch.model.whitened import whitened_view
from mceik_tpu_torch.samplers.am_full import _ravel


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain CPU solves here are thousands of tiny ops on small grids:
    one intra-op thread runs them as fast, and keeps them from contending
    with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C3 = os.path.join(REPO, "configs", "c3_joint_events.json")
# test_nuts_joint.py's problem: 13x13x9 grid, 3x3x2 basis, 2 events, 5
# surface stations.
SHAPE = (13, 13, 9)
INV = (3, 3, 2)
N_CHAINS = 3
EKW = dict(tol=1e-5, max_iters=60, use_pallas="off")
DKW = dict(dataset="events3d", n_events=2, n_stations=5, noise=0.02, seed=21,
           checker_cells=(2, 2, 2), checker_amplitude=0.05)


def _mkw(marginalize):
    return dict(mode="joint", inv_shape=INV, prior_sigma_u=0.1, sigma=0.02,
                marginalize_t0=marginalize)


@functools.lru_cache(maxsize=None)
def _jax_data(shape, dkw):
    """JAX's dataset on a unit-spaced grid (it reads nothing of the model
    config but the background slowness), built once per module."""
    return j_make_dataset(JGrid(shape, (1.0,) * 3), JDataCfg(**dict(dkw)),
                          JModelCfg())[0]


def test_box_transforms_match_jax():
    """box_from_raw, box_logjac (per chain) and raw_from_box at rtol 1e-6,
    on an off-origin anisotropic grid with raw values out to +-8."""
    rng = np.random.default_rng(0)
    kw = dict(shape=(13, 9, 7), spacing=(1.0, 1.5, 0.8), origin=(2.0, -1.0, 0.5))
    jg, g = JGrid(**kw), Grid(**kw)
    raw = rng.uniform(-8, 8, (N_CHAINS, 4, 3)).astype(np.float32)
    box = tparams_mod.box_from_raw(torch.from_numpy(raw), g)
    np.testing.assert_allclose(
        box.numpy(), np.asarray(jparams_mod.box_from_raw(jnp.asarray(raw), jg)),
        rtol=1e-6)
    np.testing.assert_allclose(
        tparams_mod.box_logjac(torch.from_numpy(raw)).numpy(),
        [float(jparams_mod.box_logjac(jnp.asarray(r))) for r in raw], rtol=1e-6)
    xyz = box.numpy()[:, :2]
    np.testing.assert_allclose(
        tparams_mod.raw_from_box(torch.from_numpy(xyz), g).numpy(),
        np.asarray(jparams_mod.raw_from_box(jnp.asarray(xyz), jg)), rtol=1e-6,
        atol=1e-6)


def test_station_geometries_equal_jax():
    """Surface and volume acquisition draw from numpy's default_rng with
    the reference's seeds: bit-equal stations and sources."""
    jg, g = JGrid((20, 16, 12), (1.0, 1.2, 0.9)), Grid((20, 16, 12), (1.0, 1.2, 0.9))
    np.testing.assert_array_equal(
        tsyn.surface_array_geometry(g, 16, seed=7).numpy(),
        np.asarray(jsyn.surface_array_geometry(jg, 16, seed=7)))
    for a, b in zip(tsyn.volume3d_geometry(g, 5, 9, seed=3),
                    jsyn.volume3d_geometry(jg, 5, 9, seed=3)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dataset", ["events3d", "events3d_volume",
                                     "checkerboard3d_volume"])
def test_datasets_match_jax(dataset):
    """Noise-free data on a 12x12x8 grid: the same geometry and truth
    (exact), truth slowness at rtol 1e-6, clean arrivals at atol 1e-4 (the
    datasets' solver tol 1e-4)."""
    shape = (12, 12, 8)
    kw = dict(dataset=dataset, n_events=3, n_stations=4, n_src=3, n_rec=4,
              noise=0.0, seed=11, checker_cells=(2, 2, 2),
              checker_amplitude=0.08)
    jd, jt = j_make_dataset(JGrid(shape, (1.0,) * 3), JDataCfg(**kw), JModelCfg())
    td, tt = make_dataset(Grid(shape, (1.0,) * 3), DataCfg(**kw), ModelCfg())
    assert sorted(tt) == sorted(jt)
    np.testing.assert_allclose(tt["slowness"].numpy(),
                               np.asarray(jt["slowness"]), rtol=1e-6)
    for k in ("hypo", "t0"):
        if k in jt:
            np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))
    for f in ("sta_xyz", "src_xyz", "rec_xyz"):
        if hasattr(jd, f):
            np.testing.assert_array_equal(getattr(td, f).numpy(),
                                          np.asarray(getattr(jd, f)))
    np.testing.assert_allclose(td.t_obs.numpy(), np.asarray(jd.t_obs),
                               atol=1e-4)


@pytest.fixture(scope="module", params=[False, True],
                ids=["sampled_t0", "marginalized_t0"])
def joint_case(request):
    """Both packages' differentiable joint posteriors on JAX's data, three
    chains' params, and JAX's per-chain logpost and gradient there."""
    marg = request.param
    jgrid = JGrid(SHAPE, (1.0,) * 3)
    jdata = _jax_data(SHAPE, tuple(DKW.items()))
    jpost = j_build_posterior(JModelCfg(**_mkw(marg)), jdata, jgrid,
                              JEikonalCfg(**EKW), differentiable=True)
    tpost = build_posterior(ModelCfg(**_mkw(marg)), event_data_from_jax(jdata),
                            Grid(SHAPE, (1.0,) * 3), EikonalCfg(**EKW),
                            differentiable=True)
    rng = np.random.default_rng(1)
    jp = JParams(
        u=jnp.asarray(rng.normal(0, 0.05, (N_CHAINS,) + INV).astype(np.float32)),
        hypo_raw=jnp.asarray(rng.normal(0, 0.5, (N_CHAINS, 2, 3)).astype(np.float32)),
        t0=None if marg else jnp.asarray(
            rng.normal(0, 0.1, (N_CHAINS, 2)).astype(np.float32)))
    jlp, jgrad = jax.jit(jax.vmap(jax.value_and_grad(jpost.logpost)))(jp)
    return dict(jpost=jpost, tpost=tpost, jp=jp, jlp=np.asarray(jlp),
                jgrad=jgrad, marg=marg)


def test_joint_logpost_matches_jax(joint_case):
    """Per-chain joint logpost at rtol 2e-5 (the tomo bar; ROADMAP Queue
    3), the prior alone at rtol 1e-6, predicted arrivals ``(C, n_ev,
    n_sta)``; the prior scales, their shapes and n_dim as JAX's."""
    jpost, tpost, jp = joint_case["jpost"], joint_case["tpost"], joint_case["jp"]
    tp = params_from_jax(jp)
    lp = tpost.logpost(tp).numpy()
    np.testing.assert_allclose(lp, joint_case["jlp"], rtol=2e-5)
    np.testing.assert_allclose(tpost.log_prior(tp).numpy(),
                               np.asarray(jax.vmap(jpost.log_prior)(jp)),
                               rtol=1e-6)
    assert tuple(tpost.predict(tp).shape) == (N_CHAINS, 2, 5)
    assert tpost.n_dim == jpost.n_dim
    for f in ("u", "hypo_raw", "t0"):
        a, b = getattr(tpost.prior_scales, f), getattr(jpost.prior_scales, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    gen = torch.Generator().manual_seed(0)
    init = tpost.init_params(gen, 2)
    prior = tpost.sample_prior(gen, 2)
    for p in (init, prior):
        assert tuple(p.hypo_raw.shape) == (2, 2, 3)
        assert (p.t0 is None) == joint_case["marg"]
        assert torch.isfinite(tpost.logpost(p)).all()


def test_joint_gradient_matches_jax(joint_case):
    """The gradient of every chain's logpost (one backward pass through the
    implicit adjoint and the table interpolation) against ``jax.grad``:
    relative L2 <= 1e-4 for each of u, hypo_raw and t0."""
    tp = params_from_jax(joint_case["jp"])
    _, g = value_and_grad(joint_case["tpost"].logpost)(tp)
    for f in ("u", "hypo_raw", "t0"):
        a, b = getattr(g, f), getattr(joint_case["jgrad"], f)
        assert (a is None) == (b is None)
        if a is None:
            continue
        b = np.asarray(b)
        rel = np.linalg.norm(a.numpy() - b) / np.linalg.norm(b)
        assert rel <= 1e-4, (f, rel)


def test_noncube_plain_solve_matches_pallas_fused01_axis0():
    """Config 3's route on the TPU: a non-cube grid with n_x == n_y packs
    P = 4 fields and sweeps each cycle with ``sweep_axes01_fused`` then
    ``sweep_axis0`` on axis 2. The port's plain solve (K1's oracle) on
    (16, 16, 32) with spacing (1.0, 1.1, 0.9) against that route in
    interpret mode, at tol 1e-5: atol 1e-4 (test_pallas_sweep.py:269's
    bar). The Pallas solve converges jointly per pack, the port per field."""
    shape, spacing = (16, 16, 32), (1.0, 1.1, 0.9)
    jg = JGrid(shape, spacing)
    assert lane_pack_factor(shape) == 4
    rng = np.random.default_rng(23)
    u = rng.normal(0, 0.3, (4, 4, 4, 6)).astype(np.float32)
    s = tparams_mod.slowness_from_u(torch.from_numpy(u), Grid(shape, spacing),
                                    torch.tensor(1.0)).numpy()
    srcs = np.array([[2.0 + i, 7.0, 21.0 - i] for i in range(4)], np.float32)
    T0s, frs = zip(*[j_seed_source(jnp.asarray(s[i]), jnp.asarray(srcs[i]),
                                   jg, 3.0) for i in range(4)])
    ref = np.asarray(sweep_solve_pallas_packed(
        jnp.stack(T0s), jnp.stack(frs), jnp.asarray(s), spacing, tol=1e-5,
        max_cycles=80, interpret=True))
    out = solve_eikonal_batched(torch.from_numpy(s), torch.from_numpy(srcs),
                                Grid(shape, spacing),
                                EikonalConfig(tol=1e-5, max_iters=80,
                                              use_pallas="off"))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


# The small joint problem of the Laplace and whitened tests: 10x10x8 grid,
# 2^3 basis, 2 events, 4 stations on three faces, one chain.
LSHAPE = (10, 10, 8)
LINV = (2, 2, 2)


def _laplace_models(marg):
    mkw = dict(mode="joint", inv_shape=LINV, prior_sigma_u=0.15, sigma=0.04,
               marginalize_t0=marg)
    ekw = dict(tol=1e-5, max_iters=40, use_pallas="off")
    jgrid = JGrid(LSHAPE, (1.0,) * 3)
    jdata = _jax_data(LSHAPE, (
        ("dataset", "events3d_volume"), ("n_events", 2), ("n_stations", 4),
        ("noise", 0.04), ("seed", 79), ("checker_cells", (2, 2, 2)),
        ("checker_amplitude", 0.08)))
    jpost = j_build_posterior(JModelCfg(**mkw), jdata, jgrid,
                              JEikonalCfg(**ekw), differentiable=True)
    tpost = build_posterior(ModelCfg(**mkw), event_data_from_jax(jdata),
                            Grid(LSHAPE, (1.0,) * 3), EikonalCfg(**ekw),
                            differentiable=True)
    rng = np.random.default_rng(2)
    jp = JParams(u=jnp.asarray(rng.normal(0, 0.05, LINV).astype(np.float32)),
                 hypo_raw=jnp.asarray(rng.normal(0, 0.4, (2, 3)).astype(np.float32)),
                 t0=None if marg else jnp.asarray(
                     rng.normal(0, 0.05, (2,)).astype(np.float32)))
    tp = params_from_jax(jax.tree.map(lambda x: x[None], jp))
    return jpost, tpost, jp, tp


@pytest.mark.parametrize("marg", [False, True],
                         ids=["sampled_t0", "marginalized_t0"])
def test_joint_jacobian_and_covariance_match_jax(marg):
    """The joint Gauss-Newton Jacobian (u columns through the batched
    transport, hypocentre columns from the table slopes, t0 columns 1)
    against JAX's rows at relative L2 1e-5. The covariance (with the
    per-event demeaning of a marginalized t0) against the float64 inverse
    of H built from JAX's rows: H's condition is ~4e4 here, so an fp32
    inverse is good to ~cond x 2^-23 = 3e-3 at worst; bar 1e-3 relative
    Frobenius, which JAX's own LU inverse meets too (measured: port 2.2e-4
    and 5.9e-5, JAX 1.5e-4 and 6.0e-5). Symmetric and positive definite."""
    jpost, tpost, jp, tp = _laplace_models(marg)
    unravel = jlap._unravel_fn(jp)
    t_pred, pullback = jax.vjp(lambda x: jpost.predict(unravel(x)),
                               jlap._ravel(jp))
    eye = jnp.eye(t_pred.size, dtype=jnp.float32)
    J_jax = np.asarray(jax.jit(jax.vmap(
        lambda e: pullback(e.reshape(t_pred.shape))[0]))(eye))
    t_rows, J = tpost.jacobian(tp)
    np.testing.assert_allclose(t_rows.numpy(), np.asarray(t_pred).ravel(),
                               atol=1e-5)
    rel_J = np.linalg.norm(J.numpy() - J_jax) / np.linalg.norm(J_jax)
    assert rel_J <= 1e-5, rel_J

    J64 = J_jax.astype(np.float64)
    n_obs, d = J64.shape
    w = np.full(n_obs, 1.0 / 0.04 ** 2)
    if marg:
        Je, we = J64.reshape(2, -1, d), w.reshape(2, -1)
        wJ = np.einsum("es,esd->ed", we, Je) / we.sum(1)[:, None]
        J64 = (Je - wJ[:, None]).reshape(n_obs, d)
    scales = np.asarray(jlap._ravel(jpost.prior_scales), np.float64)
    C64 = np.linalg.inv(np.diag(scales ** -2) + (J64.T * w) @ J64)
    C = laplace.gauss_newton_covariance(tpost, tp)
    C_jax = np.asarray(jlap.gauss_newton_covariance(jpost, jp))
    rel = lambda a: np.linalg.norm(a - C64) / np.linalg.norm(C64)
    assert rel(C_jax) <= 1e-3
    assert rel(C.numpy()) <= 1e-3, rel(C.numpy())
    assert torch.equal(C, C.T)
    torch.linalg.cholesky(C)


def test_whitened_view_matches_jax():
    """The whitened view of a joint posterior from one MAP and covariance:
    ``params_of`` (x = x_map + L u, per chain) at atol 1e-6, logpost_u at
    rtol 2e-5 and so the gpCN residual; ``params_of(0)`` is the
    MAP; starts are 0.3x unit normals."""
    jpost, tpost, jp, tp = _laplace_models(True)
    rng = np.random.default_rng(3)
    d = int(_ravel(tp, batch_dims=1).shape[1])
    a = rng.normal(0, 1, (d, d))
    cov = (0.01 * (a @ a.T / d + 0.5 * np.eye(d))).astype(np.float32)
    jwv = j_whitened_view(jpost, jp, jnp.asarray(cov))
    twv = whitened_view(tpost, tp, torch.from_numpy(cov))
    assert twv.d == jwv.d
    np.testing.assert_array_equal(twv.scales_u.numpy(), np.asarray(jwv.scales_u))
    u = rng.normal(0, 1, (N_CHAINS, d)).astype(np.float32)
    jpar = jax.vmap(jwv.params_of)(jnp.asarray(u))
    tpar = twv.params_of(torch.from_numpy(u))
    for f in ("u", "hypo_raw"):
        np.testing.assert_allclose(getattr(tpar, f).numpy(),
                                   np.asarray(getattr(jpar, f)), atol=1e-6)
    jl = np.asarray(jax.jit(jax.vmap(jwv.logpost_u))(jnp.asarray(u)))
    np.testing.assert_allclose(twv.logpost_u(torch.from_numpy(u)).numpy(), jl,
                               rtol=2e-5)
    np.testing.assert_allclose(
        twv.resid_u(torch.from_numpy(u)).numpy(),
        np.asarray(jax.jit(jax.vmap(jwv.resid_u))(jnp.asarray(u))), rtol=2e-5)
    zero = twv.params_of(torch.zeros((1, d)))
    np.testing.assert_array_equal(zero.u.numpy(), tp.u.numpy())
    init = twv.init_u(torch.Generator().manual_seed(0), 2000)
    assert abs(float(init.std()) - 0.3) < 0.01


def _records(lines):
    return [json.loads(x.split("] ", 1)[1]) for x in lines
            if x.startswith("[mceik] ")]


TINY_C3 = ["grid.shape=[8,8,6]", "model.inv_shape=[2,2,2]",
           "data.n_events=2", "data.n_stations=3", "sampler.n_chains=2",
           "sampler.n_warmup=2", "sampler.n_samples=4", "io.log_every=4",
           "sampler.max_tree_depth=2", "sampler.n_leapfrog=2",
           "sampler.n_map_steps=3", "eikonal.max_iters=30"]


@pytest.mark.parametrize("algo", ["nuts", "hmc", "pcn", "mala",
                                  "nuts_whitened"])
def test_cli_runs_tiny_c3_on_cpu(capsys, algo):
    """configs/c3_joint_events.json cut to an 8x8x6 grid, 2 events, 3
    stations and 2 chains through the CLI: NUTS (the config's sampler),
    HMC, pCN, Laplace-preconditioned MALA and whitened NUTS. Init and
    sample records with finite logposts; NUTS logs its tree depth and
    divergences; the summary line names the sampler and the recovery
    correlation of the tracked slowness."""
    name, _, pre = algo.partition("_")
    argv = ["run", C3, *TINY_C3, f"sampler.algorithm={name}"]
    if pre:
        argv.append(f"sampler.precondition={pre}")
    assert cli.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    recs = _records(lines)
    phases = [r["phase"] for r in recs]
    assert phases[-2:] == ["init", "sample"], phases
    assert ("laplace" in phases) == (name == "mala" or pre == "whitened")
    assert all(np.isfinite(r[k]) for r in recs if r["phase"] != "laplace"
               for k in ("logpost_mean", "logpost_min", "logpost_max"))
    samp = recs[-1]
    assert 0.0 <= samp["accept"] <= 1.0
    if name == "nuts":
        assert 1.0 <= samp["tree_depth"] <= 2.0
        assert 0.0 <= samp["divergent"] <= 1.0
    summary = [x for x in lines if x.startswith(f"[mceik-tpu-torch] {name} ")]
    assert len(summary) == 1 and "recovery_corr=" in summary[0]
