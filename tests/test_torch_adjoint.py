"""Parity of the PyTorch port's implicit adjoint with the JAX package, on the
CPU: the signed transport weights, the swept transport solve (against JAX's
plain solve and the Pallas transport kernel in interpret mode), divergence
poisoning per field, the K4 wrapper's CPU dispatch, and the gradient of the
config-2 logpost (backward alone on JAX's converged traveltimes, end to
end, and against finite differences). Inputs are made with numpy from a
seed; tolerances are stated per test. K4 itself is tested on the card in
test_torch_cuda.py."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mceik_tpu.config import DataCfg as JDataCfg
from mceik_tpu.config import EikonalCfg as JEikonalCfg
from mceik_tpu.config import ModelCfg as JModelCfg
from mceik_tpu.datasets.synthetic import checkerboard3d_dataset as j_dataset
from mceik_tpu.eikonal import adjoint_sweep as jas
from mceik_tpu.eikonal.adjoint import _fixed_point_map as j_fixed_point_map
from mceik_tpu.eikonal.batched import solve_eikonal_batched as j_solve_batched
from mceik_tpu.eikonal.pallas_transport import transport_solve_pallas_packed
from mceik_tpu.eikonal.solve import EikonalConfig as JEikonalConfig
from mceik_tpu.eikonal.solve import seed_source as j_seed_source
from mceik_tpu.eikonal.solve import solve_eikonal as j_solve
from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.model.params import Params as JParams
from mceik_tpu.model.params import slowness_from_u as j_slowness_from_u
from mceik_tpu.model.posterior import build_posterior as j_build_posterior

from mceik_tpu_torch.config import EikonalCfg, ModelCfg
from mceik_tpu_torch.convert import tomo_data_from_jax
from mceik_tpu_torch.eikonal import adjoint_sweep as tas
from mceik_tpu_torch.eikonal import cuda_transport
from mceik_tpu_torch.eikonal.adjoint import (_fixed_point_map,
                                             solve_eikonal_diff_batched)
from mceik_tpu_torch.eikonal.solve import EikonalConfig, seed_source
from mceik_tpu_torch.forward.predict import interp_tables
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.params import Params, slowness_from_u
from mceik_tpu_torch.model.posterior import (_gaussian_loglik, build_posterior,
                                             value_and_grad)


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


def _jax_problem(shape, spacing, s, src, tol=1e-6):
    """JAX's converged field, frozen mask and signed weights for one
    source."""
    jg = JGrid(shape, spacing)
    T = j_solve(jnp.asarray(s), jnp.asarray(src), jg,
                JEikonalConfig(method="sweep", tol=tol, max_iters=100))
    _, frozen = j_seed_source(jnp.asarray(s), jnp.asarray(src), jg, 3.0)
    ws = jas.transport_weights(T, jnp.asarray(s), frozen, spacing)
    return T, frozen, ws


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("case", ["anisotropic", "isotropic_ties"])
def test_transport_weights_match_jax(case):
    """One forward-mode JVP per axis of the port's local solve gives JAX's
    signed weights at atol 1e-6: at (14, 12, 10) with spacing
    (1.0, 1.2, 0.9) on a random field, and on a homogeneous isotropic field
    whose neighbour minima tie on the diagonals (min/max split the tangent
    0.5/0.5 at a tie in both packages)."""
    rng = np.random.default_rng(0)
    shape = (14, 12, 10)
    if case == "anisotropic":
        spacing = (1.0, 1.2, 0.9)
        s = (1.0 + 0.3 * rng.uniform(size=shape)).astype(np.float32)
    else:
        spacing = (1.0, 1.0, 1.0)
        s = np.ones(shape, np.float32)
    src = np.array([7.0, 6.0, 5.0], np.float32)
    T, frozen, ws = _jax_problem(shape, spacing, s, src)
    _, frozen_t = seed_source(_t(s)[None], _t(src)[None], Grid(shape, spacing),
                              3.0)
    np.testing.assert_array_equal(frozen_t[0].numpy(), np.asarray(frozen))
    wt = tas.transport_weights(_t(T)[None], _t(s)[None], frozen_t, spacing)
    for d in range(3):
        np.testing.assert_allclose(wt[d][0].numpy(), np.asarray(ws[d]),
                                   atol=1e-6)
    if case == "isotropic_ties":
        # The field really has nodes whose neighbour minima tie across axes.
        a = [np.minimum(np.roll(np.asarray(T), 1, d), np.roll(np.asarray(T), -1, d))
             for d in range(3)]
        ties = (a[0] == a[1]) | (a[0] == a[2]) | (a[1] == a[2])
        assert int((ties & ~np.asarray(frozen)).sum()) > 100


@pytest.fixture(scope="module")
def transport_problem():
    """The JAX transport fixture of test_adjoint_sweep.py: weights and a
    cotangent g on (14, 12, 10), spacing (1.0, 1.2, 0.9)."""
    rng = np.random.default_rng(1)
    shape, spacing = (14, 12, 10), (1.0, 1.2, 0.9)
    s = (1.0 + 0.3 * rng.uniform(size=shape)).astype(np.float32)
    T, _, ws = _jax_problem(shape, spacing, s, np.array([3.0, 6.0, 5.0],
                                                        np.float32))
    g = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return ws, g


def test_transport_solve_matches_jax_plain(transport_problem):
    """JAX's weights and g through the port's plain solve: atol 1e-5
    against JAX's ``transport_solve(use_pallas="off")`` (the bar of
    test_adjoint_sweep.py), and a fixed-point residual under the port's
    ``apply_WT`` below 1e-5."""
    ws, g = transport_problem
    ref = np.asarray(jas.transport_solve(jnp.asarray(g), ws, tol=1e-7,
                                         max_cycles=100, use_pallas="off"))
    wt = tuple(_t(w)[None] for w in ws)
    lam = tas.transport_solve(_t(g)[None], wt, 1e-7, 100)
    np.testing.assert_allclose(lam[0].numpy(), ref, atol=1e-5)
    resid = lam - (tas.apply_WT(lam, wt) + _t(g)[None])
    assert float(resid.abs().max()) < 1e-5
    np.testing.assert_allclose(tas.apply_WT(lam, wt)[0].numpy(),
                               np.asarray(jas.apply_WT(jnp.asarray(lam[0].numpy()),
                                                       ws)), atol=1e-6)


def test_transport_solve_matches_pallas_packed_interpret():
    """Against the TPU kernel K4 replaces (``transport_axis0`` through
    ``transport_solve_pallas_packed``, interpret mode, P = 2 on 12x12x16):
    atol 1e-5. The Pallas solve converges jointly per pack, the port per
    field."""
    rng = np.random.default_rng(2)
    shape, spacing = (12, 12, 16), (1.0, 1.0, 1.0)
    s = (1.0 + 0.3 * rng.uniform(size=shape)).astype(np.float32)
    gs, wss = [], []
    for i in range(2):
        _, _, ws = _jax_problem(shape, spacing, s,
                                np.array([2.0 + 5 * i, 6.0, 8.0], np.float32))
        wss.append(ws)
        gs.append((0.1 * rng.standard_normal(shape)).astype(np.float32))
    ws_st = tuple(jnp.stack([wss[i][d] for i in range(2)]) for d in range(3))
    ref = np.asarray(transport_solve_pallas_packed(
        jnp.asarray(np.stack(gs)), ws_st, tol=1e-7, max_cycles=100,
        interpret=True))
    lam = tas.transport_solve(_t(np.stack(gs)),
                              tuple(_t(w) for w in ws_st), 1e-7, 100)
    np.testing.assert_allclose(lam.numpy(), ref, atol=1e-5)


def _divergent_weights(shape):
    """The 2-D divergent system of test_adjoint_sweep.py lifted to 3-D:
    node pairs (2k, 2k+1) feed each other with weight 1.3 along every axis,
    dependency cycles of gain > 1, so no sweep order converges."""
    out = []
    for d, n in enumerate(shape):
        idx = np.arange(n).reshape([-1 if e == d else 1 for e in range(3)])
        out.append(np.broadcast_to(np.where(idx % 2 == 0, -1.3, 1.3),
                                   shape).astype(np.float32))
    return out


def test_divergent_field_is_nan_only_in_its_own_field(transport_problem):
    """A batch of a contractive field, a zero-g field and a divergent one:
    the divergent field alone comes back all NaN, the zero field is 0 after
    one cycle, and the contractive field equals its solve on its own."""
    ws, g = transport_problem
    shape = g.shape
    div = _divergent_weights(shape)
    wt = tuple(torch.stack([_t(ws[d]), _t(ws[d]), _t(div[d])])
               for d in range(3))
    gb = torch.stack([_t(g), torch.zeros(shape), torch.ones(shape)])
    cycles = []

    def counting(lam, g_, w_, n_inner, done):
        cycles.append((~done).clone())
        return tas.transport_cycle_plain(lam, g_, w_, n_inner, done)

    lam = tas.transport_solve(gb, wt, 1e-6, 30, cycle=counting)
    assert torch.isnan(lam[2]).all()
    assert torch.isfinite(lam[:2]).all()
    assert torch.equal(lam[1], torch.zeros(shape))
    per_field = torch.stack(cycles).sum(0).tolist()
    assert per_field[1] == 1 and per_field[0] > 1 and per_field[2] > 1
    alone = tas.transport_solve(_t(g)[None], tuple(_t(w)[None] for w in ws),
                                1e-6, 30)
    assert torch.equal(lam[0], alone[0])


def test_cuda_transport_cpu_dispatch(transport_problem):
    """The K4 module imports without nvcc or a card; a CPU tensor goes to
    the plain cycle and leaves the launch count alone; the kernel itself
    refuses CPU tensors; without nvcc the build raises."""
    ws, g = transport_problem
    wt = tuple(_t(w)[None].repeat(2, 1, 1, 1) for w in ws)
    gb = _t(g)[None].repeat(2, 1, 1, 1)
    done = torch.tensor([False, True])
    launches = cuda_transport.TRANSPORT3D.launches
    out = cuda_transport.transport_cycle(gb, gb, wt, 2, done)
    assert cuda_transport.TRANSPORT3D.launches == launches
    assert torch.equal(out, tas.transport_cycle_plain(gb, gb, wt, 2, done))
    assert torch.equal(out[1], gb[1])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_transport.TRANSPORT3D(gb, gb, wt, 2, done)
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_transport.Transport3dKernel().build()


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
    data = tomo_data_from_jax(jdata)
    tpost = build_posterior(ModelCfg(**mkw), data, Grid(SHAPE, (1.0,) * 3),
                            EikonalCfg(**ekw), differentiable=True)
    u = np.random.default_rng(0).normal(0, 0.05, (N_CHAINS,) + INV)
    u = u.astype(np.float32)
    jvg = jax.jit(jax.vmap(jax.value_and_grad(jpost.logpost)))
    jlp, jg = jvg(JParams(u=jnp.asarray(u)))
    return dict(jgrid=jgrid, jdata=jdata, data=data, tpost=tpost, u=u,
                jlp=np.asarray(jlp), jgrad=np.asarray(jg.u),
                ecfg=EikonalConfig(tol=1e-5, max_iters=60))


def _rel_l2(a, b):
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def test_fixed_point_map_matches_jax(models):
    """The pure local map (no monotone min) on JAX's converged fields
    equals JAX's map at rtol 1e-6 and returns the fixed point itself."""
    m = models
    s = j_slowness_from_u(jnp.asarray(m["u"][0]), m["jgrid"], 1.0)
    src = m["jdata"].src_xyz
    T = np.asarray(j_solve_batched(s, src, m["jgrid"],
                                   JEikonalConfig(tol=1e-5, max_iters=60),
                                   impl="xla"))
    ref = np.stack([np.asarray(j_fixed_point_map(
        jnp.asarray(T[i]), s, src[i], m["jgrid"],
        JEikonalConfig(tol=1e-5, max_iters=60))) for i in range(len(src))])
    s_t = _t(s)[None].expand(len(src), *SHAPE)
    out = _fixed_point_map(_t(T), s_t, m["data"].src_xyz, Grid(SHAPE, (1.0,) * 3),
                           m["ecfg"])
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), T, atol=1e-4)


def _port_logpost_on_T(m, u, T_given):
    """The port's config-2 logpost of a chain batch with the traveltimes
    fed in (the backward of the implicit adjoint still runs in full)."""
    grid = Grid(SHAPE, (1.0,) * 3)
    data = m["data"]
    C, n_src = u.shape[0], data.src_xyz.shape[0]
    s = slowness_from_u(u, grid, torch.tensor(1.0))
    s_b = s.unsqueeze(1).expand((C, n_src) + SHAPE).reshape((-1,) + SHAPE)
    srcs = data.src_xyz.repeat(C, 1)
    T = solve_eikonal_diff_batched(s_b, srcs, grid, m["ecfg"], T=T_given)
    r = data.t_obs - interp_tables(T.reshape((C, n_src) + SHAPE),
                                   data.rec_xyz, grid)
    return (-0.5 * ((u / 0.2) ** 2).flatten(1).sum(1)
            + _gaussian_loglik(r, torch.full_like(r, 0.01), None))


def test_backward_on_jax_traveltimes_matches_jax_grad(models):
    """(i) The port's backward (weights, transport solve, VJP of the pure
    local map, grid_sample and upsampling backward) fed with JAX's own
    converged traveltimes, against ``jax.grad`` of JAX's logpost per chain:
    relative L2 <= 1e-5 on the gradient."""
    m = models
    Ts = []
    for c in range(N_CHAINS):
        s = j_slowness_from_u(jnp.asarray(m["u"][c]), m["jgrid"], 1.0)
        Ts.append(np.asarray(j_solve_batched(
            s, m["jdata"].src_xyz, m["jgrid"],
            JEikonalConfig(tol=1e-5, max_iters=60), impl="xla")))
    T_jax = _t(np.concatenate(Ts))
    u = _t(m["u"]).requires_grad_(True)
    lp = _port_logpost_on_T(m, u, T_jax)
    (grad,) = torch.autograd.grad(lp.sum(), u)
    np.testing.assert_allclose(lp.detach().numpy(), m["jlp"], rtol=2e-5)
    for c in range(N_CHAINS):
        assert _rel_l2(grad[c].numpy(), m["jgrad"][c]) <= 1e-5


def test_grad_end_to_end_matches_jax_grad(models):
    """(ii) ``value_and_grad`` of the port's differentiable logpost (its own
    solve, then its backward) against ``jax.grad`` per chain. The forward
    fixed points differ from JAX's at the ulp level because XLA contracts
    FMAs (ROADMAP Queue 3), which the gradient could amplify; bar: relative
    L2 <= 1e-4. Measured: 2.1e-6 to 3.7e-6 over these three chains (and
    0.8e-6 to 3.1e-6 with JAX's traveltimes fed in, test (i))."""
    m = models
    lp, g = value_and_grad(m["tpost"].logpost)(Params(u=_t(m["u"])))
    np.testing.assert_allclose(lp.numpy(), m["jlp"], rtol=2e-5)
    for c in range(N_CHAINS):
        assert _rel_l2(g.u[c].numpy(), m["jgrad"][c]) <= 1e-4


def test_grad_matches_central_finite_difference(models):
    """(iii) The port's gradient against a central finite difference of its
    own logpost along a random direction, per chain, at solver tol 1e-7:
    relative error < 0.1 (the bar of tests/test_adjoint.py)."""
    m = models
    cfg = ModelCfg(mode="tomo", inv_shape=INV, prior_sigma_u=0.2, sigma=0.01)
    post = build_posterior(cfg, m["data"], Grid(SHAPE, (1.0,) * 3),
                           EikonalCfg(tol=1e-7, max_iters=200),
                           differentiable=True)
    u = _t(m["u"])
    _, g = value_and_grad(post.logpost)(Params(u=u))
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (N_CHAINS,) + INV).astype(np.float32))
    v = v / v.flatten(1).norm(dim=1).reshape(-1, 1, 1, 1)
    eps = 1e-3
    fd = (post.logpost(Params(u=u + eps * v))
          - post.logpost(Params(u=u - eps * v))) / (2 * eps)
    ad = (g.u * v).flatten(1).sum(1)
    rel = ((ad - fd).abs() / torch.maximum(ad.abs(), fd.abs())).max()
    assert float(rel) < 0.1, (ad, fd)
