"""The port's Jacobi solve (``method="jacobi"``) against the JAX package on
the CPU: ``solve_eikonal(method="jacobi")`` and ``solve_eikonal_batched(
impl="xla")`` on odd 2-D and 3-D batches (atol 1e-4, the sweep's parity
bar), the homogeneous error bounds and the sweep-vs-Jacobi agreement of
tests/test_eikonal.py, frozen seeds and a NaN slowness against the
reference's ``where``, the Jacobi gradient against JAX's implicit adjoint,
and the refusal of an unknown method. Inputs are made with numpy from a
seed; the kernels' own tests are in test_torch_cuda.py.
"""

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax
import jax.numpy as jnp

from mceik_tpu.eikonal import EikonalConfig as JEikonalConfig
from mceik_tpu.eikonal import solve_eikonal as j_solve
from mceik_tpu.eikonal.adjoint import (
    solve_eikonal_diff_batched as j_solve_diff)
from mceik_tpu.eikonal.batched import solve_eikonal_batched as j_solve_batched
from mceik_tpu.grid import Grid as JGrid

from mceik_tpu_torch.eikonal.adjoint import solve_eikonal_diff_batched
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.godunov import BIG
from mceik_tpu_torch.eikonal.solve import (EikonalConfig, jacobi_step_plain,
                                           seed_source)
from mceik_tpu_torch.grid import Grid


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Hundreds of small Jacobi passes: one intra-op thread runs them as
    fast, and keeps them from contending with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slowness(rng, shape, amp=0.3, coarse=4):
    """Smooth positive slowness: a coarse normal field upsampled linearly."""
    c = rng.standard_normal((coarse,) * len(shape))
    up = scipy.ndimage.zoom(c, [n / coarse for n in shape], order=1)
    return np.exp(amp * up).astype(np.float32)


def _radial(grid, src):
    xyz = grid.node_coords()
    return np.sqrt(np.sum((xyz - np.asarray(src)) ** 2, axis=-1))


CASES = [
    ((21, 17), (1.0, 1.0), 3),
    ((19, 23), (1.0, 1.3), 5),
    ((11, 9, 7), (1.0, 1.0, 1.0), 3),
    ((10, 9, 8), (1.0, 1.2, 0.9), 5),
]


@pytest.mark.parametrize("shape,spacing,B", CASES)
def test_jacobi_matches_jax(shape, spacing, B):
    """An odd batch of per-source slownesses: the port's batched Jacobi
    solve against JAX's ``solve_eikonal(method="jacobi")`` per source and
    ``solve_eikonal_batched(impl="xla")`` on the batch, atol 1e-4."""
    rng = np.random.default_rng(len(shape) * 10 + B)
    s = np.stack([_slowness(rng, shape) for _ in range(B)])
    lo = np.zeros(len(shape))
    hi = (np.asarray(shape) - 1) * np.asarray(spacing)
    srcs = rng.uniform(lo, hi, (B, len(shape))).astype(np.float32)
    kw = dict(method="jacobi", tol=1e-5, max_iters=400)
    out = solve_eikonal_batched(torch.from_numpy(s), torch.from_numpy(srcs),
                                Grid(shape, spacing), EikonalConfig(**kw))
    jgrid = JGrid(shape, spacing)
    jcfg = JEikonalConfig(use_pallas="off", **kw)
    ref_b = np.asarray(j_solve_batched(jnp.asarray(s), jnp.asarray(srcs),
                                       jgrid, jcfg, impl="xla"))
    ref_1 = np.stack([np.asarray(j_solve(jnp.asarray(s[b]),
                                         jnp.asarray(srcs[b]), jgrid, jcfg))
                      for b in range(B)])
    assert (out.numpy() < BIG / 2).all()
    np.testing.assert_allclose(out.numpy(), ref_b, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), ref_1, atol=1e-4)


def test_jacobi_homogeneous_2d():
    """tests/test_eikonal.py's 65^2 bounds, by the port's Jacobi solve."""
    grid = Grid((65, 65), (1.0, 1.0))
    T = solve_eikonal_batched(torch.ones(grid.shape), torch.tensor([[32.0,
                                                                     32.0]]),
                              grid, EikonalConfig(method="jacobi", tol=1e-5,
                                                  max_iters=500))[0].numpy()
    r = _radial(grid, [32.0, 32.0])
    err = np.abs(T - r)
    assert err.max() < 1.5, err.max()
    assert err[r < 20].max() < 0.7, err[r < 20].max()
    assert (T >= r - 1e-3).all()


def test_jacobi_homogeneous_3d():
    """tests/test_eikonal.py's 33^3 bounds, by the port's Jacobi solve."""
    grid = Grid((33, 33, 33), (1.0, 1.0, 1.0))
    T = solve_eikonal_batched(torch.full(grid.shape, 0.5),
                              torch.tensor([[16.0, 16.0, 16.0]]), grid,
                              EikonalConfig(method="jacobi", tol=1e-5,
                                            max_iters=500))[0].numpy()
    r = _radial(grid, [16.0, 16.0, 16.0])
    err = np.abs(T - 0.5 * r)
    assert err.max() < 0.8, err.max()
    assert (T >= 0.5 * r - 1e-3).all()


def test_sweep_matches_jacobi_random_field():
    """tests/test_eikonal.py's cross-check on a smooth random 33^2 field:
    the sweep at tol 1e-6 and the Jacobi solve at tol 1e-6 (2000 passes at
    most) agree within 5e-4."""
    grid = Grid((33, 33), (1.0, 1.0))
    c = np.random.default_rng(0).standard_normal((8, 8))
    s = torch.from_numpy(np.exp(0.3 * scipy.ndimage.zoom(
        c, 33 / 8, order=3)).astype(np.float32))
    src = torch.tensor([[5.0, 27.0]])
    Tj = solve_eikonal_batched(s, src, grid, EikonalConfig(
        method="jacobi", tol=1e-6, max_iters=2000))
    Ts = solve_eikonal_batched(s, src, grid, EikonalConfig(
        method="sweep", tol=1e-6, max_iters=100))
    assert (Tj < BIG / 2).all() and (Ts < BIG / 2).all()
    np.testing.assert_allclose(Ts.numpy(), Tj.numpy(), atol=5e-4)


@pytest.mark.parametrize("impl", ["field", "blocked", "gridbatch"])
def test_jacobi_on_every_route(impl):
    """``method="jacobi"`` is the plain Jacobi solve whatever the route:
    the kernels' routes give the plain route's bits (on the card they make
    no K1 or K3 launch for it)."""
    rng = np.random.default_rng(7)
    shape = (9, 8, 7)
    s = torch.from_numpy(np.stack([_slowness(rng, shape) for _ in range(2)]))
    srcs = torch.tensor([[1.0, 2.0, 3.0], [7.5, 4.2, 0.3]])
    cfg = EikonalConfig(method="jacobi", tol=1e-4, max_iters=100)
    grid = Grid(shape, (1.0, 1.0, 1.0))
    ref = solve_eikonal_batched(s, srcs, grid, cfg, impl="xla")
    assert torch.equal(solve_eikonal_batched(s, srcs, grid, cfg, impl=impl),
                       ref)


def test_jacobi_frozen_seed_and_nan_slowness_match_jax():
    """Frozen seed nodes are pinned by their mask, as the reference's
    ``where(frozen, T0, T_new)`` pins them: a NaN slowness outside the seed
    ball poisons the nodes it reaches, one inside it leaves the ball's
    values standing. NaN at the same places as JAX's solve, the other
    values within 1e-4."""
    shape, spacing = (15, 13), (1.0, 1.0)
    s = _slowness(np.random.default_rng(3), shape)
    s[4, 5] = np.nan            # in the seed ball of the first source
    s[12, 2] = np.nan           # far from both sources
    srcs = np.asarray([[4.0, 4.0], [2.0, 10.0]], np.float32)
    kw = dict(method="jacobi", tol=1e-5, max_iters=300)
    out = solve_eikonal_batched(torch.from_numpy(s).expand(2, *shape),
                                torch.from_numpy(srcs), Grid(shape, spacing),
                                EikonalConfig(**kw)).numpy()
    ref = np.asarray(j_solve_batched(jnp.asarray(s), jnp.asarray(srcs),
                                     JGrid(shape, spacing),
                                     JEikonalConfig(use_pallas="off", **kw),
                                     impl="xla"))
    assert np.isnan(ref).any() and np.isfinite(ref).any()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, atol=1e-4)
    T0, frozen = seed_source(torch.from_numpy(s).expand(2, *shape),
                             torch.from_numpy(srcs), Grid(shape, spacing))
    f = frozen.numpy()
    np.testing.assert_array_equal(out[f], T0.numpy()[f])


def test_jacobi_step_leaves_done_fields():
    """One pass on the fields whose done flag is clear; a done field comes
    back untouched, and every active field's frozen nodes stay at T0."""
    grid = Grid((12, 11), (1.0, 1.0))
    s = torch.from_numpy(np.stack([_slowness(np.random.default_rng(b),
                                             grid.shape) for b in range(3)]))
    srcs = torch.tensor([[3.0, 3.0], [8.0, 1.0], [6.0, 9.0]])
    T0, frozen = seed_source(s, srcs, grid)
    done = torch.tensor([False, True, False])
    T1 = jacobi_step_plain(T0, s, (T0, frozen), grid.spacing, 2, done)
    assert torch.equal(T1[1], T0[1])
    assert torch.equal(T1[frozen], T0[frozen])
    assert bool((T1[0] < T0[0]).any()) and bool((T1[2] < T0[2]).any())


@pytest.mark.parametrize("shape,spacing", [
    ((17, 15), (1.0, 1.0)),
    ((10, 9, 8), (1.0, 1.0, 1.0)),
])
def test_jacobi_gradient_matches_jax(shape, spacing):
    """The gradient of ``sum(g * T)`` through the differentiable solve with
    ``method="jacobi"`` (the Jacobi forward, then the swept transport of the
    implicit adjoint) against JAX's ``solve_eikonal_diff_batched(impl=
    "xla")``: relative L2 <= 1e-4 on the slowness and the sources, the bar
    of test_torch_adjoint.py's end-to-end gradient."""
    rng = np.random.default_rng(11)
    B = 3
    s = np.stack([_slowness(rng, shape) for _ in range(B)])
    hi = (np.asarray(shape) - 1) * np.asarray(spacing)
    srcs = rng.uniform(0.2 * hi, 0.8 * hi, (B, len(shape))).astype(np.float32)
    g = rng.standard_normal((B,) + shape).astype(np.float32)
    kw = dict(method="jacobi", tol=1e-6, max_iters=600)
    jcfg = JEikonalConfig(use_pallas="off", **kw)
    jgrid = JGrid(shape, spacing)

    def loss(s_, x_):
        return jnp.sum(jnp.asarray(g) * j_solve_diff(s_, x_, jgrid, jcfg,
                                                     impl="xla"))

    js, jx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(s), jnp.asarray(srcs))
    s_t = torch.from_numpy(s).requires_grad_(True)
    x_t = torch.from_numpy(srcs).requires_grad_(True)
    T = solve_eikonal_diff_batched(s_t, x_t, Grid(shape, spacing),
                                   EikonalConfig(**kw))
    gs, gx = torch.autograd.grad((torch.from_numpy(g) * T).sum(), [s_t, x_t])

    def rel(a, b):
        b = np.asarray(b)
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert rel(gs.numpy(), js) <= 1e-4, rel(gs.numpy(), js)
    assert rel(gx.numpy(), jx) <= 1e-4, rel(gx.numpy(), jx)


def test_unknown_method_raises():
    grid = Grid((8, 8), (1.0, 1.0))
    with pytest.raises(ValueError, match="unknown method 'bogus'"):
        solve_eikonal_batched(torch.ones(grid.shape), torch.tensor([[2.0,
                                                                     2.0]]),
                              grid, EikonalConfig(method="bogus"))
