"""The port's binding of the C++ serial fast-sweeping oracle
(``mceik_tpu_torch/native``, ``native/fsm.cc``) on the CPU: the cases of
tests/test_native.py through the port's binding and its plain batched
solve (atol 2e-3), the port's ``fsm_solve`` bit for bit with the JAX
package's on the same input, and the library built under ``build/native/``
(never in a package directory)."""

import os

import numpy as np
import pytest
import torch

from mceik_tpu.grid import Grid as JGrid
from mceik_tpu.native import fsm_solve as j_fsm_solve

from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.solve import EikonalConfig
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.params import slowness_from_u
from mceik_tpu_torch.native import fsm, fsm_solve, have_native

pytestmark = pytest.mark.skipif(not have_native(),
                                reason="g++ unavailable / build failed")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small plain solves: one intra-op thread runs them as fast, and keeps
    them from contending with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smooth(seed, grid, amp=0.3):
    """tests/test_native.py's medium with numpy's draw: exp of a 5^D
    normal field upsampled linearly."""
    u = np.random.default_rng(seed).standard_normal((5,) * grid.ndim)
    return slowness_from_u(torch.tensor(amp * u, dtype=torch.float32), grid,
                           torch.tensor(1.0))


def _plain(s, src, grid):
    cfg = EikonalConfig(method="sweep", tol=1e-6, max_iters=200,
                        use_pallas="off")
    return solve_eikonal_batched(s, torch.tensor([src], dtype=torch.float32),
                                 grid, cfg)[0].numpy()


@pytest.mark.parametrize("shape", [(33, 29), (17, 15, 13)])
def test_fsm_matches_plain_solve(shape):
    grid = Grid(shape, tuple(1.0 for _ in shape))
    s = _smooth(5, grid)
    src = [3.0] * len(shape)
    T_cpp, n_passes = fsm_solve(s, np.asarray(src), grid, tol=1e-8,
                                max_passes=100)
    assert n_passes >= 1
    np.testing.assert_allclose(T_cpp, _plain(s, src, grid), atol=2e-3)


def test_fsm_anisotropic():
    grid = Grid((25, 19), (0.5, 1.0), origin=(1.0, -2.0))
    src = [6.0, 5.0]                 # physical, inside the grid
    T_cpp, _ = fsm_solve(np.ones(grid.shape, np.float32), np.asarray(src),
                         grid, tol=1e-8)
    np.testing.assert_allclose(T_cpp, _plain(torch.ones(grid.shape), src,
                                             grid), atol=2e-3)


@pytest.mark.parametrize("shape,spacing,origin,src", [
    ((25, 19), (0.5, 1.0), (1.0, -2.0), (6.0, 5.0)),
    ((12, 11, 9), (1.0, 1.2, 0.9), (0.0, 0.0, 0.0), (4.3, 7.1, 2.2)),
])
def test_fsm_equals_jax_binding(shape, spacing, origin, src):
    """The same library on the same input through both bindings: the same
    bits and the same pass count (a tensor is taken as its array)."""
    s = _smooth(9, Grid(shape, spacing, origin))
    T, n = fsm_solve(s, torch.tensor(src), Grid(shape, spacing, origin),
                     tol=1e-8)
    T_j, n_j = j_fsm_solve(s.numpy(), np.asarray(src),
                           JGrid(shape, spacing, origin), tol=1e-8)
    assert n == n_j
    np.testing.assert_array_equal(T, T_j)


def test_library_built_under_build_native():
    fsm_solve(np.ones((6, 5), np.float32), np.asarray([1.0, 1.0]),
              Grid((6, 5), (1.0, 1.0)))
    path = fsm.library_path()
    assert path.exists()
    assert str(path.parent) == os.path.join(REPO, "build", "native")
    assert not os.path.exists(os.path.join(REPO, "mceik_tpu_torch", "native",
                                           "_fsm.so"))
    with pytest.raises(ValueError, match="slowness"):
        fsm_solve(np.ones((5, 5), np.float32), [1.0, 1.0],
                  Grid((6, 5), (1.0, 1.0)))
