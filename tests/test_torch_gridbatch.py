"""The port's gridbatch route on the CPU: ``solve_eikonal_batched(...,
impl="gridbatch")``, the counterpart of the TPU kernel
``sweep_axis0_gridbatch`` (pallas_sweep.py:740), is the ``"field"`` route:
on the card both sweep with K1 (``csrc/sweep3d.cu``), which rebuilds the
seed floor from four scalars per field as the TPU's gridbatch kernel does.
Its plain version (``solve.seeded_floor_plain`` then
``solve.sweep_cycle_plain``) is held here against
``seed_floor(*seed_source(...))`` bit for bit and, through the whole solve,
against JAX's gridbatch in interpret mode, mirroring
tests/test_pallas_sweep.py's gridbatch tests. Inputs are made with numpy
from seeds; tolerances are stated per test. K1 itself is tested on the card
in test_torch_cuda.py."""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mceik_tpu.eikonal.batched import solve_eikonal_batched as j_solve_batched
from mceik_tpu.eikonal.solve import EikonalConfig as JEikonalConfig
from mceik_tpu.grid import Grid as JGrid

from mceik_tpu_torch.eikonal import cuda_sweep
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.solve import (EikonalConfig, seed_floor,
                                           seed_source, seeded_floor_plain,
                                           source_scalars, sweep_cycle_plain)
from mceik_tpu_torch.grid import Grid


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The plain CPU solves here are thousands of tiny ops on small grids:
    one intra-op thread runs them as fast, and keeps them from contending
    with other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRID = Grid((16, 12, 16), (1.0, 1.0, 1.0))


def _smooth(shape, seed, coarse=4, amp=0.3):
    """A smooth positive field: coarse normals, upsampled, exponentiated."""
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.standard_normal((1, 1) + (coarse,) * len(shape))
                         .astype(np.float32))
    mode = "trilinear" if len(shape) == 3 else "bilinear"
    up = torch.nn.functional.interpolate(c, size=shape, mode=mode,
                                         align_corners=False)[0, 0]
    return torch.exp(amp * up)


def _scal(s, srcs, grid):
    src_idx, s_src = source_scalars(s, srcs, grid)
    return torch.cat([src_idx, s_src], dim=1)


@pytest.mark.parametrize("shape,spacing,radius", [
    ((16, 12, 16), (1.0, 1.0, 1.0), 3.0),
    ((9, 10, 11), (1.0, 1.2, 0.9), 3.0),
    ((9, 10, 11), (0.5, 0.5, 0.5), 2.0),
    ((13, 17), (1.0, 1.25), 3.0),
])
def test_seeded_floor_equals_seed_floor_bitwise(shape, spacing, radius):
    """The floor rebuilt from the (a, b, c, s_src) scalars equals
    ``seed_floor(*seed_source(...))`` bit for bit: on nodes, between nodes
    and at the grid's corner."""
    grid = Grid(shape, spacing)
    s = torch.stack([_smooth(shape, i) for i in range(3)])
    ext = torch.tensor(grid.extent)
    srcs = torch.stack([torch.zeros(len(shape)), 0.37 * ext,
                        torch.tensor([2.0] * len(shape)) * torch.tensor(spacing)])
    T0, frozen = seed_source(s, srcs, grid, radius)
    want = seed_floor(T0, frozen)
    got = seeded_floor_plain(_scal(s, srcs, grid), shape, spacing, radius)
    assert torch.equal(got, want)
    assert int((want > 0).sum()) > 3 * 8


def test_gridbatch_matches_jax_gridbatch_interpret():
    """tests/test_pallas_sweep.py::test_gridbatch_multiblock_heterogeneous_
    convergence on the port: 8 easy homogeneous fields and 8 high-contrast
    ones on 16x12x16, JAX's gridbatch (two lane-packed blocks, per-block
    done flags, interpret mode) against the port's (per-field done flags),
    tol 1e-5: atol 2e-3, the reference test's bar."""
    P = 8
    s_hard = torch.stack([_smooth(GRID.shape, 11 + i, coarse=3, amp=0.8)
                          for i in range(P)])
    s = torch.cat([torch.ones((P,) + GRID.shape), s_hard])
    srcs = torch.tensor([[2.0 + (i % 5), 3.0 + (i % 4), 2.0 + i % 7]
                         for i in range(2 * P)])
    ref = np.asarray(j_solve_batched(
        jnp.asarray(s.numpy()), jnp.asarray(srcs.numpy()),
        JGrid(GRID.shape, GRID.spacing),
        JEikonalConfig(method="sweep", tol=1e-5, max_iters=60),
        impl="gridbatch", interpret=True))
    cfg = EikonalConfig(tol=1e-5, max_iters=60)
    T = solve_eikonal_batched(s, srcs, GRID, cfg, impl="gridbatch")
    np.testing.assert_allclose(T.numpy(), ref, atol=2e-3)
    # The gridbatch route is the field route, and the seeded floor is the
    # floor operand's: it equals "field" and the plain "xla" route.
    assert torch.equal(T, solve_eikonal_batched(s, srcs, GRID, cfg,
                                                impl="field"))
    assert torch.equal(T, solve_eikonal_batched(s, srcs, GRID, cfg,
                                                impl="xla"))


def test_done_field_passes_through_unswept():
    """tests/test_pallas_sweep.py::test_gridbatch_done_block_passes_through_
    unswept on the port, per field: a field whose done flag is set comes
    back unchanged from the seeded cycle, the others equal the plain cycle
    with the floor operand."""
    s = torch.stack([_smooth(GRID.shape, 13 + i) for i in range(3)])
    srcs = torch.tensor([[2.0, 5.0, 3.0], [9.0, 5.0, 4.0], [4.0, 2.0, 12.0]])
    T0, frozen = seed_source(s, srcs, GRID, 3.0)
    done = torch.tensor([False, True, False])
    out = cuda_sweep.seeded_cycle(T0, s, _scal(s, srcs, GRID), GRID.spacing,
                                  2, done, seed_radius=3.0)
    assert torch.equal(out[1], T0[1])
    assert float((out[0] - T0[0]).abs().max()) > 1.0
    assert torch.equal(out, sweep_cycle_plain(T0, s, seed_floor(T0, frozen),
                                              GRID.spacing, 2, done))


def test_gridbatch_refusals():
    """``impl="gridbatch"`` on a 2-D grid raises ValueError, as the
    reference asserts (pallas_sweep.py:697); an unknown impl raises; K1's
    wrapper refuses CPU tensors and a 2-D batch; without nvcc its build
    raises."""
    g2 = Grid((9, 9), (1.0, 1.0))
    with pytest.raises(ValueError, match="3-D only"):
        solve_eikonal_batched(torch.ones((2, 9, 9)), torch.zeros((2, 2)), g2,
                              impl="gridbatch")
    with pytest.raises(ValueError, match="unknown impl"):
        solve_eikonal_batched(torch.ones((2, 9, 9)), torch.zeros((2, 2)), g2,
                              impl="packed")
    T = torch.zeros((2,) + GRID.shape)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.SWEEP3D.solve(T, T, torch.zeros((2, 4)), GRID.spacing, 2,
                                 1e-3, 10, seed_radius=3.0)
    with pytest.raises(ValueError, match="\\(B, nx, ny, nz\\)"):
        cuda_sweep.SWEEP3D.solve(T[:, 0], T[:, 0], torch.zeros((2, 4)),
                                 (1.0, 1.0), 2, 1e-3, 10, seed_radius=3.0)
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_sweep.Sweep3dKernel().build()


@pytest.mark.parametrize("scal", [
    torch.zeros((2, 3)),                          # wrong width
    torch.zeros((3, 4)),                          # wrong field count
    torch.zeros((2, 4), dtype=torch.float64),     # wrong dtype
    torch.zeros((4, 2)).t(),                      # not contiguous
    torch.zeros((2, 4), device="meta"),           # another device than T
])
def test_wrapper_refuses_bad_scal_before_build(scal, monkeypatch):
    """K1's wrapper checks the (B, 4) source scalars before anything is
    built or launched: a wrong shape, dtype, layout or device raises
    ValueError naming ``scal``, and the build is never called."""
    k = cuda_sweep.Sweep3dKernel()
    monkeypatch.setattr(k, "build", lambda: pytest.fail("built"))
    T = torch.zeros((2,) + GRID.shape)
    with pytest.raises(ValueError, match="scal"):
        k.solve(T, T, scal, GRID.spacing, 2, 1e-3, 10, seed_radius=3.0)
    assert k.launches == 0
