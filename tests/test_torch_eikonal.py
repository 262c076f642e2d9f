"""Parity of the PyTorch port's eikonal pieces with the JAX package, on the
CPU: the Godunov local solve, source seeding, the plain batched sweep solve
(against the JAX XLA sweep and the Pallas kernel in interpret mode), and the
CUDA kernel wrapper's CPU dispatch. Inputs are made with numpy from a seed
and go through both packages; tolerances are stated per test. The kernel's
own tests, which need the card, are in test_torch_cuda.py.
"""

import os
import shutil

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax.numpy as jnp

from mceik_tpu.eikonal import godunov as jgod
from mceik_tpu.eikonal.batched import solve_eikonal_batched as j_solve_batched
from mceik_tpu.eikonal.pallas_sweep import sweep_solve_pallas_packed
from mceik_tpu.eikonal.solve import EikonalConfig as JEikonalConfig
from mceik_tpu.eikonal.solve import seed_source as j_seed_source
from mceik_tpu.grid import Grid as JGrid

from mceik_tpu_torch.eikonal import cuda_sweep
from mceik_tpu_torch.eikonal import godunov as tgod
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.solve import (EikonalConfig, seed_floor,
                                           seed_source, source_scalars,
                                           sweep_cycle_plain,
                                           sweep_seeded_cycle_plain,
                                           sweep_solve)
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


def _slowness(rng, shape, amp=0.3, coarse=4):
    """Smooth positive slowness: a coarse normal field upsampled linearly."""
    c = rng.standard_normal((coarse,) * len(shape))
    up = scipy.ndimage.zoom(c, [n / coarse for n in shape], order=1)
    return np.exp(amp * up).astype(np.float32)


def _neighbor_inputs(rng, D, n=4000):
    """Upwind minima with ties and BIG entries, and a slowness."""
    a = rng.uniform(0.0, 10.0, size=(D, n)).astype(np.float32)
    a[1, : n // 8] = a[0, : n // 8]                  # ties between axes
    if D == 3:
        a[2, n // 8: n // 4] = a[1, n // 8: n // 4]
        a[:, n // 4: n // 4 + 50] = 3.0              # three-way ties
    big = rng.random((D, n)) < 0.15
    a[big] = tgod.BIG
    a[:, -20:] = tgod.BIG                            # all-BIG nodes
    s = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return a, s


@pytest.mark.parametrize("D,spacing", [
    (2, (1.0, 1.0)), (2, (1.0, 1.3)),
    (3, (1.0, 1.0, 1.0)), (3, (1.0, 1.2, 0.9)),
])
def test_local_solve_matches_jax(D, spacing):
    """Both forms (closed isotropic, weighted sorted-subset), 2-D and 3-D,
    at rtol 1e-6: the same fp32 operations in the same order."""
    a, s = _neighbor_inputs(np.random.default_rng(D + len(set(spacing))), D)
    ref = np.asarray(jgod.local_solve([jnp.asarray(x) for x in a], spacing,
                                      jnp.asarray(s)))
    out = tgod.local_solve([torch.from_numpy(x) for x in a], spacing,
                           torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_neighbor_min_matches_jax():
    T = np.random.default_rng(1).uniform(0, 5, (5, 6, 7)).astype(np.float32)
    for axis in range(3):
        ref = np.asarray(jgod.neighbor_min(jnp.asarray(T), axis))
        out = tgod.neighbor_min(torch.from_numpy(T), axis).numpy()
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("spacing", [(1.0, 1.0, 1.0), (1.0, 1.2, 0.9)])
def test_seed_source_matches_jax(spacing):
    """Same seed ball; T0 at rtol 1e-6 (the source slowness is read by
    grid_sample here and map_coordinates there)."""
    rng = np.random.default_rng(2)
    shape = (16, 12, 16)
    srcs = np.array([[3.3, 5.0, 7.1], [0.0, 11.0, 2.5], [14.2, 0.4, 15.0]],
                    np.float32) * np.asarray(spacing, np.float32)
    s = np.stack([_slowness(rng, shape) for _ in srcs])
    jg = JGrid(shape, spacing)
    T0, mask = seed_source(torch.from_numpy(s), torch.from_numpy(srcs),
                           Grid(shape, spacing), 3.0)
    for b in range(len(srcs)):
        rT0, rmask = j_seed_source(jnp.asarray(s[b]), jnp.asarray(srcs[b]),
                                   jg, 3.0)
        np.testing.assert_array_equal(mask[b].numpy(), np.asarray(rmask))
        np.testing.assert_allclose(T0[b].numpy(), np.asarray(rT0), rtol=1e-6)


def test_batched_plain_solve_matches_jax_xla():
    """Odd batch B = 3 at tol 1e-5 against the JAX XLA sweep, atol 1e-4
    (the bar of test_pallas_sweep.py's batched-route test). The default
    route on CPU tensors is the plain sweep: the kernel is never launched."""
    rng = np.random.default_rng(5)
    shape = (16, 12, 16)
    s = _slowness(rng, shape)
    srcs = np.array([[2.0, 3.0, 4.0], [13.0, 9.0, 2.0], [8.0, 6.0, 8.0]],
                    np.float32)
    ref = np.asarray(j_solve_batched(
        jnp.asarray(s), jnp.asarray(srcs), JGrid(shape, (1.0, 1.0, 1.0)),
        JEikonalConfig(tol=1e-5, max_iters=60), impl="xla"))
    launches = cuda_sweep.SWEEP3D.launches
    out = solve_eikonal_batched(torch.from_numpy(s), torch.from_numpy(srcs),
                                Grid(shape, (1.0, 1.0, 1.0)),
                                EikonalConfig(tol=1e-5, max_iters=60))
    assert out.shape == (3,) + shape
    assert cuda_sweep.SWEEP3D.launches == launches
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_plain_solve_matches_pallas_fused012_interpret():
    """Against the TPU kernel the port replaces (sweep_axes012_fused, via
    sweep_solve_pallas_packed in interpret mode) on a 16^3 cube with
    unequal spacing, atol 1e-4 (as test_pallas_sweep.py's fused012 test).
    The Pallas solve converges jointly per pack, the port per field:
    differences within tol are expected."""
    rng = np.random.default_rng(29)
    shape, spacing = (16, 16, 16), (1.0, 1.1, 0.9)
    jg = JGrid(shape, spacing)
    srcs = np.array([[2.0, 7.0, 13.0], [9.0, 7.0, 6.0]], np.float32)
    s = np.stack([_slowness(rng, shape) for _ in srcs])
    T0s, frs = zip(*[j_seed_source(jnp.asarray(s[i]), jnp.asarray(srcs[i]),
                                   jg, 3.0) for i in range(len(srcs))])
    si = jnp.stack([jg.to_index_coords(jnp.asarray(x)) for x in srcs])
    ref = np.asarray(sweep_solve_pallas_packed(
        jnp.stack(T0s), jnp.stack(frs), jnp.asarray(s), spacing, tol=1e-5,
        max_cycles=60, interpret=True, src_idx=si, seed_radius=3.0))
    out = solve_eikonal_batched(
        torch.from_numpy(s), torch.from_numpy(srcs), Grid(shape, spacing),
        EikonalConfig(tol=1e-5, max_iters=60, use_pallas="off"))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_cuda_sweep_cpu_dispatch():
    """The kernel module imports without nvcc or a card; a CPU tensor goes
    to the plain version and leaves the launch counter at 0 (the seeded
    cycle's plain version, the same bits; ``cuda_sweep.solve`` the host
    loop ``sweep_solve`` around it, the same bits); the kernel itself
    refuses CPU tensors; a Pallas-only mode is refused; without nvcc
    the build raises."""
    shape = (6, 5, 4)
    rng = np.random.default_rng(3)
    s = torch.from_numpy(np.stack([_slowness(rng, shape, coarse=2)] * 2))
    g = Grid(shape, (1.0, 1.0, 1.0))
    T0, frozen = seed_source(s, torch.tensor([[1.0, 2.0, 3.0]] * 2), g, 1.0)
    fl = seed_floor(T0, frozen)
    done = torch.tensor([False, True])
    scal = torch.cat(source_scalars(s, torch.tensor([[1.0, 2.0, 3.0]] * 2),
                                    g), dim=1).contiguous()
    out = cuda_sweep.seeded_cycle(T0, s, scal, g.spacing, 2, done,
                                  seed_radius=1.0)
    assert cuda_sweep.SWEEP3D.launches == 0
    np.testing.assert_array_equal(
        out.numpy(), sweep_cycle_plain(T0, s, fl, g.spacing, 2, done).numpy())
    np.testing.assert_array_equal(out[1].numpy(), T0[1].numpy())
    assert float((out[0] - T0[0]).abs().max()) > 1.0
    ref = sweep_solve(T0, scal, s, g.spacing, 1e-5, 40, 2,
                      cycle=lambda *a: sweep_seeded_cycle_plain(
                          *a, seed_radius=1.0))
    out = cuda_sweep.solve(T0, s, scal, g.spacing, 1e-5, 40, 2,
                           seed_radius=1.0)
    assert cuda_sweep.SWEEP3D.launches == 0
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.SWEEP3D.solve(T0, s, scal, g.spacing, 2, 1e-3, 10,
                                 seed_radius=1.0)
    with pytest.raises(ValueError):
        solve_eikonal_batched(s[0], torch.tensor([[1.0, 2.0, 3.0]]), g,
                              EikonalConfig(use_pallas="interpret"))
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_sweep.Sweep3dKernel().build()


@pytest.mark.parametrize("max_cycles,per_iter", [
    (-1, 1), (10, 0), (10, -2), (2 ** 30, 2)])
def test_k1_solve_refuses_bad_counts_before_build(max_cycles, per_iter,
                                                  monkeypatch):
    """K1's solve entry refuses a negative iteration count, a counted
    iteration of fewer than one cycle and a cycle count past 32 bits with
    ValueError before anything is built or launched."""
    k = cuda_sweep.Sweep3dKernel()
    monkeypatch.setattr(k, "build", lambda: pytest.fail("built"))
    T = torch.zeros((2, 6, 5, 4))
    with pytest.raises(ValueError, match="max_cycles .* cycles_per_iter"):
        k.solve(T, T, torch.zeros((2, 4)), (1.0, 1.0, 1.0), 2, 1e-3,
                max_cycles, seed_radius=3.0, cycles_per_iter=per_iter)
    assert k.launches == 0
