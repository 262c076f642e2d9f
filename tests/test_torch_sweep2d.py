"""Parity of the PyTorch port's 2-D eikonal solve with the JAX package on
the CPU: the port's plain 2-D batched solve, and its plain per-field loop
(the plain version of K3's solve entry), against the TPU kernel it
replaces (``sweep_solve_pallas_2d_lanebatched``, the lane-batched K3 route,
in interpret mode) and against JAX's XLA sweep, on an anisotropic odd batch
and on a 48^2 batch that mixes a field done in two cycles with strongly
contrasted ones; the per-field loop against the batch host loop, bit for
bit with the cycle counts; the sweep dispatch of a CPU 2-D batch; and K3's
wrapper refusals. Inputs are made with numpy from a seed. K3 itself runs
only on the card (tests/test_torch_cuda.py)."""

import os
import shutil

import numpy as np
import pytest
import scipy.ndimage
import torch

import jax.numpy as jnp

from mceik_tpu.eikonal.batched import solve_eikonal_batched as j_solve_batched
from mceik_tpu.eikonal.pallas_sweep import sweep_solve_pallas_2d_lanebatched
from mceik_tpu.eikonal.solve import EikonalConfig as JEikonalConfig
from mceik_tpu.eikonal.solve import seed_source as j_seed_source
from mceik_tpu.grid import Grid as JGrid

from mceik_tpu_torch.eikonal import cuda_sweep, cuda_sweep2d
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.solve import (EikonalConfig, seed_floor,
                                           seed_source, source_scalars,
                                           sweep_cycle_plain, sweep_solve,
                                           sweep_solve_fields_plain)
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


def _slowness(rng, shape, amp, coarse=4):
    """Smooth positive slowness: a coarse normal field upsampled linearly."""
    c = rng.standard_normal((coarse,) * len(shape))
    up = scipy.ndimage.zoom(c, [n / coarse for n in shape], order=1)
    return np.exp(amp * up).astype(np.float32)


def _jax_k3(s, srcs, shape, spacing, tol, max_cycles, T0=None):
    """JAX's K3 route: per-field seeds (or the given start ``T0`` with the
    seed balls frozen), then the lane-batched Pallas solve in interpret mode
    (joint convergence over the batch)."""
    jg = JGrid(shape, spacing)
    T0s, frs = zip(*[j_seed_source(jnp.asarray(s[b]), jnp.asarray(srcs[b]),
                                   jg, 3.0) for b in range(len(srcs))])
    start = jnp.stack(T0s) if T0 is None else jnp.asarray(T0)
    return np.asarray(sweep_solve_pallas_2d_lanebatched(
        start, jnp.stack(frs), jnp.asarray(s), spacing, tol, max_cycles, 2,
        interpret=True))


def _jax_xla(s, srcs, shape, spacing, tol, max_cycles):
    return np.asarray(j_solve_batched(
        jnp.asarray(s), jnp.asarray(srcs), JGrid(shape, spacing),
        JEikonalConfig(tol=tol, max_iters=max_cycles), impl="xla"))


def _scal(s, srcs, g):
    return torch.cat(source_scalars(s, srcs, g), dim=1).contiguous()


@pytest.mark.parametrize("solver", ["batched", "per_field"])
def test_plain_2d_solve_matches_jax_k3_and_xla(solver):
    """17x13 grid, spacing (1.0, 1.3) (the weighted local solve), B = 5 at
    tol 1e-5: atol 1e-4 against both JAX routes (5.7e-6 measured against
    K3), for the port's batched solve and for its plain per-field loop
    (``sweep_solve_fields_plain``, the plain version of K3's solve entry,
    against JAX's per-field XLA solves). The kernel is not launched for CPU
    tensors."""
    rng = np.random.default_rng(11)
    shape, spacing = (17, 13), (1.0, 1.3)
    s = np.stack([_slowness(rng, shape, 0.4) for _ in range(5)])
    srcs = (rng.uniform(0.05, 0.95, (5, 2))
            * np.array([16.0, 12 * 1.3])).astype(np.float32)
    launches = cuda_sweep2d.SWEEP2D.launches
    g = Grid(shape, spacing)
    st, xt = torch.from_numpy(s), torch.from_numpy(srcs)
    if solver == "batched":
        out = solve_eikonal_batched(st, xt, g, EikonalConfig(
            tol=1e-5, max_iters=60)).numpy()
    else:
        T0, _ = seed_source(st, xt, g, 3.0)
        out = sweep_solve_fields_plain(T0, st, _scal(st, xt, g), spacing,
                                       1e-5, 60, 2, seed_radius=3.0)[0].numpy()
    assert cuda_sweep2d.SWEEP2D.launches == launches
    assert out.shape == (5,) + shape
    np.testing.assert_allclose(
        out, _jax_k3(s, srcs, shape, spacing, 1e-5, 60), atol=1e-4)
    np.testing.assert_allclose(
        out, _jax_xla(s, srcs, shape, spacing, 1e-5, 60), atol=1e-4)


def test_plain_2d_solve_mixed_convergence_matches_jax():
    """A 48^2 batch (config 4's grid) at its tol 1e-3: field 0 starts at its
    own fixed point and is done after one cycle; three strongly contrasted
    fields start from their seeds and take many more. The port stops each
    field on its own, and its done flags leave the early field alone; JAX's
    K3 sweeps the batch jointly until the slowest field is done, and XLA's
    sweep starts every field from its seed. Differences within tol would
    not be faults; atol 1e-4 holds (1.1e-5 measured)."""
    rng = np.random.default_rng(12)
    shape, spacing = (48, 48), (1.0, 1.0)
    s = np.stack([_slowness(rng, shape, a) for a in (0.2, 1.0, 1.0, 1.0)])
    srcs = np.array([[10.0, 30.0], [3.7, 40.0], [24.0, 24.0], [45.0, 2.0]],
                    np.float32)
    g = Grid(shape, spacing)
    st, xt = torch.from_numpy(s), torch.from_numpy(srcs)
    T0, frozen = seed_source(st, xt, g, 3.0)
    T0[0] = solve_eikonal_batched(st[:1], xt[:1], g, EikonalConfig(
        tol=1e-6, max_iters=200))[0]
    history = []

    def recording_cycle(T, s_, sc, sp, n_inner, done):
        history.append(done.clone())
        return cuda_sweep.seeded_cycle(T, s_, sc, sp, n_inner, done,
                                       seed_radius=3.0)

    out, counted = sweep_solve(T0, _scal(st, xt, g), st, g.spacing, 1e-3, 30,
                               2, cycle=recording_cycle, return_cycles=True)
    out = out.numpy()
    cycles = (~torch.stack(history)).sum(0).tolist()
    assert cycles[0] == 1 and min(cycles[1:]) > 2, cycles
    assert counted.tolist() == cycles
    np.testing.assert_allclose(
        out, _jax_k3(s, srcs, shape, spacing, 1e-3, 30, T0=T0.numpy()),
        atol=1e-4)
    np.testing.assert_allclose(
        out, _jax_xla(s, srcs, shape, spacing, 1e-3, 30), atol=1e-4)


def _cpu_batch(shape=(9, 7), spacing=(1.0, 1.25)):
    rng = np.random.default_rng(3)
    s = torch.from_numpy(np.stack([_slowness(rng, shape, 0.3, 2)] * 3))
    g = Grid(shape, spacing)
    srcs = torch.tensor([[1.0, 2.0], [6.0, 3.0], [4.0, 7.0]])
    T0, frozen = seed_source(s, srcs, g, 1.0)
    return g, s, T0, seed_floor(T0, frozen), _scal(s, srcs, g)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _solve_case(case):
    """A CPU 2-D batch for the per-field loop: 21x17 at spacing (1.0, 1.2)
    and tol 1e-5, five fields of different contrast, field 0 started from
    its own fixed point ("mixed": converged counts 1 to many); the same
    with a NaN in field 2's slowness ("nan_in_s": that field is NaN and
    stops after one cycle, as not (NaN > tol)); or cut at three cycles
    ("max_cycles")."""
    rng = np.random.default_rng(21)
    shape, spacing = (21, 17), (1.0, 1.2)
    s = torch.from_numpy(np.stack([_slowness(rng, shape, a, 3)
                                   for a in (0.2, 0.3, 0.6, 0.9, 1.2)]))
    if case == "nan_in_s":
        s[2, 10, 8] = float("nan")
    g = Grid(shape, spacing)
    srcs = torch.from_numpy((rng.uniform(0.1, 0.9, (5, 2))
                             * np.array([20.0, 16 * 1.2])).astype(np.float32))
    T0, _ = seed_source(s, srcs, g, 3.0)
    T0[0] = solve_eikonal_batched(s[:1], srcs[:1], g, EikonalConfig(
        tol=1e-7, max_iters=200))[0]
    max_cycles = 3 if case == "max_cycles" else 60
    return T0, s, _scal(s, srcs, g), spacing, 1e-5, max_cycles


@pytest.mark.parametrize("case", ["mixed", "nan_in_s", "max_cycles"])
def test_per_field_loop_equals_batch_loop(case):
    """The plain per-field loop (each field alone to its own convergence)
    equals the batch host loop ``sweep_solve`` around the plain seeded
    cycle bit for bit, NaN included, with the same per-field cycle counts;
    and ``cuda_sweep.solve`` on these CPU tensors is that host loop."""
    T0, s, scal, spacing, tol, max_cycles = _solve_case(case)
    ref, ref_cycles = sweep_solve(
        T0, scal, s, spacing, tol, max_cycles, 2, return_cycles=True,
        cycle=lambda *a: cuda_sweep.seeded_cycle(*a, seed_radius=3.0))
    out, cycles = sweep_solve_fields_plain(T0, s, scal, spacing, tol,
                                           max_cycles, 2, seed_radius=3.0)
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(cycles, ref_cycles)
    launches = cuda_sweep2d.SWEEP2D.launches
    assert torch.equal(_bits(cuda_sweep.solve(
        T0, s, scal, spacing, tol, max_cycles, 2, seed_radius=3.0)),
        _bits(ref))
    assert cuda_sweep2d.SWEEP2D.launches == launches
    counts = cycles.tolist()
    if case == "mixed":
        assert counts[0] == 1 and max(counts) > 3 and len(set(counts)) > 2
    elif case == "nan_in_s":
        assert counts[2] == 1 and torch.isnan(out[2]).any()
        assert torch.isfinite(out[[0, 1, 3, 4]]).all()
    else:
        assert counts == [1, 3, 3, 3, 3]


def test_sweep_cycle_cpu_dispatch_2d():
    """A CPU 2-D batch goes to the plain cycle (equal to it, done field
    untouched) and never to K3."""
    g, s, T0, fl, scal = _cpu_batch()
    done = torch.tensor([False, True, False])
    out = cuda_sweep.seeded_cycle(T0, s, scal, g.spacing, 2, done,
                                  seed_radius=1.0)
    assert cuda_sweep2d.SWEEP2D.launches == 0
    np.testing.assert_array_equal(
        out.numpy(), sweep_cycle_plain(T0, s, fl, g.spacing, 2, done).numpy())
    np.testing.assert_array_equal(out[1].numpy(), T0[1].numpy())
    assert float((out[0] - T0[0]).abs().max()) > 1.0


def test_sweep2d_wrapper_refuses_bad_inputs():
    """K3's wrapper checks before anything is built or launched: CPU
    tensors, the wrong dtype, a non-contiguous operand, a field too large
    for one block's shared memory, a line longer than a warp holds, source
    scalars of the wrong shape, a batch of the wrong rank and a solve of
    more than one cycle per iteration raise ValueError. The kernel object
    exists without nvcc (the build is lazy); building it without nvcc
    raises."""
    g, s, T0, fl, scal = _cpu_batch()
    k = cuda_sweep2d.Sweep2dKernel()
    with pytest.raises(ValueError, match="CUDA"):
        k.cycle(T0, s, scal, g.spacing, 2, seed_radius=1.0)
    with pytest.raises(ValueError, match="float32"):
        k.cycle(T0.double(), s, scal, g.spacing, 2, seed_radius=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        k.cycle(T0, s.transpose(1, 2).contiguous().transpose(1, 2), scal,
                g.spacing, 2, seed_radius=1.0)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((1, 300, 200))
        k.solve(big, big, big[:, 0, :3].contiguous(), (1.0, 1.0), 2, 1e-3,
                10, seed_radius=3.0)
    with pytest.raises(ValueError, match="at most 1024 nodes"):
        long = torch.zeros((1, 2, 1100))
        k.cycle(long, long, long[:, 0, :3].contiguous(), (1.0, 1.0), 2,
                seed_radius=3.0)
    with pytest.raises(ValueError, match=r"\(B, n0, n1\)"):
        k.cycle(T0[None], s[None], scal, g.spacing, 2, seed_radius=1.0)
    with pytest.raises(ValueError, match="one cycle per counted"):
        k.solve(T0, s, scal, g.spacing, 2, 1e-3, 10, seed_radius=1.0,
                cycles_per_iter=2)
    assert cuda_sweep2d.smem_bytes((48, 48)) == 4 * 2 * 48 * 49
    assert cuda_sweep2d.smem_bytes((65, 65)) == 4 * 2 * 65 * 65
    # The block route adds two line buffers and a float per warp; it holds
    # every square the warp route takes, not a 1024-node line's field.
    assert cuda_sweep2d.block_smem_bytes((65, 65)) == 4 * (
        2 * 65 * 65 + 2 * 96 + 32)
    assert (cuda_sweep2d.block_smem_bytes((169, 169))
            <= cuda_sweep2d.MAX_SMEM_BYTES
            < cuda_sweep2d.block_smem_bytes((28, 1024)))
    assert k.launches == 0 and k.block_launches == 0
    if shutil.which("nvcc") is None and not os.path.exists(
            "/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc"):
            k.build()
