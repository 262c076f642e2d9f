"""Tests of the CUDA kernels (``mceik_tpu_torch/csrc/sweep3d.cu``, K1,
``csrc/transport3d.cu``, K4, and ``csrc/sweep2d.cu``, K3) against their plain
PyTorch versions. They need an NVIDIA GPU with nvcc and skip elsewhere. This file imports no JAX, so it runs on a machine without
it; there, skip tests/conftest.py (which configures JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from mceik_tpu_torch.eikonal import cuda_sweep, cuda_sweep2d, cuda_transport
from mceik_tpu_torch.eikonal.adjoint_sweep import (transport_cycle_plain,
                                                   transport_solve,
                                                   transport_weights)
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.solve import (EikonalConfig, seed_floor,
                                           seed_source, sweep_cycle_plain,
                                           sweep_solve)
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.params import slowness_from_u


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda")


def _batch(dev, shape, spacing, srcs, seed=4, amp=0.3):
    gen = torch.Generator().manual_seed(seed)
    u = amp * torch.randn((len(srcs), 5, 5, 5), generator=gen)
    g = Grid(shape, spacing)
    s = slowness_from_u(u, g, torch.tensor(1.0)).to(dev)
    srcs = torch.tensor(srcs, dtype=torch.float32, device=dev)
    T0, frozen = seed_source(s, srcs, g, 3.0)
    return g, s, srcs, T0, seed_floor(T0, frozen)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,spacing", [
    ((24, 20, 16), (1.0, 1.2, 0.9)),    # weighted local solve, non-cube
    ((32, 32, 32), (1.0, 1.0, 1.0)),    # closed isotropic form
])
def test_kernel_cycle_matches_plain(dev, shape, spacing):
    """One launch equals one plain cycle (the same fp32 operations: bar
    1e-4), and a done field passes through untouched."""
    g, s, _, T0, fl = _batch(dev, shape, spacing,
                             [[3.0, 4.0, 5.0], [20.0, 10.0, 2.0],
                              [12.0, 18.0, 9.0]])
    done = torch.tensor([False, True, False], device=dev)
    launches = cuda_sweep.SWEEP3D.launches
    out = cuda_sweep.sweep_cycle(T0, s, fl, g.spacing, 2, done)
    torch.cuda.synchronize()
    assert cuda_sweep.SWEEP3D.launches == launches + 1
    ref = sweep_cycle_plain(T0, s, fl, g.spacing, 2, done)
    assert float((out - ref).abs().max()) <= 1e-4
    assert torch.equal(out[1], T0[1])
    assert float((out[0] - T0[0]).abs().max()) > 1.0


@pytest.mark.cuda
def test_kernel_solve_matches_plain_solve(dev):
    """A whole batched solve at tol 1e-5 through the kernel equals the
    plain solve on the card within 1e-4."""
    g, s, srcs, _, _ = _batch(dev, (32, 24, 16), (1.0, 1.0, 1.0),
                              [[2.0, 3.0, 4.0], [30.0, 20.0, 2.0],
                               [15.0, 12.0, 8.0], [0.0, 0.0, 0.0],
                               [31.0, 23.0, 15.0]], amp=0.6)
    launches = cuda_sweep.SWEEP3D.launches
    out = solve_eikonal_batched(s, srcs, g, EikonalConfig(tol=1e-5,
                                                          max_iters=100))
    assert cuda_sweep.SWEEP3D.launches > launches
    ref = solve_eikonal_batched(s, srcs, g, EikonalConfig(
        tol=1e-5, max_iters=100, use_pallas="off"))
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_wrapper_checks_inputs(dev):
    g, s, _, T0, fl = _batch(dev, (8, 8, 8), (1.0, 1.0, 1.0),
                             [[1.0, 2.0, 3.0]])
    k = cuda_sweep.SWEEP3D
    with pytest.raises(ValueError, match="float32"):
        k(T0.double(), s, fl, g.spacing, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k(T0.transpose(1, 2), s, fl, g.spacing, 2)
    with pytest.raises(ValueError, match="shared"):
        big = torch.zeros((1, 8, 140, 140), device=dev)
        k(big, big, big, g.spacing, 2)
    np.testing.assert_array_equal(
        k(T0, s, fl, g.spacing, 2, torch.ones(1, dtype=torch.bool,
                                                device=dev)).cpu().numpy(),
        T0.cpu().numpy())


def _transport_batch(dev, shape, spacing, srcs, seed=5):
    """Converged fields from K1, their signed weights and random g."""
    g_, s, srcs_t, _, _ = _batch(dev, shape, spacing, srcs, seed=seed)
    T = solve_eikonal_batched(s, srcs_t, g_, EikonalConfig(tol=1e-5,
                                                           max_iters=100))
    _, frozen = seed_source(s, srcs_t, g_, 3.0)
    ws = transport_weights(T, s, frozen, g_.spacing)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = 0.1 * torch.randn(T.shape, generator=gen, device=dev)
    return ws, g


@pytest.mark.cuda
@pytest.mark.parametrize("shape,spacing", [
    ((24, 20, 16), (1.0, 1.2, 0.9)),
    ((32, 32, 32), (1.0, 1.0, 1.0)),
])
def test_transport_kernel_cycle_matches_plain(dev, shape, spacing):
    """One K4 launch equals one plain transport cycle bit for bit (the same
    fp32 operations in the same order; bar 1e-5 * max|plain|), and a done
    field passes through untouched."""
    ws, g = _transport_batch(dev, shape, spacing,
                             [[3.0, 4.0, 5.0], [20.0, 10.0, 2.0],
                              [12.0, 18.0, 9.0]])
    done = torch.tensor([False, True, False], device=dev)
    launches = cuda_transport.TRANSPORT3D.launches
    out = cuda_transport.transport_cycle(g, g, ws, 2, done)
    torch.cuda.synchronize()
    assert cuda_transport.TRANSPORT3D.launches == launches + 1
    ref = transport_cycle_plain(g, g, ws, 2, done)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(out[1], g[1])
    assert float((out[0] - g[0]).abs().max()) > 0.0


@pytest.mark.cuda
def test_transport_kernel_solve_matches_plain_solve(dev):
    """A whole transport solve at tol 1e-7 through K4 equals the plain
    solve on the card within 1e-5 * max|plain|."""
    ws, g = _transport_batch(dev, (32, 24, 16), (1.0, 1.0, 1.0),
                             [[2.0, 3.0, 4.0], [30.0, 20.0, 2.0],
                              [15.0, 12.0, 8.0], [31.0, 23.0, 15.0]])
    launches = cuda_transport.TRANSPORT3D.launches
    out = transport_solve(g, ws, 1e-7, 100, 2,
                          cycle=cuda_transport.transport_cycle)
    assert cuda_transport.TRANSPORT3D.launches > launches
    ref = transport_solve(g, ws, 1e-7, 100, 2)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_transport_kernel_wrapper_checks_inputs(dev):
    k = cuda_transport.TRANSPORT3D
    x = torch.zeros((1, 8, 8, 8), device=dev)
    with pytest.raises(ValueError, match="float32"):
        k(x.double(), x, (x, x, x), 2)
    with pytest.raises(ValueError, match="contiguous"):
        k(x, x, (x, x.transpose(1, 2), x), 2)
    with pytest.raises(ValueError, match="shared"):
        big = torch.zeros((1, 8, 120, 120), device=dev)
        k(big, big, (big, big, big), 2)


def _batch2d(dev, B, shape, spacing, seed=6, amp=0.3):
    """B random smooth 2-D fields with sources spread over the grid."""
    gen = torch.Generator().manual_seed(seed)
    g = Grid(shape, spacing)
    u = amp * torch.randn((B, 6, 6), generator=gen)
    s = slowness_from_u(u, g, torch.tensor(1.0)).to(dev)
    ext = torch.tensor(g.extent)
    srcs = ((0.05 + 0.9 * torch.rand((B, 2), generator=gen)) * ext).to(dev)
    T0, frozen = seed_source(s, srcs, g, 3.0)
    return g, s, srcs, T0, seed_floor(T0, frozen)


@pytest.mark.cuda
@pytest.mark.parametrize("B,shape,spacing", [
    (32, (65, 65), (1.0, 1.0)),       # config 1's batch: 4 chains x 8 sources
    (1000, (48, 48), (1.0, 1.0)),     # config 4's field, a slice of its batch
    (7, (37, 23), (1.0, 1.25)),       # odd, non-square, weighted local solve
])
def test_sweep2d_cycle_matches_plain(dev, B, shape, spacing):
    """One K3 launch equals one plain 2-D cycle (the same fp32 operations
    in the same order; bar 1e-4, expected 0), and done fields come back
    untouched."""
    g, s, _, T0, fl = _batch2d(dev, B, shape, spacing)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    done[1::3] = True
    launches = cuda_sweep2d.SWEEP2D.launches
    out = cuda_sweep.sweep_cycle(T0, s, fl, g.spacing, 2, done)
    torch.cuda.synchronize()
    assert cuda_sweep2d.SWEEP2D.launches == launches + 1
    ref = sweep_cycle_plain(T0, s, fl, g.spacing, 2, done)
    assert float((out - ref).abs().max()) <= 1e-4
    assert torch.equal(out[done], T0[done])
    assert float((out[0] - T0[0]).abs().max()) > 1.0
    for n_inner in (1, 3):
        out = cuda_sweep2d.SWEEP2D(T0, s, fl, g.spacing, n_inner)
        ref = sweep_cycle_plain(T0, s, fl, g.spacing, n_inner)
        assert float((out - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_sweep2d_solve_matches_plain_solve(dev):
    """A whole 2-D batched solve at tol 1e-5 through K3 equals the plain
    solve on the card within 1e-4, per-field convergence included."""
    g, s, srcs, _, _ = _batch2d(dev, 9, (41, 29), (1.0, 1.0), amp=0.6)
    launches = cuda_sweep2d.SWEEP2D.launches
    out = solve_eikonal_batched(s, srcs, g, EikonalConfig(tol=1e-5,
                                                          max_iters=100))
    assert cuda_sweep2d.SWEEP2D.launches > launches
    ref = solve_eikonal_batched(s, srcs, g, EikonalConfig(
        tol=1e-5, max_iters=100, use_pallas="off"))
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= 1e-4
    T0, frozen = seed_source(s, srcs, g, 3.0)
    out2 = sweep_solve(T0, seed_floor(T0, frozen), s, g.spacing, 1e-5, 100, 2,
                       cycle=cuda_sweep.sweep_cycle)
    assert torch.equal(out, out2)


@pytest.mark.cuda
def test_sweep2d_wrapper_checks_inputs(dev):
    g, s, _, T0, fl = _batch2d(dev, 2, (16, 12), (1.0, 1.0))
    k = cuda_sweep2d.SWEEP2D
    with pytest.raises(ValueError, match="float32"):
        k(T0.double(), s, fl, g.spacing, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k(T0, s.transpose(1, 2).contiguous().transpose(1, 2), fl, g.spacing, 2)
    with pytest.raises(ValueError, match="shared"):
        big = torch.zeros((1, 200, 120), device=dev)
        k(big, big, big, (1.0, 1.0), 2)
    with pytest.raises(ValueError, match="CUDA"):
        k(T0.cpu(), s.cpu(), fl.cpu(), g.spacing, 2)
    done = torch.ones(2, dtype=torch.bool, device=dev)
    assert torch.equal(k(T0, s, fl, g.spacing, 2, done), T0)
