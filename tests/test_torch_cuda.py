"""Tests of the CUDA kernels (``mceik_tpu_torch/csrc/sweep3d.cu``, K1,
``csrc/transport3d.cu``, K4 and K5, ``csrc/sweep2d.cu``, K3, and
``csrc/transport2d.cu``, K6) against their plain PyTorch versions. They need an NVIDIA GPU with nvcc and skip elsewhere. This file imports no JAX, so it runs on a machine without
it; there, skip tests/conftest.py (which configures JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import functools
import math
import types

import numpy as np
import pytest
import torch

from mceik_tpu_torch.eikonal import (cuda_sweep, cuda_sweep2d, cuda_transport,
                                     cuda_transport2d)
from mceik_tpu_torch.eikonal.adjoint_sweep import (
    transport_cycle_plain, transport_solve, transport_solve_fields_plain,
    transport_weights)
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.cuda_build import MAX_SMEM_BYTES, NvccKernel
from mceik_tpu_torch.eikonal.solve import (EikonalConfig, seed_source,
                                           source_scalars,
                                           sweep_seeded_cycle_plain,
                                           sweep_solve,
                                           sweep_solve_fields_plain)
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
    T0, _ = seed_source(s, srcs, g, 3.0)
    return g, s, srcs, T0, torch.cat(source_scalars(s, srcs, g),
                                     dim=1).contiguous()


def _k1_cycle(T0, s, scal, spacing, n_inner, seed_radius=3.0):
    """One K1 cycle: its solve entry cut at one counted iteration of one
    cycle (one per field)."""
    out, cycles = cuda_sweep.SWEEP3D.solve(T0, s, scal, spacing, n_inner,
                                           0.0, 1, seed_radius=seed_radius)
    assert cycles.tolist() == [1] * T0.shape[0]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape,spacing", [
    ((24, 20, 16), (1.0, 1.2, 0.9)),    # weighted local solve, non-cube
    ((32, 32, 32), (1.0, 1.0, 1.0)),    # closed isotropic form
    ((48, 48, 32), (1.0, 1.0, 1.0)),    # config 3: 3 and 2 nodes per thread
    ((33, 31, 17), (1.0, 1.0, 1.1)),    # planes of 1023, 561, 527 nodes
    ((33, 32, 17), (1.0, 1.0, 1.0)),    # a 1056-node plane: 2 slots, 1 partial
    ((40, 70, 64), (1.0, 1.0, 1.0)),    # 4480-node plane: s staged, 5 slots
])
def test_kernel_cycle_matches_plain(dev, shape, spacing):
    """One launch cut at one cycle equals one plain seeded cycle bit for bit
    (the same fp32 operations in the same order), for n_inner 2 and 1."""
    g, s, _, T0, scal = _batch(dev, shape, spacing,
                               [[3.0, 4.0, 5.0], [20.0, 10.0, 2.0],
                                [12.5, 17.3, 9.1]])
    launches = cuda_sweep.SWEEP3D.launches
    out = _k1_cycle(T0, s, scal, g.spacing, 2)
    assert cuda_sweep.SWEEP3D.launches == launches + 1
    assert torch.equal(out, sweep_seeded_cycle_plain(
        T0, s, scal, g.spacing, 2, seed_radius=3.0))
    assert float((out[0] - T0[0]).abs().max()) > 1.0
    assert torch.equal(
        _k1_cycle(T0, s, scal, g.spacing, 1, seed_radius=2.0),
        sweep_seeded_cycle_plain(T0, s, scal, g.spacing, 1, seed_radius=2.0))


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
    g, s, _, T0, scal = _batch(dev, (8, 8, 8), (1.0, 1.0, 1.0),
                               [[1.0, 2.0, 3.0]])
    solve = functools.partial(cuda_sweep.SWEEP3D.solve, spacing=g.spacing,
                              n_inner=2, tol=1e-3, seed_radius=3.0)
    with pytest.raises(ValueError, match="float32"):
        solve(T0.double(), s, scal, max_cycles=10)
    with pytest.raises(ValueError, match="contiguous"):
        solve(T0.transpose(1, 2), s, scal, max_cycles=10)
    with pytest.raises(ValueError, match="shared"):
        big = torch.zeros((1, 8, 140, 140), device=dev)
        solve(big, big, scal, max_cycles=10)
    out, cycles = solve(T0, s, scal, max_cycles=0)
    np.testing.assert_array_equal(out.cpu().numpy(), T0.cpu().numpy())
    assert cycles.tolist() == [0]


def _mixed_3d(dev, shape, spacing, n_fields, seed=4):
    """A 3-D batch whose fields converge at different cycles: field 0
    starts at its own fixed point (K1's solve at tol 0), field 1 has a
    NaN in its slowness, the others are strongly contrasted fields with
    sources spread over the grid (corners included)."""
    gen = torch.Generator().manual_seed(seed)
    hi = torch.tensor(shape, dtype=torch.float32) - 1.0
    srcs = (torch.rand((n_fields, 3), generator=gen) * hi).tolist()
    srcs[-1] = [0.0, 0.0, 0.0]
    g, s, srcs, T0, scal = _batch(dev, shape, spacing, srcs, seed=seed,
                                  amp=0.6)
    T0[0] = cuda_sweep.SWEEP3D.solve(T0[:1], s[:1], scal[:1], g.spacing, 2,
                                     0.0, 300, seed_radius=3.0)[0][0]
    s[1, shape[0] // 2, shape[1] // 2, shape[2] // 2] = float("nan")
    scal = torch.cat(source_scalars(s, srcs, g), dim=1).contiguous()
    T0[1] = seed_source(s[1:2], srcs[1:2], g, 3.0)[0][0]
    return g, s, srcs, T0, scal


@pytest.mark.cuda
@pytest.mark.parametrize("shape,spacing,per_iter,tol,max_iters", [
    ((64, 64, 64), (1.0, 1.0, 1.0), 1, 1e-5, 9),    # config 2, cut at 9
    ((48, 48, 32), (1.0, 1.0, 1.0), 1, 1e-4, 40),   # config 3's non-cube
    ((24, 20, 16), (1.0, 1.2, 0.9), 1, 1e-5, 60),   # weighted local solve
    ((8, 80, 80), (1.0, 1.0, 1.0), 2, 1e-6, 4),     # s staged, 2 per iter
    ((33, 31, 17), (1.0, 1.0, 1.1), 2, 1e-3, 0),    # no cycle at all
])
def test_kernel_solve_entry_matches_host_loops(dev, shape, spacing, per_iter,
                                               tol, max_iters):
    """K1's solve entry (each field's whole solve in one launch) equals the
    host loop ``sweep_solve`` around the plain cycle bit for bit, NaN
    included, with the same per-field cycle counts, on
    batches that mix a field done in one iteration, a field with a NaN in s
    (done after one iteration, as not (NaN > tol)) and strongly contrasted
    fields; one launch per solve, and ``field_cycles()`` rises by the sum
    of the counts. ``solve_eikonal_batched`` on the card is one launch
    (the blocked route's two cycles per iteration where ``per_iter`` is
    2)."""
    g, s, srcs, T0, scal = _mixed_3d(dev, shape, spacing, 5)
    k = cuda_sweep.SWEEP3D
    ref, ref_cycles = sweep_solve(
        T0, scal, s, g.spacing, tol, max_iters, 2, return_cycles=True,
        cycle=functools.partial(sweep_seeded_cycle_plain, seed_radius=3.0),
        cycles_per_iter=per_iter)
    launches, c0 = k.launches, k.field_cycles()
    out, cycles = k.solve(T0, s, scal, g.spacing, 2, tol, max_iters,
                          seed_radius=3.0, cycles_per_iter=per_iter)
    assert k.launches == launches + 1
    assert k.field_cycles() - c0 == int(cycles.sum())
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(cycles, ref_cycles)
    counts = cycles.tolist()
    if max_iters == 0:
        assert torch.equal(_bits(out), _bits(T0)) and not any(counts)
        return
    assert counts[0] == per_iter and counts[1] == per_iter
    assert torch.isnan(out[1]).any() and torch.isfinite(out[[0, 2, 3, 4]]).all()
    assert max(counts) > per_iter and all(c % per_iter == 0 for c in counts)
    if shape == (64, 64, 64):
        assert max(counts) == max_iters
    if per_iter == 1:
        fields, field_cycles = sweep_solve_fields_plain(
            T0, s, scal, g.spacing, tol, max_iters, 2, seed_radius=3.0)
        assert torch.equal(_bits(out), _bits(fields))
        assert torch.equal(cycles, field_cycles)
    # Fields 2-4 start from their seeds: the batched solve from scratch.
    launches = k.launches
    T = solve_eikonal_batched(s[2:], srcs[2:], g, EikonalConfig(
        tol=tol, max_iters=max_iters),
        impl="blocked" if per_iter == 2 else "field")
    assert k.launches == launches + 1
    assert torch.equal(_bits(T), _bits(ref[2:]))


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


def _bits(x):
    """The fp32 batch as int32 words: equality then counts NaN payloads and
    signed zeros."""
    return x.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,spacing", [
    ((24, 20, 16), (1.0, 1.2, 0.9)),
    ((32, 32, 32), (1.0, 1.0, 1.0)),
])
def test_transport_kernel_cycle_matches_plain(dev, shape, spacing):
    """One K4 launch equals one plain transport cycle bit for bit (the same
    fp32 operations in the same order), for n_inner 2, 1 and 3, and a done
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
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(out[1], g[1])
    assert float((out[0] - g[0]).abs().max()) > 0.0
    for n_inner in (1, 3):
        assert torch.equal(
            _bits(cuda_transport.transport_cycle(g, g, ws, n_inner)),
            _bits(transport_cycle_plain(g, g, ws, n_inner)))


@pytest.mark.cuda
def test_transport_kernel_solve_matches_plain_solve(dev):
    """A whole transport solve at tol 1e-7 through K4 equals the plain
    solve on the card bit for bit (the same cycles, so the same count),
    with a ring of each cycle's own and with the ring kept through the
    solve (``solve_cycle``, the gradient's path)."""
    ws, g = _transport_batch(dev, (32, 24, 16), (1.0, 1.0, 1.0),
                             [[2.0, 3.0, 4.0], [30.0, 20.0, 2.0],
                              [15.0, 12.0, 8.0], [31.0, 23.0, 15.0]])
    ref = transport_solve(g, ws, 1e-7, 100, 2)
    assert torch.isfinite(ref).all()
    for cycle in (cuda_transport.transport_cycle,
                  cuda_transport.solve_cycle(g, ws)):
        launches = cuda_transport.TRANSPORT3D.launches
        out = transport_solve(g, ws, 1e-7, 100, 2, cycle=cycle)
        assert cuda_transport.TRANSPORT3D.launches > launches
        assert torch.equal(_bits(out), _bits(ref))


def _no_counter(dev):
    """A counter whose pointer is null: the kernel then counts nothing."""
    return types.SimpleNamespace(data_ptr=lambda: None)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["K1", "K4", "K5"])
def test_field_cycles_count_each_field_not_done(dev, monkeypatch, name):
    """Over a batch solve, K1's, K4's or K5's ``field_cycles()`` rises by
    the sum of the solve's per-field cycle counts (K1: in its one launch;
    K4, K5: each launch counts the fields not done, below launches x fields
    where the fields converge apart); with a null counter the kernel counts
    nothing and the outputs are the same bits."""
    srcs = [[2.0, 3.0, 4.0], [30.0, 20.0, 2.0], [15.0, 12.0, 8.0],
            [31.0, 23.0, 15.0]]
    if name == "K1":
        kernel = cuda_sweep.SWEEP3D
        g_, s, _, T0, scal = _batch(dev, (32, 24, 16), (1.0, 1.0, 1.0), srcs,
                                    amp=0.6)
        run = lambda: kernel.solve(T0, s, scal, g_.spacing, 2, 1e-5, 100,
                                   seed_radius=3.0)
    else:
        ws, g = _transport_batch(dev, (32, 24, 16), (1.0, 1.0, 1.0), srcs)
        if name == "K4":
            kernel = cuda_transport.TRANSPORT3D
            cycle = lambda: cuda_transport.solve_cycle(g, ws)
        else:
            kernel = cuda_transport.TRANSPORT3D_LARGE
            cycle = lambda: functools.partial(cuda_transport.transport_cycle,
                                              kernel=kernel)
        run = lambda: transport_solve(g, ws, 1e-7, 100, 2, cycle=cycle(),
                                      return_cycles=True)
    c0, l0 = kernel.field_cycles(), kernel.launches
    out, cycles = run()
    counted, launches = kernel.field_cycles() - c0, kernel.launches - l0
    assert counted == int(cycles.sum())
    assert int(cycles.min()) < int(cycles.max())
    if name == "K1":
        assert launches == 1
    else:
        assert counted < launches * cycles.shape[0]
    monkeypatch.setattr(kernel, "counter", _no_counter)
    c1 = kernel.field_cycles()
    out2, cycles2 = run()
    assert kernel.field_cycles() == c1
    assert torch.equal(cycles2, cycles)
    assert torch.equal(_bits(out2), _bits(out))


def _random_transport(dev, B, shape, seed=12):
    """B fields of random signed weights (|w| < 0.3, a tenth exact zeros
    and a tenth negative zeros, as frozen nodes and ties give) and random
    g, made on the CPU from a seed."""
    gen = torch.Generator().manual_seed(seed)
    ws = []
    for _ in range(3):
        w = 0.6 * (torch.rand((B,) + shape, generator=gen) - 0.5)
        u = torch.rand((B,) + shape, generator=gen)
        w = torch.where(u < 0.1, 0.0, w)
        w = torch.where(u > 0.9, -0.0, w)
        ws.append(w.to(dev))
    g = 0.1 * torch.randn((B,) + shape, generator=gen)
    return tuple(ws), g.to(dev)


# Shapes, each with the kernels that take it: the main paths' planes
# (c2 64^3, c3 48x48x32, c5 128^3), odd sides (not multiples of 32, n2 not
# a multiple of 4 or of the ring's 8-plane chunk), planes of one row and
# one-plane axes, and the largest square plane of each entry.
TRANSPORT_SHAPES = [
    ((64, 64, 64), ("TRANSPORT3D", "TRANSPORT3D_LARGE")),     # config 2
    ((48, 48, 32), ("TRANSPORT3D", "TRANSPORT3D_LARGE")),     # config 3
    ((128, 128, 128), ("TRANSPORT3D_LARGE",)),                # config 5
    ((33, 31, 17), ("TRANSPORT3D", "TRANSPORT3D_LARGE")),
    ((37, 23, 9), ("TRANSPORT3D", "TRANSPORT3D_LARGE")),
    ((7, 1, 45), ("TRANSPORT3D", "TRANSPORT3D_LARGE")),       # n1 = 1
    ((1, 30, 20), ("TRANSPORT3D", "TRANSPORT3D_LARGE")),      # n0 = 1
    ((64, 64, 9), ("TRANSPORT3D", "TRANSPORT3D_LARGE")),      # K4's largest
    ((137, 137, 5), ("TRANSPORT3D_LARGE",)),                  # K5's largest
]


@pytest.mark.cuda
def test_transport_kernel_wrapper_checks_inputs(dev):
    """K4's wrapper refuses an fp64 operand, a non-contiguous weight, a
    plane too large for its shared memory, one of more than 4096 nodes and
    a ring not made for the batch."""
    k = cuda_transport.TRANSPORT3D
    x = torch.zeros((1, 8, 8, 8), device=dev)
    with pytest.raises(ValueError, match="float32"):
        k(x.double(), x, (x, x, x), 2)
    with pytest.raises(ValueError, match="contiguous"):
        k(x, x, (x, x.transpose(1, 2), x), 2)
    with pytest.raises(ValueError, match="shared"):
        big = torch.zeros((1, 8, 120, 120), device=dev)
        k(big, big, (big, big, big), 2)
    with pytest.raises(ValueError, match="at most 4096 nodes, not 4900"):
        wide = torch.zeros((1, 4, 70, 70), device=dev)
        k(wide, wide, (wide, wide, wide), 2)
    with pytest.raises(ValueError, match="solve_ring"):
        k(x, x, (x, x, x), 2, ring=k.solve_ring((2, 8, 8, 8), dev))
    with pytest.raises(ValueError, match="made for"):
        cuda_transport.solve_cycle(x, (x, x, x))(x, x.clone(), (x, x, x), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["TRANSPORT3D", "TRANSPORT3D_LARGE"])
def test_transport_size_rules_match_library(dev, name):
    """The wrapper's copies of K4's and K5's size rules (nodes per thread,
    haloed shared planes), which choose and refuse on the CPU too, agree
    with the library's own on grids each side of every limit."""
    from mceik_tpu_torch.eikonal.cuda_build import (MAX_SMEM_BYTES,
                                                    MAX_THREADS,
                                                    launch_threads,
                                                    max_plane_nodes,
                                                    plane_smem)
    k = getattr(cuda_transport, name)
    npt = k.nodes_per_thread.build()()
    assert k.max_nodes == npt * MAX_THREADS
    for grid in [(64, 64, 64), (48, 48, 32), (128, 128, 128), (33, 31, 17),
                 (64, 64, 9), (65, 65, 8), (4, 70, 70), (137, 137, 5),
                 (138, 138, 5), (143, 143, 2), (1, 4096, 1), (8, 8, 8)]:
        smem = k.smem_bytes.build()(*grid, launch_threads((1,) + grid))
        assert plane_smem(k.n_planes)(grid) <= smem
        assert k.fits(grid) == (smem <= MAX_SMEM_BYTES and
                                max_plane_nodes(grid) <= npt * MAX_THREADS)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64, 64), (48, 48, 32), (33, 31, 17),
                                   (7, 1, 45)])
def test_transport_kept_ring_matches_plain(dev, shape):
    """K4 on a ring kept from cycle to cycle (g and the weights copied into
    a field's ring by its first cycle only) equals the plain cycles bit for
    bit: a first cycle with one field done, whose ring stays unfilled, then
    two with none done."""
    ws, g = _random_transport(dev, 3, shape, seed=13)
    k = cuda_transport.TRANSPORT3D
    ring = k.solve_ring(g.shape, dev)
    done = torch.tensor([False, True, False], device=dev)
    lam_k = k(g, g, ws, 2, done, ring=ring)
    lam_p = transport_cycle_plain(g, g, ws, 2, done)
    assert torch.equal(_bits(lam_k), _bits(lam_p))
    assert ring[1].tolist() == [1, 0, 1]
    for _ in range(2):
        lam_k = k(lam_k, g, ws, 2, ring=ring)
        lam_p = transport_cycle_plain(lam_p, g, ws, 2)
        assert torch.equal(_bits(lam_k), _bits(lam_p))
    assert ring[1].tolist() == [1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernels", TRANSPORT_SHAPES)
def test_transport_kernels_bit_for_bit(dev, shape, kernels):
    """K4 and K5 (each where it takes the shape) equal the plain cycle bit
    for bit on random signed weights with exact and negative zeros: three
    fields, one of them done (untouched), for n_inner 2; and a field whose
    g holds a NaN and an inf comes back poisoned exactly as the plain
    cycle's, the others finite."""
    ws, g = _random_transport(dev, 3, shape)
    done = torch.tensor([False, True, False], device=dev)
    ref = transport_cycle_plain(g, g, ws, 2, done)
    bad = g.clone()
    bad[2, 0, 0, 0] = float("nan")
    bad[2, -1, -1, -1] = float("inf")
    ref_bad = transport_cycle_plain(bad, bad, ws, 2)
    assert torch.isnan(ref_bad[2]).any()
    assert torch.isfinite(ref_bad[:2]).all()
    for name in kernels:
        k = getattr(cuda_transport, name)
        launches = k.launches
        out = cuda_transport.transport_cycle(g, g, ws, 2, done, kernel=k)
        torch.cuda.synchronize()
        assert k.launches == launches + 1
        assert torch.equal(_bits(out), _bits(ref)), name
        assert torch.equal(_bits(out[1]), _bits(g[1])), name
        assert torch.equal(_bits(cuda_transport.transport_cycle(
            bad, bad, ws, 2, kernel=k)), _bits(ref_bad)), name


def _batch2d(dev, B, shape, spacing, seed=6, amp=0.3):
    """B random smooth 2-D fields with sources spread over the grid; returns
    the grid, s, the sources, the seeds T0 and the (B, 3) source scalars."""
    gen = torch.Generator().manual_seed(seed)
    g = Grid(shape, spacing)
    u = amp * torch.randn((B,) + tuple(min(6, n) for n in shape),
                          generator=gen)
    s = slowness_from_u(u, g, torch.tensor(1.0)).to(dev)
    ext = torch.tensor(g.extent)
    srcs = ((0.05 + 0.9 * torch.rand((B, 2), generator=gen)) * ext).to(dev)
    T0, _ = seed_source(s, srcs, g, 3.0)
    return g, s, srcs, T0, torch.cat(source_scalars(s, srcs, g),
                                     dim=1).contiguous()


# (B, grid, spacing): the main paths' batches, odd shapes and each 2-D
# kernel's largest grids.
SHAPES_2D = [
    (32, (65, 65), (1.0, 1.0)),       # config 1's batch: 4 chains x 8 sources
    (1000, (48, 48), (1.0, 1.0)),     # config 4's field, a slice of its batch
    (7, (37, 23), (1.0, 1.25)),       # odd, non-square, weighted local solve
    (5, (1, 97), (1.0, 1.0)),         # one row
    (5, (97, 1), (1.0, 1.0)),         # one column
    (6, (61, 67), (1.0, 1.0)),        # prime sides
]
K3_LARGEST = [(3, (169, 169), (1.0, 1.0)),   # the largest square K3 takes
              (3, (28, 1024), (1.0, 1.0))]   # its longest line, 32 per lane
K6_LARGEST = [(3, (120, 120), (1.0, 1.0)),   # the largest square K6 takes
              (3, (14, 1024), (1.0, 1.0))]   # its longest line


def _k3_routes(shape):
    """K3's routes whose shared memory holds a field of ``shape``."""
    return [r for r in cuda_sweep2d.ROUTES if r == "warp"
            or cuda_sweep2d.block_smem_bytes(shape) <= MAX_SMEM_BYTES]


@pytest.mark.cuda
@pytest.mark.parametrize("B,shape,spacing", SHAPES_2D + K3_LARGEST)
def test_sweep2d_cycle_matches_plain(dev, B, shape, spacing):
    """One launch of K3's cycle equals one plain 2-D cycle bit for bit (the
    same fp32 operations in the same order, torch's NaN-propagating min and
    max), on each route the grid fits, for n_inner 2, 1 and 3, and done
    fields come back untouched."""
    g, s, _, T0, scal = _batch2d(dev, B, shape, spacing)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    done[1::3] = True
    launches = cuda_sweep2d.SWEEP2D.launches
    out = cuda_sweep.seeded_cycle(T0, s, scal, g.spacing, 2, done,
                                  seed_radius=3.0)
    torch.cuda.synchronize()
    assert cuda_sweep2d.SWEEP2D.launches == launches + 1
    ref = sweep_seeded_cycle_plain(T0, s, scal, g.spacing, 2, done,
                                   seed_radius=3.0)
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(_bits(out[done]), _bits(T0[done]))
    assert float((out[0] - T0[0]).abs().max()) > 0.5
    for route in _k3_routes(shape):
        blocks = cuda_sweep2d.SWEEP2D.block_launches
        out = cuda_sweep2d.SWEEP2D.cycle(T0, s, scal, g.spacing, 2, done,
                                         seed_radius=3.0, route=route)
        assert cuda_sweep2d.SWEEP2D.block_launches == blocks + (
            route == "block")
        assert torch.equal(_bits(out), _bits(ref)), route
        for n_inner in (1, 3):
            out = cuda_sweep2d.SWEEP2D.cycle(T0, s, scal, g.spacing, n_inner,
                                             seed_radius=3.0, route=route)
            ref_n = sweep_seeded_cycle_plain(T0, s, scal, g.spacing, n_inner,
                                             seed_radius=3.0)
            assert torch.equal(_bits(out), _bits(ref_n)), (route, n_inner)


@pytest.mark.cuda
def test_sweep2d_sqrt_matches_sqrtf(dev):
    """The branch-free square root of the 2-D kernels (``line2d::sqrt_rn``)
    equals sqrtf bit for bit on every float from 1e-12 (the smallest value
    the kernels take a root of) to +inf, and NaN on NaN."""
    import ctypes

    vp, cu = ctypes.c_void_p, ctypes.c_uint32
    k = NvccKernel(cuda_sweep2d.SOURCE, "sweep2d_sqrt_mismatches",
                   [cu, cu, vp, ctypes.c_int, vp])
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    lo = int(np.float32(1e-12).view(np.uint32))
    hi = 0x7fc00001  # up to +inf and the first NaNs
    assert k.build()(lo, hi - lo, bad.data_ptr(), dev.index or 0,
                     torch.cuda.current_stream(dev).cuda_stream) == 0
    assert int(bad.item()) == 0


def _mixed_2d(dev, B, shape, spacing):
    """A batch whose fields converge at different cycles: field 0 starts at
    its own fixed point, field 1 (when B > 2) has a NaN in its slowness."""
    g, s, srcs, T0, scal = _batch2d(dev, B, shape, spacing, amp=0.6)
    T0[0] = solve_eikonal_batched(s[:1], srcs[:1], g, EikonalConfig(
        tol=1e-7, max_iters=300, use_pallas="off"))[0]
    if B > 2:
        s[1, shape[0] // 2, shape[1] // 2] = float("nan")
        scal = torch.cat(source_scalars(s, srcs, g), dim=1).contiguous()
        T0[1] = seed_source(s[1:2], srcs[1:2], g, 3.0)[0][0]
    return g, s, srcs, T0, scal


@pytest.mark.cuda
@pytest.mark.parametrize("B,shape,spacing,tol,max_cycles", [
    (9, (41, 29), (1.0, 1.0), 1e-5, 100),
    (7, (37, 23), (1.0, 1.25), 1e-5, 100),
    (5, (1, 97), (1.0, 1.0), 1e-5, 100),
    (6, (61, 67), (1.0, 1.0), 0.0, 3),       # cut at max_cycles
    (4, (48, 48), (1.0, 1.0), 1e-3, 0),      # no cycle at all
    (3, (169, 169), (1.0, 1.0), 1e-4, 60),
    (3, (28, 1024), (1.0, 1.0), 1e-4, 40),
])
def test_sweep2d_solve_matches_plain_solve(dev, B, shape, spacing, tol,
                                           max_cycles):
    """K3's solve entry (each field's whole solve in one launch) equals the
    host loop around the plain cycle bit for bit, NaN included, with the
    same per-field cycle counts, on batches that mix a field done in one
    cycle, a field with a NaN in s (done after one cycle, as not (NaN >
    tol)) and strongly contrasted fields; and the plain per-field loop on
    the small ones. ``solve_eikonal_batched`` on the card is one K3
    launch."""
    g, s, srcs, T0, scal = _mixed_2d(dev, B, shape, spacing)
    ref, ref_cycles = sweep_solve(
        T0, scal, s, g.spacing, tol, max_cycles, 2, return_cycles=True,
        cycle=lambda *a: sweep_seeded_cycle_plain(*a, seed_radius=3.0))
    for route in _k3_routes(shape):
        launches = cuda_sweep2d.SWEEP2D.launches
        out, cycles = cuda_sweep2d.SWEEP2D.solve(
            T0, s, scal, g.spacing, 2, tol, max_cycles, seed_radius=3.0,
            route=route)
        torch.cuda.synchronize()
        assert cuda_sweep2d.SWEEP2D.launches == launches + 1
        assert torch.equal(_bits(out), _bits(ref)), route
        assert torch.equal(cycles, ref_cycles), route
    if max_cycles == 0:
        assert torch.equal(_bits(out), _bits(T0)) and not cycles.any()
    elif tol > 0 and min(shape) > 1:
        assert int(cycles[0]) == 1 and int(cycles.max()) > 2
    if B > 2 and max_cycles > 0:
        assert torch.isnan(out[1]).any() and int(cycles[1]) == 1
    if math.prod(shape) < 5000:
        fields, field_cycles = sweep_solve_fields_plain(
            T0, s, scal, g.spacing, tol, max_cycles, 2, seed_radius=3.0)
        assert torch.equal(_bits(out), _bits(fields))
        assert torch.equal(cycles, field_cycles)
    launches = cuda_sweep2d.SWEEP2D.launches
    T = solve_eikonal_batched(s, srcs, g, EikonalConfig(
        tol=tol, max_iters=max_cycles))
    assert cuda_sweep2d.SWEEP2D.launches == launches + 1
    T_p = solve_eikonal_batched(s, srcs, g, EikonalConfig(
        tol=tol, max_iters=max_cycles, use_pallas="off"))
    assert torch.equal(_bits(T), _bits(T_p))


@pytest.mark.cuda
def test_sweep2d_wrapper_checks_inputs(dev):
    """On the card, K3's wrapper refuses the wrong dtype, a non-contiguous
    operand, a field beyond one block's shared memory, a line beyond a
    warp, host tensors and a two-cycle iteration; a done field is left as
    it came."""
    g, s, _, T0, scal = _batch2d(dev, 2, (16, 12), (1.0, 1.0))
    k = cuda_sweep2d.SWEEP2D
    with pytest.raises(ValueError, match="float32"):
        k.cycle(T0.double(), s, scal, g.spacing, 2, seed_radius=3.0)
    with pytest.raises(ValueError, match="contiguous"):
        k.cycle(T0, s.transpose(1, 2).contiguous().transpose(1, 2), scal,
                g.spacing, 2, seed_radius=3.0)
    with pytest.raises(ValueError, match="shared"):
        big = torch.zeros((1, 170, 170), device=dev)
        k.cycle(big, big, big[:, 0, :3].contiguous(), (1.0, 1.0), 2,
                seed_radius=3.0)
    with pytest.raises(ValueError, match="1024"):
        long = torch.zeros((1, 2, 1025), device=dev)
        k.cycle(long, long, long[:, 0, :3].contiguous(), (1.0, 1.0), 2,
                seed_radius=3.0)
    with pytest.raises(ValueError, match="CUDA"):
        k.cycle(T0.cpu(), s.cpu(), scal.cpu(), g.spacing, 2, seed_radius=3.0)
    with pytest.raises(ValueError, match="scal"):
        k.cycle(T0, s, scal[:, :2].contiguous(), g.spacing, 2,
                seed_radius=3.0)
    with pytest.raises(ValueError, match="one cycle per counted"):
        k.solve(T0, s, scal, g.spacing, 2, 1e-3, 10, seed_radius=3.0,
                cycles_per_iter=2)
    with pytest.raises(ValueError, match="route"):
        k.cycle(T0, s, scal, g.spacing, 2, seed_radius=3.0, route="lane")
    with pytest.raises(ValueError, match="block route"):
        wide = torch.zeros((1, 28, 1024), device=dev)
        k.cycle(wide, wide, wide[:, 0, :3].contiguous(), (1.0, 1.0), 2,
                seed_radius=3.0, route="block")
    for route in cuda_sweep2d.ROUTES:
        done = torch.ones(2, dtype=torch.bool, device=dev)
        assert torch.equal(k.cycle(T0, s, scal, g.spacing, 2, done,
                                   seed_radius=3.0, route=route), T0)


@pytest.mark.cuda
def test_sweep2d_route_for(dev):
    """K3's wrapper takes the block route for a batch of no more fields
    than the card has SMs whose block fits, else the warp route: config
    1's 32 fields of 65^2 go to the block, config 4's 80,000 of 48^2 and a
    28 x 1024 grid (too large for the block's line buffers) to the warp."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    route_for = cuda_sweep2d.route_for
    assert route_for(32, (65, 65), dev) == "block"
    assert route_for(sms, (48, 48), dev) == "block"
    assert route_for(sms + 1, (48, 48), dev) == "warp"
    assert route_for(80000, (48, 48), dev) == "warp"
    assert route_for(3, (28, 1024), dev) == "warp"
    assert route_for(3, (169, 169), dev) == "block"


# Config 3's batch: 8 chains x 16 surface stations = 128 fields of 48x48x32
# (planes of 1536 and 2304 nodes).
C3_SHAPE = (48, 48, 32)


def _c3_batch(dev, B=128, seed=8):
    gen = torch.Generator().manual_seed(seed)
    g = Grid(C3_SHAPE, (1.0, 1.0, 1.0))
    u = 0.2 * torch.randn((B, 10, 10, 8), generator=gen)
    s = slowness_from_u(u, g, torch.tensor(1.0)).to(dev)
    xy = (0.05 + 0.9 * torch.rand((B, 2), generator=gen)) * 47.0
    srcs = torch.cat([xy, torch.zeros((B, 1))], dim=1).to(dev)
    T0, frozen = seed_source(s, srcs, g, 3.0)
    return g, s, srcs, T0, frozen


@pytest.mark.cuda
def test_kernels_at_config3_batch(dev):
    """K1 and K4 on config 3's 128 x 48x48x32 batch: the wrapper's checks
    pass (132 KB and 108 KB of shared memory, 1024 threads for the 2304-node
    planes); one K1 cycle equals the plain one bit for bit and a solve at
    tol 1e-3 the plain solve (bar 1e-4), one K4 cycle equals the plain one
    bit for bit."""
    from mceik_tpu_torch.eikonal.cuda_build import launch_threads, plane_smem
    assert cuda_sweep.sweep3d_smem(C3_SHAPE) == 135168
    assert plane_smem(11)(C3_SHAPE) == 110000
    assert launch_threads((128,) + C3_SHAPE) == 1024
    g, s, srcs, T0, frozen = _c3_batch(dev)
    scal = torch.cat(source_scalars(s, srcs, g), dim=1).contiguous()
    out = _k1_cycle(T0, s, scal, g.spacing, 2)
    assert torch.equal(out, sweep_seeded_cycle_plain(T0, s, scal, g.spacing,
                                                     2, seed_radius=3.0))
    cfg = EikonalConfig(tol=1e-3, max_iters=20)
    T = solve_eikonal_batched(s, srcs, g, cfg)
    T_p = solve_eikonal_batched(s, srcs, g, EikonalConfig(
        tol=1e-3, max_iters=20, use_pallas="off"))
    assert torch.isfinite(T).all()
    assert float((T - T_p).abs().max()) <= 1e-4
    ws = transport_weights(T, s, frozen, g.spacing)
    gg = 0.1 * torch.randn(T.shape, generator=torch.Generator(
        device=dev).manual_seed(9), device=dev)
    launches = cuda_transport.TRANSPORT3D.launches
    lam = cuda_transport.transport_cycle(gg, gg, ws, 2)
    torch.cuda.synchronize()
    assert cuda_transport.TRANSPORT3D.launches == launches + 1
    lam_p = transport_cycle_plain(gg, gg, ws, 2)
    assert torch.equal(_bits(lam), _bits(lam_p))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,spacing", [
    ((24, 20, 16), (1.0, 1.2, 0.9)),
    ((32, 32, 32), (1.0, 1.0, 1.0)),
])
def test_large_transport_kernel_equals_plain_and_k4(dev, shape, spacing):
    """K5 forced on a shape K4 also takes: one launch equals the plain
    cycle and K4's launch bit for bit (the same fp32 operations in the same
    order), and a done field passes through untouched."""
    ws, g = _transport_batch(dev, shape, spacing,
                             [[3.0, 4.0, 5.0], [20.0, 10.0, 2.0],
                              [12.0, 18.0, 9.0]])
    done = torch.tensor([False, True, False], device=dev)
    k5 = cuda_transport.TRANSPORT3D_LARGE
    launches = k5.launches
    out = cuda_transport.transport_cycle(g, g, ws, 2, done, kernel=k5)
    torch.cuda.synchronize()
    assert k5.launches == launches + 1
    assert torch.equal(_bits(out), _bits(transport_cycle_plain(g, g, ws, 2,
                                                               done)))
    assert torch.equal(_bits(out), _bits(cuda_transport.TRANSPORT3D(
        g, g, ws, 2, done)))
    assert torch.equal(out[1], g[1])


@pytest.mark.cuda
def test_kernels_at_128_cube(dev):
    """Config 5's 128^3 fields: the transport dispatch picks K5 (K4 takes
    planes of at most 4096 nodes), K1 takes them in 192 KB (16 nodes per
    thread, s
    staged); one K1 cycle and one K5 cycle on two fields equal the plain
    cycles bit for bit, and the batched solve, on the blocked route (two
    cycles per counted iteration, one K1 launch), the host loop around the
    plain cycle."""
    shape = (128, 128, 128)
    assert cuda_transport.transport_kernel_for(shape) is \
        cuda_transport.TRANSPORT3D_LARGE
    assert cuda_sweep.sweep3d_smem(shape) == 196608
    g, s, srcs, T0, scal = _batch(dev, shape, (1.0, 1.0, 1.0),
                                  [[10.0, 20.0, 100.0], [64.0, 64.0, 3.0]])
    T1 = _k1_cycle(T0, s, scal, g.spacing, 2)
    assert torch.equal(T1, sweep_seeded_cycle_plain(T0, s, scal, g.spacing,
                                                    2, seed_radius=3.0))
    launches = cuda_sweep.SWEEP3D.launches
    T = solve_eikonal_batched(s, srcs, g, EikonalConfig(tol=1e-3,
                                                        max_iters=20))
    assert cuda_sweep.SWEEP3D.launches == launches + 1
    ref, cycles = sweep_solve(
        T0, scal, s, g.spacing, 1e-3, 20, 2, return_cycles=True,
        cycle=functools.partial(sweep_seeded_cycle_plain, seed_radius=3.0),
        cycles_per_iter=2)
    assert torch.equal(_bits(T), _bits(ref))
    assert int(cycles.min()) > 2
    _, frozen = seed_source(s, srcs, g, 3.0)
    ws = transport_weights(T, s, frozen, g.spacing)
    gg = 0.1 * torch.randn(T.shape, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    launches = cuda_transport.TRANSPORT3D_LARGE.launches
    lam = cuda_transport.transport_cycle(gg, gg, ws, 2)
    torch.cuda.synchronize()
    assert cuda_transport.TRANSPORT3D_LARGE.launches == launches + 1
    assert torch.equal(_bits(lam), _bits(transport_cycle_plain(gg, gg, ws,
                                                               2)))


def _transport_batch2d(dev, B, shape, spacing, seed=7):
    """B converged 2-D fields from K3, their signed weights and random g."""
    g_, s, srcs, _, _ = _batch2d(dev, B, shape, spacing, seed=seed)
    T = solve_eikonal_batched(s, srcs, g_, EikonalConfig(tol=1e-5,
                                                         max_iters=100))
    _, frozen = seed_source(s, srcs, g_, 3.0)
    ws = transport_weights(T, s, frozen, g_.spacing)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return ws, 0.1 * torch.randn(T.shape, generator=gen, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B,shape,spacing", SHAPES_2D + K6_LARGEST)
def test_transport2d_cycle_matches_plain(dev, B, shape, spacing):
    """One launch of K6's cycle equals one plain 2-D transport cycle bit for
    bit (the same fp32 operations in the same order), for n_inner 2, 1 and
    3, and a done field passes through untouched."""
    ws, g = _transport_batch2d(dev, B, shape, spacing)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    done[1] = True
    launches = cuda_transport2d.TRANSPORT2D.launches
    out = cuda_transport.transport_cycle(g, g, ws, 2, done)
    torch.cuda.synchronize()
    assert cuda_transport2d.TRANSPORT2D.launches == launches + 1
    assert torch.equal(_bits(out),
                       _bits(transport_cycle_plain(g, g, ws, 2, done)))
    assert torch.equal(_bits(out[1]), _bits(g[1]))
    assert float((out[0] - g[0]).abs().max()) > 0.0
    for n_inner in (1, 3):
        assert torch.equal(
            _bits(cuda_transport.transport_cycle(g, g, ws, n_inner)),
            _bits(transport_cycle_plain(g, g, ws, n_inner)))


@pytest.mark.cuda
@pytest.mark.parametrize("B,shape,spacing,tol,max_cycles", [
    (4, (48, 48), (1.0, 1.0), 1e-7, 100),
    (7, (37, 23), (1.0, 1.25), 1e-6, 100),
    (5, (97, 1), (1.0, 1.0), 1e-6, 100),
    (6, (61, 67), (1.0, 1.0), 0.0, 3),       # cut at max_cycles
    (3, (65, 65), (1.0, 1.0), 1e-4, 0),      # no cycle at all
    (3, (120, 120), (1.0, 1.0), 1e-6, 60),
    (3, (14, 1024), (1.0, 1.0), 1e-6, 40),
])
def test_transport2d_solve_and_divergence(dev, B, shape, spacing, tol,
                                          max_cycles):
    """K6's solve entry (each field's whole solve in one launch) equals the
    host loop around the plain cycle bit for bit, compared as int32, with
    the same per-field cycle counts, on a batch with a divergent field
    appended (node pairs feeding each other with weight 1.3: all NaN in
    both) and a NaN in one field's g; and the plain per-field loop on the
    small ones. ``cuda_transport.solve`` on the card is one K6 launch."""
    ws, g = _transport_batch2d(dev, B, shape, spacing)
    g = g * (10.0 ** torch.arange(B, device=dev).remainder(3) - 1.0
             ).reshape(B, 1, 1)
    g[-1, shape[0] // 2, shape[1] // 2] = float("nan")
    div = []
    for d in range(2):
        idx = torch.arange(shape[d], device=dev).reshape(
            [-1 if e == d else 1 for e in range(2)])
        div.append(torch.where(idx % 2 == 0, -1.3, 1.3).expand(shape))
    wd = tuple(torch.cat([w, dv[None]]).contiguous()
               for w, dv in zip(ws, div))
    gd = torch.cat([g, torch.ones_like(g[:1])])
    launches = cuda_transport2d.TRANSPORT2D.launches
    out, cycles = cuda_transport2d.TRANSPORT2D.solve(gd, wd, tol, max_cycles,
                                                     2)
    torch.cuda.synchronize()
    assert cuda_transport2d.TRANSPORT2D.launches == launches + 1
    ref, ref_cycles = transport_solve(gd, wd, tol, max_cycles, 2,
                                      return_cycles=True)
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(cycles, ref_cycles)
    if max_cycles >= 40:
        assert torch.isnan(out[-1]).all() and int(cycles[-1]) < max_cycles
    if max_cycles > 0:
        assert torch.isnan(out[-2]).all()
    if math.prod(shape) < 5000:
        fields, field_cycles = transport_solve_fields_plain(gd, wd, tol,
                                                            max_cycles, 2)
        assert torch.equal(_bits(out), _bits(fields))
        assert torch.equal(cycles, field_cycles)
    launches = cuda_transport2d.TRANSPORT2D.launches
    lam = cuda_transport.solve(gd, wd, tol, max_cycles, 2)
    assert cuda_transport2d.TRANSPORT2D.launches == launches + 1
    assert torch.equal(_bits(lam), _bits(ref))


@pytest.mark.cuda
def test_transport2d_wrapper_checks_inputs(dev):
    k = cuda_transport2d.TRANSPORT2D
    x = torch.zeros((2, 16, 16), device=dev)
    with pytest.raises(ValueError, match="float32"):
        k.cycle(x.double(), x, (x, x), 2)
    with pytest.raises(ValueError, match="contiguous"):
        k.cycle(x, x, (x, x.transpose(1, 2)), 2)
    with pytest.raises(ValueError, match="121\\^2"):
        big = torch.zeros((1, 121, 121), device=dev)
        k.cycle(big, big, (big, big), 2)
    with pytest.raises(ValueError, match="1024"):
        long = torch.zeros((1, 2, 1025), device=dev)
        k.solve(long, (long, long), 1e-6, 10)
    with pytest.raises(ValueError, match="one cycle per counted"):
        k.solve(x, (x, x), 1e-6, 10, cycles_per_iter=2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,spacing", [
    ((24, 20, 16), (1.0, 1.2, 0.9)),    # weighted local solve, non-cube
    ((32, 32, 32), (1.0, 1.0, 1.0)),    # closed isotropic form
])
def test_seeded_cycle_matches_k1(dev, shape, spacing):
    """The gridbatch route is the field route: its solve equals the
    ``"field"`` solve bit for bit, both through K1, and the plain solve
    within 1e-4; the wrapper refuses ``scal`` rows of the wrong width."""
    g, s, srcs, T0, scal = _batch(dev, shape, spacing,
                                  [[3.0, 4.0, 5.0], [20.0, 10.0, 2.0],
                                   [12.5, 17.3, 9.1]])
    cfg = EikonalConfig(tol=1e-5, max_iters=100)
    launches = cuda_sweep.SWEEP3D.launches
    T_gb = solve_eikonal_batched(s, srcs, g, cfg, impl="gridbatch")
    assert cuda_sweep.SWEEP3D.launches > launches
    assert torch.equal(T_gb, solve_eikonal_batched(s, srcs, g, cfg,
                                                   impl="field"))
    T_p = solve_eikonal_batched(s, srcs, g, cfg, impl="xla")
    assert float((T_gb - T_p).abs().max()) <= 1e-4
    with pytest.raises(ValueError, match="scal"):
        cuda_sweep.SWEEP3D.solve(T0, s, scal[:, :3].contiguous(), g.spacing,
                                 2, 1e-5, 100, seed_radius=3.0)
