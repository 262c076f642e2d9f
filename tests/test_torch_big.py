"""The port's routes for big fields (config 5's 128^3) on the CPU.

On the TPU a field above 2 MB (``MAX_VMEM_FIELD_BYTES``) takes the blocked
routes: ``sweep_solve_pallas_blocked`` (axis-0 blocks of the forward sweep,
halo planes, pinned floors) and ``transport_solve_pallas_blocked`` (the
same for the adjoint transport). The port marches whole fields (K1 and the
transport kernel K5 on the card), so its fixed points are the unblocked
ones: here the port's plain solves are held against JAX's blocked solves in
interpret mode with forced multi-block partitioning, at the reference's
own bars. The reference counts one blocked iteration as two whole-field
cycles of work (an ascending and a descending pass over the blocks), and so
does the port on that route: its pair-counted solves are held against the
blocked ones at equal iteration counts, and the route choice by field size
is checked. Then the choice between K4 and K5 by shape, the shared-memory
limits in the kernels' messages, and the launch shape at 128^3, none of
which needs a card. Inputs are made with numpy from seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mceik_tpu.eikonal.adjoint_sweep import transport_weights as j_weights
from mceik_tpu.eikonal.pallas_sweep import sweep_solve_pallas_blocked
from mceik_tpu.eikonal.pallas_transport import transport_solve_pallas_blocked
from mceik_tpu.eikonal.solve import EikonalConfig as JEikonalConfig
from mceik_tpu.eikonal.solve import seed_source as j_seed_source
from mceik_tpu.eikonal.solve import solve_eikonal as j_solve_eikonal
from mceik_tpu.grid import Grid as JGrid

from mceik_tpu_torch.eikonal import cuda_sweep, cuda_transport, solve
from mceik_tpu_torch.eikonal.adjoint_sweep import (transport_cycle_plain,
                                                   transport_solve,
                                                   transport_weights)
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.cuda_build import (MAX_SMEM_BYTES, launch_threads,
                                                plane_limit, plane_smem)
from mceik_tpu_torch.eikonal.solve import (CYCLES_PER_ITER, EikonalConfig,
                                           seed_floor, seed_source,
                                           solve_route, sweep_solve)
from mceik_tpu_torch.forward.predict import traveltime_tables
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


def _smooth_slowness(shape, seed, amp=0.3):
    """A smooth positive field: coarse normals, trilinear-upsampled."""
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.standard_normal((1, 1, 6, 6, 6)).astype(np.float32))
    up = torch.nn.functional.interpolate(u, size=shape, mode="trilinear",
                                         align_corners=False)[0, 0]
    return torch.exp(amp * up).numpy()


def test_plain_solve_matches_jax_blocked_sweep():
    """The port's whole-field solve against JAX's blocked forward route
    (4 axis-0 blocks of (16, 13, 11), halos and pinned floors, interpret
    mode) at the reference's bar for that route, atol 2e-3
    (tests/test_pallas_sweep.py::test_blocked_matches_reference)."""
    shape = (16, 13, 11)
    s = _smooth_slowness(shape, 7)
    src = np.asarray([3.0, 6.0, 5.0], np.float32)
    jgrid = JGrid(shape=shape, spacing=(1.0, 1.0, 1.0))
    T0, frozen = j_seed_source(jnp.asarray(s), jnp.asarray(src), jgrid, 3.0)
    T_blk = np.asarray(sweep_solve_pallas_blocked(
        T0, frozen, jnp.asarray(s), jgrid.spacing, tol=1e-6, max_cycles=100,
        interpret=True, n_blocks=4))
    T = solve_eikonal_batched(torch.from_numpy(s)[None], torch.from_numpy(src)[None],
                              Grid(shape, (1.0, 1.0, 1.0)),
                              EikonalConfig(tol=1e-6, max_iters=100))
    np.testing.assert_allclose(T[0].numpy(), T_blk, atol=2e-3)


def test_plain_transport_matches_jax_blocked_transport():
    """The port's whole-field transport solve against JAX's blocked route
    (4 axis-0 blocks of (12, 10, 8), halo planes injected and pinned,
    interpret mode) on the same weights and cotangent, at the reference's
    bar atol 1e-5 (tests/test_adjoint_sweep.py::
    test_blocked_transport_matches_pure)."""
    shape = (12, 10, 8)
    rng = np.random.default_rng(2)
    s = (1.0 + 0.3 * rng.uniform(size=shape)).astype(np.float32)
    src = jnp.asarray([3.0, 5.0, 4.0], jnp.float32)
    jgrid = JGrid(shape=shape, spacing=(1.0, 1.0, 1.0))
    T = j_solve_eikonal(jnp.asarray(s), src, jgrid,
                        JEikonalConfig(method="sweep", tol=1e-6, max_iters=100))
    _, frozen = j_seed_source(jnp.asarray(s), src, jgrid, 3.0)
    ws = j_weights(T, jnp.asarray(s), frozen, jgrid.spacing)
    g = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    lam_blk = np.asarray(transport_solve_pallas_blocked(
        jnp.asarray(g), ws, tol=1e-7, max_cycles=60, interpret=True,
        n_blocks=4))
    lam = transport_solve(torch.from_numpy(g)[None],
                          [torch.from_numpy(np.array(w))[None] for w in ws],
                          tol=1e-7, max_cycles=60, n_inner=2)
    assert np.isfinite(lam_blk).all()
    np.testing.assert_allclose(lam[0].numpy(), lam_blk, atol=1e-5)


@pytest.fixture(scope="module")
def blocked_runs():
    """The re-anchor's problem on 128x32x32: one source, slowness
    exp(0.2 N(0, 1)) on a 16^3 basis upsampled trilinearly, n_inner 2, tol
    1e-3 (forward) and 1e-7 (transport, on the converged field's weights
    with a random cotangent). For k in {3, 5} iterations: the port's solves
    counting two whole-field cycles per iteration (the blocked route's
    count) and JAX's blocked solves (8 axis-0 blocks, interpret mode); and
    the port's converged fields. The blocked and whole-field fixed points agree to 2e-3
    (forward) and 1e-5 (transport) at the bars of the tests above.

    The port's 3-iteration results are read on the way to 5: the field
    after the sixth cycle of the 5-iteration solve. That is the 3-iteration
    solve's output exactly when the solve did not stop (converged or
    diverged) within 3 iterations, which is asserted: it then ran more than
    six cycles."""
    shape, sp = (128, 32, 32), (1.0, 1.0, 1.0)
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.standard_normal((1, 1, 16, 16, 16))
                         .astype(np.float32))
    s = torch.exp(0.2 * torch.nn.functional.interpolate(
        u, size=shape, mode="trilinear", align_corners=False))[0]
    src = torch.tensor([[20.0, 10.0, 12.0]])
    grid = Grid(shape, sp)
    T0, frozen = seed_source(s, src, grid, 3.0)
    fl = seed_floor(T0, frozen)
    jT0, jfr = j_seed_source(jnp.asarray(s[0].numpy()),
                             jnp.asarray(src[0].numpy()), JGrid(shape, sp), 3.0)
    j_fwd = jax.jit(lambda mc: sweep_solve_pallas_blocked(
        jT0, jfr, jnp.asarray(s[0].numpy()), sp, 1e-3, mc, 2, interpret=True,
        n_blocks=8))
    pairs = CYCLES_PER_ITER["blocked"]

    def pair_counted(solve_fn, cycle, *args):
        """{3: ..., 5: ...}: the 5-iteration solve and its field after
        3 iterations' cycles."""
        seen = []

        def rec(*a):
            seen.append(cycle(*a))
            return seen[-1]

        at5 = solve_fn(*args, 5, cycle=rec, cycles_per_iter=pairs)[0]
        assert len(seen) > 3 * pairs
        return {3: seen[3 * pairs - 1][0], 5: at5}

    out = {"fwd": {}, "tr": {}}
    fwd = pair_counted(lambda *a, **kw: sweep_solve(*a, 2, **kw),
                       solve.sweep_cycle_plain, T0, fl, s, sp, 1e-3)
    for k in (3, 5):
        out["fwd"][k] = (fwd[k], torch.from_numpy(np.asarray(j_fwd(k))))
    # Converged, warm-started from the 5-iteration field.
    T = sweep_solve(out["fwd"][5][0][None], fl, s, sp, 1e-7, 200, 2)
    out["fwd_conv"] = T[0]
    ws = transport_weights(T, s, frozen, sp)
    g = torch.from_numpy((0.1 * rng.standard_normal((1,) + shape))
                         .astype(np.float32))
    j_tr = jax.jit(lambda mc: transport_solve_pallas_blocked(
        jnp.asarray(g[0].numpy()), tuple(jnp.asarray(w[0].numpy()) for w in ws),
        1e-7, mc, 2, interpret=True, n_blocks=8))
    tr = pair_counted(transport_solve, transport_cycle_plain, g, ws, 1e-7)
    for k in (3, 5):
        out["tr"][k] = (tr[k], torch.from_numpy(np.asarray(j_tr(k))))
    out["tr_conv"] = transport_solve(g, ws, 1e-7, 200)[0]
    return out


@pytest.mark.parametrize("leg", ["fwd", "tr"])
@pytest.mark.parametrize("k", [3, 5])
def test_pair_counted_solves_no_further_than_jax_blocked(blocked_runs, leg, k):
    """At equal iteration counts k, the port's pair-counted solve (forward
    sweep, or adjoint transport) is no further from the converged field
    than JAX's blocked route. Measured on this problem: forward 0.052
    against the reference's 0.309 at k 3 and 2.3e-5 against 5.8e-3 at k 5
    (counting one cycle per iteration, as the port did before: 1.63 and
    0.185); transport 0.079 against 0.571 and 4.8e-7 against 0.0177 (one
    cycle: 2.63 and 0.611)."""
    pair, ref = blocked_runs[leg][k]
    conv = blocked_runs[leg + "_conv"]
    err = lambda x: float((x - conv).abs().max())
    assert err(pair) <= err(ref)


@pytest.mark.parametrize("shape,use_pallas,device,route", [
    ((128, 128, 128), "on", "cpu", "blocked"),    # config 5: 8 MB
    ((128, 128, 128), "auto", "cuda", "blocked"),
    ((128, 128, 128), "auto", "cpu", "xla"),
    ((128, 64, 64), "on", "cuda", "field"),        # exactly 2 MiB
    ((129, 64, 64), "on", "cuda", "blocked"),
    ((64, 64, 64), "auto", "cuda", "field"),       # config 2
    ((65, 65), "auto", "cuda", "field"),           # config 1
    ((64, 64, 64), "off", "cuda", "xla"),
])
def test_route_choice_by_field_size(shape, use_pallas, device, route):
    """The reference's choice (forward/predict.py:37-76): with the kernels
    on, "field" up to 2 MiB of fp32 per field and "blocked" above; "off"
    is "xla"; "auto" is "on" for CUDA and "off" for the CPU. A pure
    function of the shape, no card needed."""
    assert solve_route(shape, use_pallas, torch.device(device)) == route
    assert CYCLES_PER_ITER[route] == (2 if route == "blocked" else 1)


def test_blocked_route_counts_two_cycles_per_iteration(monkeypatch):
    """Through the entry points a user calls, on a field made "large" by
    lowering the limit: ``traveltime_tables`` (differentiable) picks the
    blocked route with the kernels on, and its forward solve and its
    transport solve each run two cycles per counted iteration, with the
    done flags taken before the pair; the result equals the whole-field
    route's at twice the iterations."""
    shape = (10, 9, 8)
    monkeypatch.setattr(solve, "MAX_FIELD_BYTES", 4 * int(np.prod(shape)) - 4)
    grid = Grid(shape, (1.0, 1.0, 1.0))
    assert solve_route(shape, "on", "cpu") == "blocked"
    fwd, tr = [], []
    seeded_cycle, transport_cycle = (cuda_sweep.seeded_cycle,
                                     cuda_transport.transport_cycle)

    def rec_sweep(T, s_, scal, sp, n, done, *, seed_radius):
        fwd.append(done.clone())
        return seeded_cycle(T, s_, scal, sp, n, done, seed_radius=seed_radius)

    def rec_transport(lam, g, ws, n, done):
        tr.append(done.clone())
        return transport_cycle(lam, g, ws, n, done)

    monkeypatch.setattr(cuda_sweep, "seeded_cycle", rec_sweep)
    monkeypatch.setattr(cuda_transport, "transport_cycle", rec_transport)
    s = torch.from_numpy(_smooth_slowness(shape, 5)).requires_grad_(True)
    srcs = torch.tensor([[2.0, 3.0, 4.0], [7.0, 1.0, 6.0]])
    cfg = EikonalConfig(tol=0.0, max_iters=2, use_pallas="on")
    T = traveltime_tables(s, srcs, grid, cfg, differentiable=True)
    T.sum().backward()
    assert len(fwd) == 4 and len(tr) == 4
    for flags in (fwd, tr):
        assert all(torch.equal(flags[2 * i], flags[2 * i + 1])
                   for i in range(2))
    whole = solve_eikonal_batched(s.detach(), srcs, grid, EikonalConfig(
        tol=0.0, max_iters=4, use_pallas="off"))
    assert torch.equal(T.detach(), whole)


@pytest.mark.parametrize("grid,kernel", [
    ((64, 64, 64), "TRANSPORT3D"),            # config 2
    ((48, 48, 32), "TRANSPORT3D"),            # config 3
    ((64, 64, 8), "TRANSPORT3D"),             # K4's largest square plane
    ((65, 65, 8), "TRANSPORT3D_LARGE"),
    ((128, 128, 128), "TRANSPORT3D_LARGE"),   # config 5
    ((8, 137, 137), "TRANSPORT3D_LARGE"),     # K5's largest square plane
])
def test_transport_kernel_choice_by_shape(grid, kernel):
    """K4 where its registers (4 nodes per thread, so 4096 per plane) and
    four haloed shared-memory planes take the grid, else K5 with three; a
    pure function of the shape."""
    assert cuda_transport.transport_kernel_for(grid) is \
        getattr(cuda_transport, kernel)


def test_plane_limits_and_128_cube_launch():
    """The limits the messages state (K1: two planes up to 4096 nodes, three
    above, so 19,370 nodes, 139^2; K5's three haloed planes: 137^2; K4's
    eleven haloed planes and 4096 nodes: 64^2), a grid no kernel takes, and
    config 5's launch: one CTA of 1024 threads per 128^3 field, 192 KB of
    shared memory for K1 and 198 KB for K5 (K4 would need 726 KB and holds
    4096 nodes); config 2's 64^3 takes K1 in 132 KB."""
    assert plane_limit(3, 20480).startswith(
        "3 fp32 planes with a one-node halo and at most 20480 nodes per "
        "plane (20 per thread) take square cross-sections up to 137^2 but "
        "not 138^2")
    assert cuda_sweep.sweep3d_limit().startswith(
        "K1 holds 2 fp32 planes up to 4096 nodes per plane and 3 above, so "
        "cross-sections of at most 19370 nodes (139^2 but not 140^2)")
    assert "up to 64^2 but not 65^2" in plane_limit(11, 4096)
    c5 = (128, 128, 128)
    assert cuda_sweep.sweep3d_smem(c5) == 196608 <= MAX_SMEM_BYTES
    # Below 11,264 nodes per plane the 32 warps' transposition tiles
    # (132 KB) outweigh the planes; tiny grids launch fewer warps.
    assert cuda_sweep.sweep3d_smem((64, 64, 64)) == 135168
    assert cuda_sweep.sweep3d_smem((8, 8, 8)) == 2 * 32 * 33 * 4
    assert cuda_sweep.sweep3d_smem((8, 107, 107)) == 3 * 4 * 107 * 107
    assert cuda_sweep.sweep3d_smem((8, 139, 139)) <= MAX_SMEM_BYTES
    assert plane_smem(3)(c5) == 202800 <= MAX_SMEM_BYTES
    assert plane_smem(11)(c5) == 743600 > MAX_SMEM_BYTES
    assert launch_threads((96,) + c5) == 1024
    with pytest.raises(ValueError, match="137\\^2 but not 138\\^2"):
        cuda_transport.transport_kernel_for((138, 138, 8))
    # The wrappers check shared memory and the plane's nodes before the
    # device, so the message shows on CPU tensors too.
    big = torch.zeros((1, 8, 140, 140))
    with pytest.raises(ValueError, match="K1 holds .*139\\^2 but not 140\\^2"):
        cuda_sweep.SWEEP3D.solve(big, big, torch.zeros((1, 4)),
                                 (1.0, 1.0, 1.0), 2, 1e-3, 10,
                                 seed_radius=3.0)
    with pytest.raises(ValueError, match="137\\^2 but not 138\\^2"):
        cuda_transport.TRANSPORT3D_LARGE(big, big, (big, big, big), 2)
    mid = torch.zeros((1, 8, 120, 120))
    with pytest.raises(ValueError, match="64\\^2 but not 65\\^2"):
        cuda_transport.TRANSPORT3D(mid, mid, (mid, mid, mid), 2)
    # CPU tensors take the plain cycle whatever the shape.
    g = torch.zeros((1, 8, 140, 140))
    out = cuda_transport.transport_cycle(g, g, (g, g, g), 2)
    assert torch.equal(out, g)


@pytest.mark.parametrize("grid,kernel,match", [
    # Shared memory fits K4 (11 x 72^2 floats), its registers do not.
    ((4, 70, 70), "TRANSPORT3D",
     "takes planes of at most 4096 nodes, not 4900"),
    # A one-row plane of 4096 nodes: its halo is too long for K4's planes.
    ((1, 4096, 1), "TRANSPORT3D", "shared"),
    # 143^2 nodes are 20 per thread, but three haloed planes do not fit.
    ((2, 143, 143), "TRANSPORT3D_LARGE", "shared"),
])
def test_transport_wrappers_refuse_before_device(grid, kernel, match):
    """K4 and K5 refuse a plane they cannot hold (nodes per thread, then
    shared memory) before they look at the device, so the message shows on
    CPU tensors; the dispatch sends K4's refusals to K5."""
    x = torch.zeros((1,) + grid)
    k = getattr(cuda_transport, kernel)
    assert not k.fits(grid)
    with pytest.raises(ValueError, match=match):
        k(x, x, (x, x, x), 2)
    if kernel == "TRANSPORT3D":
        assert cuda_transport.transport_kernel_for(grid) is \
            cuda_transport.TRANSPORT3D_LARGE


@pytest.mark.parametrize("grid", [(64, 64, 64), (48, 48, 32), (9, 7, 5),
                                  (8, 128, 128), (7, 9)])
def test_solve_cycle_on_cpu_is_the_plain_cycle(grid):
    """``solve_cycle`` keeps K4's ring only on the card: for CPU tensors of
    any shape (K4's, K5's, 2-D) it is ``transport_cycle``, the plain cycle,
    so a solve through it is the plain solve bit for bit."""
    gen = torch.Generator().manual_seed(21)
    shape = (2,) + grid
    ws = tuple(0.6 * (torch.rand(shape, generator=gen) - 0.5)
               for _ in grid)
    g = 0.1 * torch.randn(shape, generator=gen)
    cycle = cuda_transport.solve_cycle(g, ws)
    assert cycle is cuda_transport.transport_cycle
    if np.prod(grid) <= 4096:
        np.testing.assert_array_equal(
            transport_solve(g, ws, 1e-6, 20, 2, cycle=cycle).numpy(),
            transport_solve(g, ws, 1e-6, 20, 2).numpy())


def test_backward_in_chunks_of_fields_equals_whole_batch(monkeypatch):
    """The backward takes the transport weights and the local map's VJP in
    chunks of fields (what keeps a 128^3 gradient's temporaries to a few
    GB): with chunks of 2 fields, then of 1, the slowness and source
    gradients of a 5-field batch equal the one-chunk ones bit for bit."""
    from mceik_tpu_torch.eikonal import adjoint_sweep
    from mceik_tpu_torch.eikonal.adjoint import solve_eikonal_diff_batched

    shape = (10, 9, 8)
    n = int(np.prod(shape))
    assert adjoint_sweep.field_chunks(5, n) == [slice(0, 5)]
    rng = np.random.default_rng(3)
    s = torch.from_numpy(np.stack([_smooth_slowness(shape, i)
                                   for i in range(5)]))
    srcs = torch.from_numpy(rng.uniform(1.0, 7.0, (5, 3)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((5,) + shape).astype(np.float32))
    grid, cfg = Grid(shape, (1.0, 1.0, 1.0)), EikonalConfig(tol=1e-5,
                                                            max_iters=60)

    def grads():
        s_ = s.clone().requires_grad_(True)
        x_ = srcs.clone().requires_grad_(True)
        T = solve_eikonal_diff_batched(s_, x_, grid, cfg)
        return torch.autograd.grad(T, [s_, x_], ct)

    whole = grads()
    for per_chunk in (2, 1):
        monkeypatch.setattr(adjoint_sweep, "CHUNK_ELEMS", per_chunk * n)
        assert len(adjoint_sweep.field_chunks(5, n)) == -(-5 // per_chunk)
        for a, b in zip(grads(), whole):
            assert torch.equal(a, b)
