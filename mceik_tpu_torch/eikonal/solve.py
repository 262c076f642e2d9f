"""Eikonal solver pieces: solver config, source seeding, the plain
plane-sweep solve and the Jacobi solve.

Counterpart of ``mceik_tpu/eikonal/solve.py``. Everything works on an
explicit batch of fields ``(B,) + grid.shape``. The plain sweep here is the
solve the port runs on CPU tensors, and the reference that the CUDA kernels
(K1 for 3-D batches and K3's cycle for 2-D ones, both with the floor
rebuilt from the source scalars: :func:`sweep_seeded_cycle_plain`; K3's
solve, each field's whole solve in one launch: :func:`sweep_solve` around
it, field by field :func:`sweep_solve_fields_plain`;
``eikonal/cuda_sweep.py``) are held against on the card.

One sweep cycle: for each axis, march the planes low -> high, then
high -> low. A plane update takes ``a_ax = min(T[i-1], T[i+1])`` (``T[i-1]``
already updated in this march, edges read BIG), then ``n_inner`` in-plane
Jacobi steps ``T = max(min(T, local_solve(a)), floor)``. ``floor`` is the
seed value on the frozen seed ball and 0 elsewhere: the monotone update can
only push a seeded node below its seed, and traveltimes are >= 0, so the
max restores frozen nodes exactly as ``where(frozen, T0, T)`` does.

The Jacobi solve (``method="jacobi"``, :func:`jacobi_solve`) updates every
node at once from its neighbours, ``godunov.godunov_update``, and pins the
frozen seed nodes at ``T0``; information moves one node per pass, so it
takes hundreds of passes where the sweeps take a few cycles. It runs under
the same per-field loop, :func:`sweep_solve`, one pass per counted
iteration, and has no kernel: it is plain torch on every device, as it is
XLA's work in the reference.

Routes. The reference picks its solve by field size and by whether its
kernels are on (``mceik_tpu/forward/predict.py:37-76``); :func:`solve_route`
makes the same choice, and :data:`CYCLES_PER_ITER` says how many
whole-field cycles each route's counted iteration runs. On the blocked
route (fields above 2 MB, e.g. 128^3) one reference iteration is an
ascending and then a descending pass over axis-0 blocks, each block a full
cycle: two whole-field cycles of work per iteration, so the port runs two
(pallas_sweep.py:1027-1033, pallas_transport.py:238-244).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch

from mceik_tpu_torch.eikonal.godunov import (BIG, godunov_update,
                                             local_solve, neighbor_min)
from mceik_tpu_torch.grid import Grid, sample_linear


@dataclasses.dataclass(frozen=True)
class EikonalConfig:
    """Solver configuration.

    Attributes:
      method: "sweep" (plane sweeps, the kernels' solve) or "jacobi" (the
        plain Jacobi solve, on every route and device).
      tol: max-abs traveltime change per cycle that counts as converged.
      max_iters: bound on sweep cycles.
      n_inner: in-plane Jacobi micro-iterations per plane update.
      seed_radius: source seed ball radius, in units of max grid spacing.
      use_pallas: "auto" ("on" for CUDA tensors, "off" for CPU tensors),
        "on" (the kernels' routes, :func:`solve_route`), "off" (the plain
        sweep, one cycle per iteration); "interpret" is refused.
    """

    method: str = "sweep"
    tol: float = 1e-4
    max_iters: int = 200
    n_inner: int = 2
    seed_radius: float = 3.0
    use_pallas: str = "auto"


# The reference's whole-field limit (``MAX_VMEM_FIELD_BYTES``,
# pallas_sweep.py:46): larger fields take its blocked route.
MAX_FIELD_BYTES = 2 * 1024 * 1024
# Whole-field cycles per counted iteration of each route.
CYCLES_PER_ITER = {"field": 1, "gridbatch": 1, "blocked": 2, "xla": 1}


def solve_route(shape: Sequence[int], use_pallas: str, device) -> str:
    """The reference's route for fields of ``shape`` on ``device``:
    ``"auto"`` is ``"on"`` for CUDA and ``"off"`` for the CPU; ``"on"``
    takes ``"field"`` up to :data:`MAX_FIELD_BYTES` of fp32 per field and
    ``"blocked"`` above; ``"off"`` takes ``"xla"``, the plain cycle."""
    if use_pallas == "interpret":
        raise ValueError("use_pallas='interpret' is a Pallas mode; the port "
                         "takes 'auto', 'on' or 'off'")
    if use_pallas == "auto":
        use_pallas = "on" if torch.device(device).type == "cuda" else "off"
    if use_pallas == "on":
        return ("field" if 4 * math.prod(shape) <= MAX_FIELD_BYTES
                else "blocked")
    if use_pallas == "off":
        return "xla"
    raise ValueError(f"unknown use_pallas {use_pallas!r}")


def _seed_distance(src_idx: torch.Tensor, shape: Sequence[int],
                   spacing: Sequence[float]) -> torch.Tensor:
    """``sqrt(d2 + 1e-12)`` from each source's fractional index coords
    ``(B, D)`` to every node, ``(B,) + shape``, the squared terms summed in
    the grid's axis order (the order the kernels sum in)."""
    B, D = src_idx.shape
    dist2 = None
    for d in range(D):
        view = [1] * (D + 1)
        view[d + 1] = shape[d]
        idx_d = torch.arange(shape[d], dtype=src_idx.dtype,
                             device=src_idx.device).reshape(view)
        src_d = src_idx[:, d].reshape((B,) + (1,) * D)
        term = ((idx_d - src_d) * spacing[d]) ** 2
        dist2 = term if dist2 is None else dist2 + term
    # Tiny floor: sqrt'(0) = inf would NaN source-position gradients.
    return torch.sqrt(dist2 + 1e-12)


def seed_source(slowness: torch.Tensor, src_xyz: torch.Tensor, grid: Grid,
                seed_radius: float = 3.0):
    """Analytic traveltime seed in a ball around each source.

    Nodes within ``seed_radius * max(h)`` of the source get the locally
    homogeneous solution ``T = s(src) * ||x - x_src||`` and are frozen;
    the rest start at BIG.

    Args:
      slowness: ``(B,) + grid.shape`` fp32.
      src_xyz: ``(B, D)`` physical source coordinates.

    Returns ``(T0, frozen)``, both ``(B,) + grid.shape``.
    """
    B = slowness.shape[0]
    D = grid.ndim
    src_idx, s_src = source_scalars(slowness, src_xyz, grid)
    dist = _seed_distance(src_idx, grid.shape, grid.spacing)
    mask = dist <= seed_radius * max(grid.spacing)
    T0 = torch.where(mask, s_src.reshape((B,) + (1,) * D) * dist,
                     torch.full_like(dist, BIG))
    return T0, mask


def source_scalars(slowness: torch.Tensor, src_xyz: torch.Tensor,
                   grid: Grid):
    """Each source's fractional index coords ``(B, D)`` and the slowness
    there, ``(B, 1)`` (``map_coordinates(order=1)``, as the seed takes
    it)."""
    src_xyz = torch.as_tensor(src_xyz, dtype=slowness.dtype,
                              device=slowness.device)
    src_idx = grid.to_index_coords(src_xyz)
    return src_idx, sample_linear(slowness, src_idx[:, None, :])


def seed_floor(T0: torch.Tensor, frozen: torch.Tensor) -> torch.Tensor:
    """The floor operand: T0 on frozen seed nodes, 0 elsewhere."""
    return torch.where(frozen, T0, torch.zeros_like(T0))


def seeded_floor_plain(scal: torch.Tensor, shape: Sequence[int],
                       spacing: Sequence[float],
                       seed_radius: float) -> torch.Tensor:
    """The floor rebuilt from ``(B, 4)`` rows ``(a, b, c, s_src)`` (source
    index coords and slowness, :func:`source_scalars`): ``s_src * dist``
    where ``dist <= seed_radius * max(h)``, else 0. The same operations as
    ``seed_floor(*seed_source(...))``, so the same bits. The plain version
    of the floor the CUDA kernel K1 computes in place of a floor operand."""
    D = len(shape)
    dist = _seed_distance(scal[:, :D], shape, spacing)
    s_src = scal[:, D].reshape((-1,) + (1,) * D)
    return torch.where(dist <= seed_radius * max(spacing), s_src * dist,
                       torch.zeros_like(dist))


def _sweep_one_direction(T, floor, s, spacing: Sequence[float], axis: int,
                         reverse: bool, n_inner: int):
    """One Gauss-Seidel plane march along grid ``axis`` over a batch
    ``(B,) + grid``; returns the new batch."""
    D = T.ndim - 1
    dim = axis + 1
    Tm, sm, fm = (x.movedim(dim, 1) for x in (T, s, floor))
    if reverse:
        Tm, sm, fm = (x.flip(1) for x in (Tm, sm, fm))
    # Spacing with the swept axis first, the plane axes in grid order.
    sp = (spacing[axis],) + tuple(spacing[d] for d in range(D) if d != axis)

    n = Tm.shape[1]
    big_plane = torch.full_like(Tm[:, 0], BIG)
    prev = big_plane
    planes = []
    for i in range(n):
        nxt = Tm[:, i + 1] if i + 1 < n else big_plane
        a_ax = torch.minimum(prev, nxt)
        Tp = Tm[:, i]
        for _ in range(n_inner):
            a = [a_ax] + [neighbor_min(Tp, d) for d in range(1, D)]
            Tp = torch.minimum(Tp, local_solve(a, sp, sm[:, i]))
            Tp = torch.maximum(Tp, fm[:, i])
        planes.append(Tp)
        prev = Tp
    out = torch.stack(planes, dim=1)
    if reverse:
        out = out.flip(1)
    return out.movedim(1, dim)


def on_active_fields(cycle: Callable, done: Optional[torch.Tensor],
                     x: torch.Tensor, *operands):
    """``cycle(x, *operands)`` on the fields whose ``done`` flag is clear;
    done fields of ``x`` come back unchanged. Operands are batches or tuples
    of batches with the leading field axis of ``x``."""
    if done is None or not bool(done.any()):
        return cycle(x, *operands)
    if bool(done.all()):
        return x.clone()
    idx = torch.nonzero(~done).squeeze(1)
    pick = [tuple(t[idx] for t in a) if isinstance(a, tuple) else a[idx]
            for a in operands]
    out = x.clone()
    out[idx] = cycle(x[idx], *pick)
    return out


def sweep_cycle_plain(T, s, floor, spacing: Sequence[float], n_inner: int,
                      done: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One full cycle (both directions along every axis) on the fields whose
    ``done`` flag is clear; done fields come back unchanged. This is the
    plain version of the CUDA kernel ``csrc/sweep2d.cu`` (K3, 2-D batches),
    and of ``csrc/sweep3d.cu`` (K1) through
    :func:`sweep_seeded_cycle_plain`."""

    def cycle(Ta, sa, fa):
        for axis in range(T.ndim - 1):
            for reverse in (False, True):
                Ta = _sweep_one_direction(Ta, fa, sa, spacing, axis, reverse,
                                          n_inner)
        return Ta

    return on_active_fields(cycle, done, T, s, floor)


def sweep_seeded_cycle_plain(T, s, scal, spacing: Sequence[float],
                             n_inner: int, done: Optional[torch.Tensor] = None,
                             *, seed_radius: float) -> torch.Tensor:
    """One cycle with the floor rebuilt from the ``(B, 4)`` source scalars
    (:func:`seeded_floor_plain`), then :func:`sweep_cycle_plain`: the plain
    version of the CUDA kernel K1 (``csrc/sweep3d.cu``)."""
    floor = seeded_floor_plain(scal, T.shape[1:], spacing, seed_radius)
    return sweep_cycle_plain(T, s, floor, spacing, n_inner, done)


CycleFn = Callable[..., torch.Tensor]


def sweep_solve(T0, floor, s, spacing: Sequence[float], tol: float,
                max_cycles: int, n_inner: int,
                cycle: CycleFn = sweep_cycle_plain,
                cycles_per_iter: int = 1, return_cycles: bool = False):
    """Fixed-point iteration of sweep cycles with PER-FIELD convergence.

    One counted iteration runs ``cycles_per_iter`` cycles (2 on the blocked
    route, :data:`CYCLES_PER_ITER`) with the done flags taken before them.
    A field is done once its ``max|T_after - T_before| <= tol`` over the
    iteration (a NaN residual counts as done, as ``not (NaN > tol)``) and
    is not swept again (what ``vmap`` of the reference's ``while_loop``
    gives); the loop ends when every field is done or after ``max_cycles``
    iterations. ``cycle`` is :func:`sweep_cycle_plain` or a CUDA kernel's
    wrapper; each takes ``(T, s, floor, spacing, n_inner, done)``, where
    ``floor`` is a floor field or, for the seeded cycles
    (``cuda_sweep.seeded_cycle``, :func:`sweep_seeded_cycle_plain`), the
    ``(B, D + 1)`` source scalars. One host sync per iteration. Returns
    the batch, and with ``return_cycles`` also each field's cycle count
    (``(B,)`` int32).
    """
    T = T0
    done = torch.zeros(T0.shape[0], dtype=torch.bool, device=T0.device)
    cycles = torch.zeros(T0.shape[0], dtype=torch.int32, device=T0.device)
    for _ in range(max_cycles):
        if return_cycles:
            cycles += (~done).int() * cycles_per_iter
        T_new = T
        for _ in range(cycles_per_iter):
            T_new = cycle(T_new, s, floor, spacing, n_inner, done)
        delta = (T_new - T).abs().flatten(1).amax(dim=1)
        done = done | ~(delta > tol)
        T = T_new
        if bool(done.all()):
            break
    return (T, cycles) if return_cycles else T


def jacobi_step_plain(T, s, floor, spacing: Sequence[float], n_inner: int,
                      done: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Jacobi pass with :func:`sweep_solve`'s cycle signature, on the
    fields whose ``done`` flag is clear (done fields come back unchanged):
    ``godunov_update``, then the frozen nodes pinned at ``T0`` with the
    mask, as the reference's ``where(frozen, T0, T_new)`` does (a NaN
    slowness lands where it lands there). ``floor`` is the pair
    ``(T0, frozen)``; ``n_inner`` is unused, as in the reference."""

    def step(Ta, sa, seed):
        T0, frozen = seed
        return torch.where(frozen, T0, godunov_update(Ta, sa, spacing))

    return on_active_fields(step, done, T, s, tuple(floor))


def jacobi_solve(T0, frozen, s, spacing: Sequence[float], tol: float,
                 max_iters: int, return_cycles: bool = False):
    """The Jacobi solve of a batch from its seed ``(T0, frozen)``
    (reference ``solve._jacobi_solve``): :func:`sweep_solve` around
    :func:`jacobi_step_plain`, one pass per counted iteration, each field
    stopping on its own once a pass changes it by no more than ``tol``."""
    return sweep_solve(T0, (T0, frozen), s, spacing, tol, max_iters, 0,
                       cycle=jacobi_step_plain, return_cycles=return_cycles)


def sweep_solve_fields_plain(T0, s, scal, spacing: Sequence[float],
                             tol: float, max_cycles: int, n_inner: int, *,
                             seed_radius: float):
    """The plain version of the CUDA solve entry of K3
    (``cuda_sweep2d.Sweep2dKernel.solve``): each field on its own, from
    ``T0`` with the floor rebuilt from its source scalars, one plain cycle
    at a time until ``not (max|T_new - T_old| > tol)`` or ``max_cycles``
    cycles. Returns the batch and each field's cycle count (``(B,)``
    int32); both equal :func:`sweep_solve`'s, one cycle per iteration."""
    out = T0.clone()
    cycles = torch.zeros(T0.shape[0], dtype=torch.int32, device=T0.device)
    for b in range(T0.shape[0]):
        T = T0[b:b + 1]
        for c in range(max_cycles):
            T_new = sweep_seeded_cycle_plain(T, s[b:b + 1], scal[b:b + 1],
                                             spacing, n_inner,
                                             seed_radius=seed_radius)
            delta = (T_new - T).abs().amax()
            T = T_new
            cycles[b] = c + 1
            if not bool(delta > tol):
                break
        out[b] = T[0]
    return out, cycles
