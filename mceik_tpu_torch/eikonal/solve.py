"""Eikonal solver pieces: solver config, source seeding, and the plain
plane-sweep solve.

Counterpart of ``mceik_tpu/eikonal/solve.py``. Everything works on an
explicit batch of fields ``(B,) + grid.shape``. The plain sweep here is the
solve the port runs on CPU tensors, and the reference that the CUDA kernels
(K1 for 3-D and K3 for 2-D batches, ``eikonal/cuda_sweep.py``) are held
against on the card.

One sweep cycle: for each axis, march the planes low -> high, then
high -> low. A plane update takes ``a_ax = min(T[i-1], T[i+1])`` (``T[i-1]``
already updated in this march, edges read BIG), then ``n_inner`` in-plane
Jacobi steps ``T = max(min(T, local_solve(a)), floor)``. ``floor`` is the
seed value on the frozen seed ball and 0 elsewhere: the monotone update can
only push a seeded node below its seed, and traveltimes are >= 0, so the
max restores frozen nodes exactly as ``where(frozen, T0, T)`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from mceik_tpu_torch.eikonal.godunov import BIG, local_solve, neighbor_min
from mceik_tpu_torch.grid import Grid, sample_linear


@dataclasses.dataclass(frozen=True)
class EikonalConfig:
    """Solver configuration.

    Attributes:
      method: "sweep" (the only method the port runs).
      tol: max-abs traveltime change per cycle that counts as converged.
      max_iters: bound on sweep cycles.
      n_inner: in-plane Jacobi micro-iterations per plane update.
      seed_radius: source seed ball radius, in units of max grid spacing.
      use_pallas: "auto"/"on" (CUDA kernel for CUDA tensors, plain sweep
        for CPU tensors), "off" (plain sweep everywhere); "interpret" is
        refused.
    """

    method: str = "sweep"
    tol: float = 1e-4
    max_iters: int = 200
    n_inner: int = 2
    seed_radius: float = 3.0
    use_pallas: str = "auto"


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
    src_xyz = torch.as_tensor(src_xyz, dtype=slowness.dtype,
                              device=slowness.device)
    src_idx = grid.to_index_coords(src_xyz)  # (B, D)
    h = grid.spacing
    dist2 = None
    for d in range(D):
        shape = [1] * (D + 1)
        shape[d + 1] = grid.shape[d]
        idx_d = torch.arange(grid.shape[d], dtype=slowness.dtype,
                             device=slowness.device).reshape(shape)
        src_d = src_idx[:, d].reshape((B,) + (1,) * D)
        term = ((idx_d - src_d) * h[d]) ** 2
        dist2 = term if dist2 is None else dist2 + term
    # Tiny floor: sqrt'(0) = inf would NaN source-position gradients.
    dist = torch.sqrt(dist2 + 1e-12)
    radius = seed_radius * max(h)

    s_src = sample_linear(slowness, src_idx[:, None, :])  # (B, 1)
    mask = dist <= radius
    T0 = torch.where(mask, s_src.reshape((B,) + (1,) * D) * dist,
                     torch.full_like(dist, BIG))
    return T0, mask


def seed_floor(T0: torch.Tensor, frozen: torch.Tensor) -> torch.Tensor:
    """The floor operand: T0 on frozen seed nodes, 0 elsewhere."""
    return torch.where(frozen, T0, torch.zeros_like(T0))


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
    plain version of the CUDA kernels ``csrc/sweep3d.cu`` (3-D batches) and
    ``csrc/sweep2d.cu`` (2-D batches)."""

    def cycle(Ta, sa, fa):
        for axis in range(T.ndim - 1):
            for reverse in (False, True):
                Ta = _sweep_one_direction(Ta, fa, sa, spacing, axis, reverse,
                                          n_inner)
        return Ta

    return on_active_fields(cycle, done, T, s, floor)


CycleFn = Callable[..., torch.Tensor]


def sweep_solve(T0, floor, s, spacing: Sequence[float], tol: float,
                max_cycles: int, n_inner: int,
                cycle: CycleFn = sweep_cycle_plain) -> torch.Tensor:
    """Fixed-point iteration of sweep cycles with PER-FIELD convergence.

    A field is done once its ``max|T_new - T| <= tol`` and is not swept
    again (what ``vmap`` of the reference's ``while_loop`` gives); the loop
    ends when every field is done or after ``max_cycles``. ``cycle`` is
    :func:`sweep_cycle_plain` or the CUDA kernel's wrapper; both take
    ``(T, s, floor, spacing, n_inner, done)``. One host sync per cycle.
    """
    T = T0
    done = torch.zeros(T0.shape[0], dtype=torch.bool, device=T0.device)
    for _ in range(max_cycles):
        T_new = cycle(T, s, floor, spacing, n_inner, done)
        delta = (T_new - T).abs().flatten(1).amax(dim=1)
        done = done | ~(delta > tol)
        T = T_new
        if bool(done.all()):
            break
    return T
