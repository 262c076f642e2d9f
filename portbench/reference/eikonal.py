"""The plain eikonal solve and its adjoint transport: the benchmark's own copy.

Plain PyTorch on fp32 batches ``(B,) + grid`` (2-D or 3-D), written from the
algorithm of the reference mceik solver and frozen here, so that what the
benchmark holds the program to cannot move with the program. It imports
nothing of the program.

The forward solve (fast sweeping with the Godunov upwind update):

- Seed: around each source, the nodes within ``seed_radius * max(h)`` get
  ``T0 = s(src) * |x - src|`` (the slowness at the source interpolated
  multilinearly) and are frozen; every other node starts at ``BIG``. The
  floor is ``T0`` on the frozen nodes and 0 elsewhere.
- One cycle: for each grid axis in order, march its planes low to high and
  then high to low. A plane visit takes ``a_ax = min(T[i-1], T[i+1])`` along
  the axis (``T[i-1]`` already updated in this march, ``BIG`` past an edge)
  and then ``n_inner`` Jacobi steps inside the plane,
  ``T = max(min(T, local_solve(a)), floor)``, where ``a`` holds ``a_ax`` and
  the in-plane neighbour minima in grid order.
- The solve: each field on its own, one counted iteration at a time, until
  an iteration changes it by no more than ``tol`` (a NaN change counts as
  done) or ``max_iters`` iterations. An iteration is one cycle on fields
  of up to ``WHOLE_FIELD_BYTES`` (2 MiB of fp32) and two above: there the
  reference solver sweeps a field in axis-0 blocks, an ascending and then
  a descending pass of whole-block cycles, two whole-field cycles of work
  per counted iteration. The change is taken over the whole iteration
  (its end against its start), and a field's cycle count is its
  iterations times the cycles in one, as the port's blocked route counts
  them (``CYCLES_PER_ITER["blocked"]`` and ``sweep_solve`` in
  ``eikonal/solve.py``, ``per_iter`` in ``csrc/sweep3d.cu``). The one
  difference: this solve runs two whole-field cycles, not the reference
  solver's block passes, as the port does.
- Equal spacings on every axis, as every configuration of the repo has.

The adjoint (the implicit function theorem at the converged field): with
``F(T, s) = where(frozen, T0(s), local_solve(a(T), s))``, the gradient of a
loss ``L(T)`` is ``(dF/ds)^T lam`` with ``lam = (dF/dT)^T lam + dL/dT``. The
weights ``dF/dT`` are upwind, one per axis (the derivative of the local
solve in its argmin neighbour, signed by the side it lies on), and ``lam``
comes from bidirectional plane Gauss-Seidel sweeps, each field stopping once
a counted iteration changes it by no more than ``tol * (1e-3 + max|g|)``,
or diverging (a change above ten times its first iteration's, or not
finite: then all NaN). Its iterations are counted as the forward solve's:
one cycle each up to ``WHOLE_FIELD_BYTES``, two above (the port's
``adjoint_sweep.transport_solve`` with ``cycles_per_iter``).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

BIG = 1e10
DISC_FLOOR = 1e-12
DIVERGENCE_FACTOR = 10.0
# The largest field whose counted iteration is one cycle (fp32 bytes); the
# reference solver counts two above it.
WHOLE_FIELD_BYTES = 2 * 1024 * 1024


def cycles_per_iter(shape: Sequence[int]) -> int:
    """Whole-field cycles in one counted iteration on fields of ``shape``."""
    return 1 if 4 * math.prod(shape) <= WHOLE_FIELD_BYTES else 2


def _cycles(cycle, x: torch.Tensor, per_iter: int, *args) -> torch.Tensor:
    """``per_iter`` cycles of ``cycle(x, *args)``, one after the other."""
    for _ in range(per_iter):
        x = cycle(x, *args)
    return x


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root (through float64)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _root(x):
    return sqrt_rn(torch.clamp(x, min=DISC_FLOOR))


def local_solve(a: Sequence[torch.Tensor], spacing: Sequence[float],
                s: torch.Tensor) -> torch.Tensor:
    """The Godunov update on a grid of equal spacings ``h``: the largest
    ``t`` with ``sum_d max(t - a_d, 0)^2 = (s h)^2`` over the smallest-k
    subsets of the sorted neighbour minima ``a`` (2 or 3 tensors), with the
    cancellation-free discriminant."""
    D = len(a)
    if D not in (2, 3) or len(set(float(h) for h in spacing)) != 1:
        raise ValueError(f"equal spacings on a 2-D or 3-D grid only, got "
                         f"{tuple(spacing)}")
    h = float(spacing[0])
    s2h2 = (s * s) * (h * h)
    if D == 2:
        a1, a2 = torch.minimum(a[0], a[1]), torch.maximum(a[0], a[1])
    else:
        lo, hi = torch.minimum(a[0], a[1]), torch.maximum(a[0], a[1])
        mid, hi = torch.minimum(a[2], hi), torch.maximum(a[2], hi)
        a1, a2, a3 = torch.minimum(lo, mid), torch.maximum(lo, mid), hi
    d12 = a1 - a2
    t1 = a1 + s * h
    t2 = 0.5 * ((a1 + a2) + _root(2.0 * s2h2 - d12 * d12))
    if D == 2:
        return torch.where(t1 <= a2, t1, t2)
    d13, d23 = a1 - a3, a2 - a3
    t3 = (1.0 / 3.0) * ((a1 + a2 + a3) + _root(
        3.0 * s2h2 - (d12 * d12 + d13 * d13 + d23 * d23)))
    return torch.where(t1 <= a2, t1, torch.where(t2 <= a3, t2, t3))


def shifted(x: torch.Tensor, dim: int, delta: int,
            fill: float) -> torch.Tensor:
    """``out[i] = x[i + delta]`` along ``dim`` (``delta`` = +1 or -1), ``fill``
    past the edge."""
    n = x.shape[dim]
    edge = torch.full_like(x.narrow(dim, 0, 1), fill)
    if delta == 1:
        return torch.cat([x.narrow(dim, 1, n - 1), edge], dim)
    return torch.cat([edge, x.narrow(dim, 0, n - 1)], dim)


def neighbour_min(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The smaller of the two neighbours along ``dim`` (``BIG`` past an
    edge)."""
    return torch.minimum(shifted(x, dim, 1, BIG), shifted(x, dim, -1, BIG))


def interp(fields: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Multilinear interpolation of ``(N,) + grid`` fields at fractional index
    coordinates ``(N, P, D)``, the corner indices clamped to the grid:
    ``(N, P)``."""
    N, P, D = idx.shape
    shape = fields.shape[1:]
    flat = fields.reshape(N, -1)
    base = torch.floor(idx)
    frac = idx - base
    base = base.long()
    out = torch.zeros((N, P), dtype=fields.dtype, device=fields.device)
    for corner in range(1 << D):
        lin = torch.zeros((N, P), dtype=torch.long, device=fields.device)
        w = torch.ones((N, P), dtype=fields.dtype, device=fields.device)
        for d in range(D):
            up = (corner >> (D - 1 - d)) & 1
            i = (base[..., d] + up).clamp(0, shape[d] - 1)
            lin = lin * shape[d] + i
            w = w * (frac[..., d] if up else 1.0 - frac[..., d])
        out = out + w * flat.gather(1, lin)
    return out


def seed(s: torch.Tensor, src_idx: torch.Tensor, spacing: Sequence[float],
         seed_radius: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T0, frozen)`` of a batch ``s`` ``(B,) + grid`` whose sources sit at
    fractional index coordinates ``src_idx`` ``(B, D)``."""
    B, D = src_idx.shape
    shape = s.shape[1:]
    s_src = interp(s, src_idx[:, None, :])[:, 0]
    d2 = torch.zeros_like(s)
    for d in range(D):
        view = [1] * (D + 1)
        view[d + 1] = shape[d]
        ax = torch.arange(shape[d], dtype=s.dtype,
                          device=s.device).reshape(view)
        off = src_idx[:, d].reshape((B,) + (1,) * D)
        d2 = d2 + ((ax - off) * spacing[d]) ** 2
    dist = torch.sqrt(d2 + 1e-12)
    frozen = dist <= seed_radius * max(spacing)
    T0 = torch.where(frozen, s_src.reshape((B,) + (1,) * D) * dist,
                     torch.full_like(dist, BIG))
    return T0, frozen


def sweep_cycle(T: torch.Tensor, s: torch.Tensor, floor: torch.Tensor,
                spacing: Sequence[float], n_inner: int) -> torch.Tensor:
    """One Gauss-Seidel cycle over every field of the batch; returns a new
    batch."""
    D = T.ndim - 1
    T = T.clone()
    for axis in range(D):
        dim = axis + 1
        Tv, sv, fv = (x.movedim(dim, 1) for x in (T, s, floor))
        n = Tv.shape[1]
        big = torch.full_like(Tv[:, 0], BIG)
        for order in (range(n), range(n - 1, -1, -1)):
            step = 1 if order.step == 1 else -1
            for i in order:
                j_prev, j_next = i - step, i + step
                prev = Tv[:, j_prev] if 0 <= j_prev < n else big
                nxt = Tv[:, j_next] if 0 <= j_next < n else big
                a_ax = torch.minimum(prev, nxt)
                Tp, sp_i, fp = Tv[:, i], sv[:, i], fv[:, i]
                for _ in range(n_inner):
                    a = [a_ax] + [neighbour_min(Tp, k)
                                  for k in range(1, D)]
                    Tp = torch.maximum(
                        torch.minimum(Tp, local_solve(a, spacing, sp_i)), fp)
                Tv[:, i] = Tp
    return T


def solve(s: torch.Tensor, src_idx: torch.Tensor, spacing: Sequence[float],
          tol: float, max_iters: int, n_inner: int, seed_radius: float
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The traveltime batch and each field's cycle count ``(B,)``;
    ``max_iters`` counts iterations (:func:`cycles_per_iter` cycles
    each)."""
    T0, frozen = seed(s, src_idx, spacing, seed_radius)
    floor = torch.where(frozen, T0, torch.zeros_like(T0))
    per_iter = cycles_per_iter(s.shape[1:])
    B = s.shape[0]
    T = T0
    done = torch.zeros(B, dtype=torch.bool, device=s.device)
    cycles = torch.zeros(B, dtype=torch.int64, device=s.device)
    view = (B,) + (1,) * (s.ndim - 1)
    for _ in range(max_iters):
        cycles += (~done).long() * per_iter
        T_new = torch.where(done.reshape(view), T,
                            _cycles(sweep_cycle, T, per_iter, s, floor,
                                    spacing, n_inner))
        change = (T_new - T).abs().flatten(1).amax(1)
        done = done | ~(change > tol)
        T = T_new
        if bool(done.all()):
            break
    return T, cycles


def fixed_point_map(T: torch.Tensor, s: torch.Tensor, src_idx: torch.Tensor,
                    spacing: Sequence[float],
                    seed_radius: float) -> torch.Tensor:
    """``F(T, s)``: the frozen seed values, and elsewhere the local solve from
    the neighbour minima of ``T`` (no ``min`` with ``T`` itself, so that
    ``dF/dT`` is strictly upwind)."""
    T0, frozen = seed(s, src_idx, spacing, seed_radius)
    a = [neighbour_min(T, d + 1) for d in range(T.ndim - 1)]
    return torch.where(frozen, T0, local_solve(a, spacing, s))


def transport_weights(T: torch.Tensor, s: torch.Tensor, frozen: torch.Tensor,
                      spacing: Sequence[float]) -> List[torch.Tensor]:
    """Per axis, ``d local_solve / d a_d`` at the converged batch, positive
    where the argmin neighbour is the low one (ties low), negative where it
    is the high one, 0 on frozen nodes."""
    D = T.ndim - 1
    a = [neighbour_min(T, d + 1).requires_grad_(True) for d in range(D)]
    with torch.enable_grad():
        out = local_solve(a, spacing, s.detach())
        grads = torch.autograd.grad(out, a, torch.ones_like(out))
    live = (~frozen).to(T.dtype)
    ws = []
    for d in range(D):
        low = shifted(T, d + 1, -1, BIG) <= shifted(T, d + 1, 1, BIG)
        ws.append(torch.where(low, grads[d], -grads[d]) * live)
    return ws


def _inflow(lam: torch.Tensor, ws: Sequence[torch.Tensor],
            dims: Sequence[int]) -> torch.Tensor:
    """What each node of ``lam`` receives along ``dims``: from ``i + 1`` when
    that node's weight is positive (it reads its low neighbour ``i``), from
    ``i - 1`` when it is negative."""
    acc = torch.zeros_like(lam)
    for w, dim in zip(ws, dims):
        acc = acc + shifted(torch.clamp(w, min=0.0) * lam, dim, 1, 0.0)
        acc = acc + shifted(torch.clamp(-w, min=0.0) * lam, dim, -1, 0.0)
    return acc


def transport_cycle(lam: torch.Tensor, g: torch.Tensor,
                    ws: Sequence[torch.Tensor], n_inner: int) -> torch.Tensor:
    """One Gauss-Seidel cycle of ``lam = W^T lam + g`` over the batch."""
    D = lam.ndim - 1
    lam = lam.clone()
    for axis in range(D):
        dim = axis + 1
        lv, gv = lam.movedim(dim, 1), g.movedim(dim, 1)
        wa = ws[axis].movedim(dim, 1)
        wp = [ws[d].movedim(dim, 1) for d in range(D) if d != axis]
        n = lv.shape[1]

        def visit(i):
            base = gv[:, i].clone()
            if i > 0:
                base = base + (torch.clamp(-wa[:, i - 1], min=0.0)
                               * lv[:, i - 1])
            if i + 1 < n:
                base = base + torch.clamp(wa[:, i + 1], min=0.0) * lv[:, i + 1]
            lp = lv[:, i]
            w_i = [w[:, i] for w in wp]
            for _ in range(n_inner):
                lp = base + _inflow(lp, w_i, range(1, D))
            lv[:, i] = lp

        for i in range(n):
            visit(i)
        for i in range(n - 1, -1, -1):
            visit(i)
    return lam


def transport_solve(g: torch.Tensor, ws: Sequence[torch.Tensor], tol: float,
                    max_iters: int, n_inner: int) -> torch.Tensor:
    """``lam`` for every field of ``g``, each on its own; a diverged field is
    all NaN. ``max_iters`` counts iterations, as :func:`solve`'s."""
    B = g.shape[0]
    view = (B,) + (1,) * (g.ndim - 1)
    per_iter = cycles_per_iter(g.shape[1:])
    tol_f = tol * (1e-3 + g.abs().flatten(1).amax(1))
    lam = g
    done = torch.zeros(B, dtype=torch.bool, device=g.device)
    bad = torch.zeros_like(done)
    first = None
    for _ in range(max_iters):
        new = torch.where(done.reshape(view), lam,
                          _cycles(transport_cycle, lam, per_iter, g, ws,
                                  n_inner))
        change = (new - lam).abs().flatten(1).amax(1)
        first = change if first is None else first
        live = ~done
        diverged = live & (~torch.isfinite(change)
                           | (change > DIVERGENCE_FACTOR * first))
        bad = bad | diverged
        done = done | diverged | (live & ~(change > tol_f))
        lam = new
        if bool(done.all()):
            break
    return torch.where(bad.reshape(view), torch.full_like(lam, float("nan")),
                       lam)
