"""Swept adjoint transport for the implicit VJP of the eikonal solve.

Counterpart of ``mceik_tpu/eikonal/adjoint_sweep.py``, on an explicit batch
of fields ``(B,) + grid``. The implicit-function VJP needs ``lam`` solving

    lam = (dF/dT)^T lam + g

with ``F`` the pure local map of ``eikonal/adjoint.py``. ``dF/dT`` is
strictly upwind: node ``i`` reads only its argmin neighbour per axis, with
weight ``w_d[i] = d local_solve / d a_d`` at the converged field. The
weights are taken once by forward-mode AD of the same local solver the
sweep uses, stored signed (``> 0``: the argmin neighbour is the low side
``i - 1``; ``< 0``: the high side), and the linear system is solved by
bidirectional plane Gauss-Seidel sweeps over every axis, which converge in
a few cycles as the forward sweeps do.

The plain cycle here (:func:`transport_cycle_plain`) is the solve the port
runs on CPU tensors and the reference the CUDA kernels K4/K5 (3-D batches,
``eikonal/cuda_transport.py``, ``csrc/transport3d.cu``) and K6 (2-D
batches, ``eikonal/cuda_transport2d.py``, ``csrc/transport2d.cu``) are held
against on the card; they sum in the same order. The reference's ``custom_vmap``
boundary, lane packing and ``lax.map`` chunking are TPU workarounds and
have no counterpart.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from mceik_tpu_torch.eikonal.godunov import local_solve, neighbor_min, shift_filled
from mceik_tpu_torch.eikonal.solve import (CYCLES_PER_ITER, on_active_fields,
                                           seed_source)
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.io.trace import device_tensor, host_bool, span

# A cycle residual above this multiple of the first cycle's marks the
# field diverged (reference: adjoint_sweep.DIVERGENCE_FACTOR).
DIVERGENCE_FACTOR = 10.0
# Field elements per chunk of the backward's elementwise work (64 MB of
# fp32): the weights' JVPs hold ~48 field-sized temporaries per field and
# the local map's VJP ~24, which for a whole batch of 128^3 fields would
# take ~10 GB per chain (config 5); in chunks they take a few GB in all.
CHUNK_ELEMS = 1 << 24


def field_chunks(B: int, field_elems: int):
    """Slices of a batch of ``B`` fields, ``CHUNK_ELEMS // field_elems``
    fields (at least one) each."""
    n = max(1, CHUNK_ELEMS // field_elems)
    return [slice(i, min(i + n, B)) for i in range(0, B, n)]


def transport_weights(T: torch.Tensor, s: torch.Tensor, frozen: torch.Tensor,
                      spacing: Sequence[float]) -> Tuple[torch.Tensor, ...]:
    """Signed upwind weight fields at the converged batch ``T``.

    One ``torch.func.jvp`` of ``local_solve`` per axis gives
    ``|w_d| = d local_solve / d a_d``; the sign says which neighbour is the
    argmin along ``d`` (ties go to the low side, ``<=``). Weights are 0 on
    frozen nodes. All arguments are ``(B,) + grid``; returns one tensor per
    grid axis.
    """
    D = T.ndim - 1
    a = tuple(neighbor_min(T, d + 1) for d in range(D))

    def f(*a_):
        return local_solve(list(a_), spacing, s)

    nonfrozen = (~frozen).to(T.dtype)
    out = []
    for d in range(D):
        tangents = tuple(torch.ones_like(T) if e == d else torch.zeros_like(T)
                         for e in range(D))
        _, w_d = torch.func.jvp(f, a, tangents)
        is_lo = shift_filled(T, d + 1, -1) <= shift_filled(T, d + 1, +1)
        out.append(torch.where(is_lo, w_d, -w_d) * nonfrozen)
    return tuple(out)


def apply_WT(lam: torch.Tensor, wsigned: Sequence[torch.Tensor]) -> torch.Tensor:
    """Jacobi application of ``(dF/dT)^T`` in gather form, on a batch."""
    out = torch.zeros_like(lam)
    for d, ws in enumerate(wsigned):
        send_lo = torch.where(ws > 0, ws, 0.0) * lam     # to j = i - 1
        send_hi = torch.where(ws < 0, -ws, 0.0) * lam    # to j = i + 1
        out = out + shift_filled(send_lo, d + 1, +1, 0.0)
        out = out + shift_filled(send_hi, d + 1, -1, 0.0)
    return out


def _plane_collect_inplane(lam_p, ws_plane):
    """In-plane gather within a batch of planes ``(B, n_p, n_q)``, summed
    lo, hi per plane dim in order (K4 sums in the same order)."""
    acc = None
    for d, ws in enumerate(ws_plane):
        send_lo = torch.where(ws > 0, ws, 0.0) * lam_p
        send_hi = torch.where(ws < 0, -ws, 0.0) * lam_p
        lo = shift_filled(send_lo, d + 1, +1, 0.0)
        acc = lo if acc is None else acc + lo
        acc = acc + shift_filled(send_hi, d + 1, -1, 0.0)
    return acc


def _transport_sweep_axis(lam, g, wsigned, axis: int, n_inner: int):
    """Bidirectional plane Gauss-Seidel sweep along grid ``axis`` over a
    batch ``(B,) + grid``; returns the new batch."""
    D = lam.ndim - 1
    dim = axis + 1
    plane_dims = [d for d in range(D) if d != axis]
    lam_t = lam.movedim(dim, 1).clone()
    g_t = g.movedim(dim, 1)
    w_ax = wsigned[axis].movedim(dim, 1)
    w_pl = [wsigned[p].movedim(dim, 1) for p in plane_dims]
    n = lam_t.shape[1]

    def update(i):
        # Plane i-1 sends iff it chose its HIGH neighbour (w < 0), plane
        # i+1 iff it chose LOW (w > 0); nothing is read past an edge.
        axial = None
        if i > 0:
            axial = torch.where(w_ax[:, i - 1] < 0, -w_ax[:, i - 1], 0.0) \
                * lam_t[:, i - 1]
        if i + 1 < n:
            from_next = torch.where(w_ax[:, i + 1] > 0, w_ax[:, i + 1], 0.0) \
                * lam_t[:, i + 1]
            axial = from_next if axial is None else axial + from_next
        base = g_t[:, i] + (axial if axial is not None else 0.0)
        lam_p = lam_t[:, i]
        ws_plane = [w[:, i] for w in w_pl]
        for _ in range(n_inner):
            lam_p = base + _plane_collect_inplane(lam_p, ws_plane)
        lam_t[:, i] = lam_p

    for i in range(n):
        update(i)
    for i in reversed(range(n)):
        update(i)
    return lam_t.movedim(1, dim)


def transport_cycle_plain(lam, g, wsigned, n_inner: int,
                          done: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One full transport cycle (both directions along every axis) on the
    fields whose ``done`` flag is clear; done fields come back unchanged.
    This is the plain version of the CUDA kernels ``csrc/transport3d.cu``
    (3-D batches) and ``csrc/transport2d.cu`` (2-D batches)."""

    def cycle(la, ga, wa):
        for axis in range(lam.ndim - 1):
            la = _transport_sweep_axis(la, ga, wa, axis, n_inner)
        return la

    return on_active_fields(cycle, done, lam, g, tuple(wsigned))


TransportCycleFn = Callable[..., torch.Tensor]


def transport_solve(g: torch.Tensor, wsigned: Sequence[torch.Tensor],
                    tol: float, max_cycles: int, n_inner: int = 2,
                    cycle: TransportCycleFn = transport_cycle_plain,
                    cycles_per_iter: int = 1, return_cycles: bool = False):
    """Solve ``lam = W^T lam + g`` for every field of the batch ``g`` by
    sweep cycles, each field on its own (what ``vmap`` of the reference's
    ``_flagged_cycle_loop`` gives).

    One counted iteration runs ``cycles_per_iter`` cycles (2 on the blocked
    route, as the reference's block cycle is an ascending and a descending
    pass) with the done flags taken before them; the residual is
    ``max|Delta lam|`` over the iteration. A field stops once its residual
    is ``<= tol * (1e-3 + max|g_field|)``. It is diverged when a residual is
    non-finite or exceeds ``DIVERGENCE_FACTOR`` times its first
    iteration's; it then stops, and it alone comes back filled with NaN, so
    that the NaN reaches the sampler (which rejects) instead of a silently
    wrong gradient. ``cycle`` is :func:`transport_cycle_plain` or a CUDA
    kernel's wrapper; both take ``(lam, g, wsigned, n_inner, done)``. One
    host sync per iteration. Returns lam, and with ``return_cycles`` also
    each field's cycle count (``(B,)`` int32).
    """
    B = g.shape[0]
    dev = g.device
    g_scale = g.abs().flatten(1).amax(1)
    tol_eff = device_tensor(tol, torch.float32, dev) * (1e-3 + g_scale)
    lam = g
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    diverged = torch.zeros(B, dtype=torch.bool, device=dev)
    d0 = torch.zeros(B, dtype=torch.float32, device=dev)
    cycles = torch.zeros(B, dtype=torch.int32, device=dev)
    for it in range(max_cycles):
        if return_cycles:
            cycles += (~done).int() * cycles_per_iter
        lam_new = lam
        for _ in range(cycles_per_iter):
            lam_new = cycle(lam_new, g, wsigned, n_inner, done)
        delta = (lam_new - lam).abs().flatten(1).amax(1)
        if it == 0:
            d0 = delta
        active = ~done
        div = active & (~torch.isfinite(delta) | (delta > DIVERGENCE_FACTOR * d0))
        conv = active & ~(delta > tol_eff)
        diverged = diverged | div
        done = done | div | conv
        lam = lam_new
        if host_bool(done.all()):
            break
    lam = torch.where(diverged.reshape((B,) + (1,) * (g.ndim - 1)),
                      torch.full_like(lam, float("nan")), lam)
    return (lam, cycles) if return_cycles else lam


def transport_solve_fields_plain(g: torch.Tensor,
                                 wsigned: Sequence[torch.Tensor], tol: float,
                                 max_cycles: int, n_inner: int = 2):
    """The plain version of the CUDA solve entry of K6
    (``cuda_transport2d.Transport2dKernel.solve``): each field on its own,
    from ``lam = g``, one plain cycle at a time until its residual is
    ``<= tol * (1e-3 + max|g|)``, it diverges (then all NaN) or
    ``max_cycles`` cycles, as :func:`transport_solve` decides. Returns lam
    and each field's cycle count (``(B,)`` int32); both equal
    :func:`transport_solve`'s, one cycle per iteration."""
    out = g.clone()
    cycles = torch.zeros(g.shape[0], dtype=torch.int32, device=g.device)
    tol32 = device_tensor(tol, torch.float32, g.device)
    for b in range(g.shape[0]):
        g_b = g[b:b + 1]
        w_b = tuple(w[b:b + 1] for w in wsigned)
        tol_eff = tol32 * (1e-3 + g_b.abs().amax())
        lam, d0, diverged = g_b, None, False
        for c in range(max_cycles):
            lam_new = transport_cycle_plain(lam, g_b, w_b, n_inner)
            delta = (lam_new - lam).abs().amax()
            d0 = delta if d0 is None else d0
            lam = lam_new
            cycles[b] = c + 1
            if not host_bool(torch.isfinite(delta)) or host_bool(
                    delta > DIVERGENCE_FACTOR * d0):
                diverged = True
                break
            if not host_bool(delta > tol_eff):
                break
        out[b] = float("nan") if diverged else lam[0]
    return out, cycles


def batch_weights(T: torch.Tensor, s_b: torch.Tensor, srcs: torch.Tensor,
                  grid: Grid, seed_radius: float) -> Tuple[torch.Tensor, ...]:
    """:func:`transport_weights` of a converged batch ``T`` whose frozen
    seed masks are re-derived from the ``(B, D)`` solve origins ``srcs``,
    in chunks of fields (:func:`field_chunks`)."""
    ws = tuple(torch.empty_like(T) for _ in range(grid.ndim))
    for c in field_chunks(T.shape[0], T[0].numel()):
        _, frozen = seed_source(s_b[c], srcs[c], grid, seed_radius)
        for w, w_c in zip(ws, transport_weights(T[c], s_b[c], frozen,
                                                grid.spacing)):
            w[c] = w_c
    return ws


def transport_solve_batched(g: torch.Tensor, T: torch.Tensor, s_b: torch.Tensor,
                            srcs: torch.Tensor, grid: Grid, config,
                            impl: str) -> torch.Tensor:
    """Flat-batch adjoint transport solve used by the implicit VJP.

    ``g``: cotangent fields ``(B,) + grid``; ``T``: the converged
    traveltimes; ``s_b``: per-field slowness; ``srcs``: ``(B, D)`` solve
    origins (:func:`batch_weights`). ``impl`` is the forward solve's route
    (``solve.solve_route``): ``"xla"`` takes the plain cycle under the host
    loop :func:`transport_solve`, every other route ``cuda_transport.solve``
    with the route's cycles per iteration (two on ``"blocked"``): on CUDA
    tensors K6's solve for 2-D fields, one launch for every field's whole
    solve, and the host loop around K4 or K5 for 3-D ones
    (``cuda_transport.solve_cycle``, which keeps K4's ring of g and the
    weights through the solve); on CPU tensors the plain cycle.
    """
    # The kernels' modules import this one for the plain cycle.
    from mceik_tpu_torch.eikonal import cuda_transport

    with span("mceik.adjoint.transport"):
        ws = batch_weights(T, s_b, srcs, grid, config.seed_radius)
        g = g.contiguous()
        if impl == "xla":
            return transport_solve(g, ws, config.tol, config.max_iters,
                                   config.n_inner, cycle=transport_cycle_plain)
        return cuda_transport.solve(g, ws, config.tol, config.max_iters,
                                    config.n_inner,
                                    cycles_per_iter=CYCLES_PER_ITER[impl])
