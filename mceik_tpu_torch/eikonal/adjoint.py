"""Differentiable batched eikonal solve through the implicit-function adjoint.

Counterpart of ``mceik_tpu/eikonal/adjoint.py``. The converged batch
satisfies ``T* = F(T*, s)`` with ``F`` the pure local map below, so the VJP
of the solve with respect to the slowness (and the source positions) is

    lam = (dF/dT)^T lam + g        (linear fixed point, g = dL/dT*)
    dL/ds = (dF/ds)^T lam

``lam`` comes from the swept transport solve (``eikonal/adjoint_sweep.py``:
the kernel K4, K5 or K6 for CUDA tensors, on the forward solve's route), and ``(dF/ds)^T lam`` is one autograd VJP
of ``F`` at the converged field. No sweep history is stored: the saved
tensors are ``(s_b, srcs, T*)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from mceik_tpu_torch.eikonal.adjoint_sweep import (field_chunks,
                                                   transport_solve_batched)
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.godunov import local_solve, neighbor_min
from mceik_tpu_torch.eikonal.solve import EikonalConfig, seed_source, solve_route
from mceik_tpu_torch.grid import Grid


def _fixed_point_map(T: torch.Tensor, s_b: torch.Tensor, srcs: torch.Tensor,
                     grid: Grid, config: EikonalConfig) -> torch.Tensor:
    """Stationarity map of a batch, ``where(frozen, T0, local_solve(a))``.

    It is the local solve WITHOUT the forward sweep's monotone
    ``min(T, .)``: both maps share the fixed point, but the monotone form
    sits at a ``min`` tie on every node there, and the tie routes the
    cotangent into the identity branch (about 20% gradient error in the
    reference's measurement). The pure local map never reads a node itself,
    so ``dF/dT`` is strictly upwind and the transport solve is exact.
    """
    T0, frozen = seed_source(s_b, srcs, grid, config.seed_radius)
    a = [neighbor_min(T, d + 1) for d in range(grid.ndim)]
    return torch.where(frozen, T0, local_solve(a, grid.spacing, s_b))


class _SolveDiff(torch.autograd.Function):
    """Forward: the batched solve on route ``impl`` (K1 or K3 on the card),
    or a given converged batch. Backward: lambda from the transport solve on
    the same route (K4, K5 or K6 on the card), then one VJP of the pure
    local map at lambda, in chunks of fields (``adjoint_sweep.field_chunks``);
    a field whose transport solve diverged gets NaN."""

    @staticmethod
    def forward(ctx, s_b, srcs, T_given, grid, config, impl):
        T = (solve_eikonal_batched(s_b, srcs, grid, config, impl)
             if T_given is None else T_given)
        ctx.save_for_backward(s_b, srcs, T)
        ctx.grid, ctx.config, ctx.impl = grid, config, impl
        return T

    @staticmethod
    def backward(ctx, g):
        s_b, srcs, T = ctx.saved_tensors
        grid, config = ctx.grid, ctx.config
        need_srcs = ctx.needs_input_grad[1]
        lam = transport_solve_batched(g, T, s_b, srcs, grid, config, ctx.impl)
        grad_s = torch.empty_like(s_b)
        grad_x = torch.empty_like(srcs) if need_srcs else None
        for c in field_chunks(T.shape[0], T[0].numel()):
            with torch.enable_grad():
                s_ = s_b[c].detach().requires_grad_(True)
                x_ = srcs[c].detach().requires_grad_(need_srcs)
                F = _fixed_point_map(T[c], s_, x_, grid, config)
                grads = torch.autograd.grad(
                    F, [s_, x_] if need_srcs else [s_], lam[c])
            grad_s[c] = grads[0]
            if need_srcs:
                grad_x[c] = grads[1]
        return grad_s, grad_x, None, None, None, None


def solve_eikonal_diff_batched(s_b: torch.Tensor, srcs: torch.Tensor,
                               grid: Grid,
                               config: EikonalConfig = EikonalConfig(),
                               T: Optional[torch.Tensor] = None,
                               impl: Optional[str] = None) -> torch.Tensor:
    """Like ``solve_eikonal_batched`` on a ``(B,) + grid`` slowness batch,
    but differentiable with respect to the slowness and the ``(B, D)``
    sources through the implicit adjoint.

    ``T``: the converged batch for these same inputs, when the caller has
    it; the forward solve is then skipped (the Gauss-Newton Jacobian reuses
    one solve for all its rows this way). ``impl``: the forward solve's
    route (``solve_eikonal_batched``'s), carried to the transport solve so
    that both count iterations alike; by default ``solve.solve_route``'s
    choice.
    """
    s_b = torch.as_tensor(s_b, dtype=torch.float32).contiguous()
    if tuple(s_b.shape) != (srcs.shape[0],) + grid.shape:
        raise ValueError(f"slowness {tuple(s_b.shape)} vs {srcs.shape[0]} "
                         f"sources on grid {grid.shape}")
    if impl is None:
        impl = solve_route(grid.shape, config.use_pallas, s_b.device)
    return _SolveDiff.apply(s_b, srcs, T, grid, config, impl)
