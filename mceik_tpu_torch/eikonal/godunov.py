"""Vectorized Godunov upwind local solver for the eikonal equation.

Counterpart of ``mceik_tpu/eikonal/godunov.py``, operation for operation,
so that fp32 results agree with the JAX package to rounding. At each node
with per-axis upwind neighbour minima ``a_d`` and weights ``w_d = 1/h_d^2``
the update solves ``sum_d w_d * max(t - a_d, 0)^2 = s^2`` over the sorted
smallest-n subsets, with the cancellation-free discriminant
``(sum w) s^2 - sum_{i<j} w_i w_j (a_i - a_j)^2``.

The CUDA sweep kernel (``csrc/sweep3d.cu``) repeats this arithmetic in the
same order; keep the two in step. :func:`godunov_update` is the Jacobi
solve's pass (``solve.jacobi_step_plain``).
"""

from __future__ import annotations

from typing import Sequence

import torch

# Finite stand-in for +inf: keeps fp32 arithmetic NaN-free (inf - inf) while
# dominating any physical traveltime. BIG^2 = 1e20 is inside fp32 range.
BIG = 1e10

# Discriminant floor: keeps sqrt away from 0 so a gradient through the
# unselected branch can never be inf (0 * inf = NaN).
_DISC_FLOOR = 1e-12


def shift_filled(T: torch.Tensor, axis: int, delta: int,
                 fill: float = BIG) -> torch.Tensor:
    """``result[i] = T[i + delta]`` along ``axis``; out-of-range -> ``fill``.

    ``delta`` must be +1 or -1.
    """
    n = T.shape[axis]
    edge = torch.full_like(T.narrow(axis, 0, 1), fill)
    if delta == 1:
        return torch.cat([T.narrow(axis, 1, n - 1), edge], dim=axis)
    if delta == -1:
        return torch.cat([edge, T.narrow(axis, 0, n - 1)], dim=axis)
    raise ValueError(f"delta must be +-1, got {delta}")


def neighbor_min(T: torch.Tensor, axis: int, fill: float = BIG) -> torch.Tensor:
    """Per-node minimum of the two axis-neighbours (edge -> ``fill``)."""
    return torch.minimum(shift_filled(T, axis, +1, fill),
                         shift_filled(T, axis, -1, fill))


def _sort3(a1, w1, a2, w2, a3, w3):
    """Sort three (a, w) pairs by ``a`` with a 3-element sorting network
    (ties keep their order, as in the JAX package)."""

    def cswap(ax, wx, ay, wy):
        swap = ay < ax
        return (torch.where(swap, ay, ax), torch.where(swap, wy, wx),
                torch.where(swap, ax, ay), torch.where(swap, wx, wy))

    a1, w1, a2, w2 = cswap(a1, w1, a2, w2)
    a2, w2, a3, w3 = cswap(a2, w2, a3, w3)
    a1, w1, a2, w2 = cswap(a1, w1, a2, w2)
    return a1, w1, a2, w2, a3, w3


def _sort3_vals(a1, a2, a3):
    """Sort three tensors elementwise with a 3-element sorting network."""
    lo, hi = torch.minimum(a1, a2), torch.maximum(a1, a2)
    a3, hi = torch.minimum(a3, hi), torch.maximum(a3, hi)
    lo, a3 = torch.minimum(lo, a3), torch.maximum(lo, a3)
    return lo, a3, hi


def _sqrt_rn(x):
    """Correctly rounded fp32 sqrt. Torch's vectorised CPU sqrt is an ulp
    off for ~0.6% of inputs; through float64 the result is the IEEE one
    that XLA and the CUDA kernel's sqrtf give."""
    return torch.sqrt(x.double()).to(x.dtype)


def _sqrt_floored(x):
    return _sqrt_rn(torch.clamp(x, min=_DISC_FLOOR))


def _local_solve_iso(a: Sequence[torch.Tensor], h: float, s: torch.Tensor):
    """Equal-spacing closed forms (no weights, no divisions):

        t1 = a1 + s h
        t2 = (a1 + a2)/2 + sqrt(2 s^2 h^2 - (a1 - a2)^2)/2
        t3 = (a1+a2+a3)/3 + sqrt(3 s^2 h^2 - sum_{i<j}(a_i - a_j)^2)/3
    """
    s2h2 = (s * s) * (h * h)
    if len(a) == 2:
        a1 = torch.minimum(a[0], a[1])
        a2 = torch.maximum(a[0], a[1])
        t1 = a1 + s * h
        d12 = a1 - a2
        t2 = 0.5 * ((a1 + a2) + _sqrt_floored(2.0 * s2h2 - d12 * d12))
        return torch.where(t1 <= a2, t1, t2)

    a1, a2, a3 = _sort3_vals(a[0], a[1], a[2])
    t1 = a1 + s * h
    d12 = a1 - a2
    t2 = 0.5 * ((a1 + a2) + _sqrt_floored(2.0 * s2h2 - d12 * d12))
    d13 = a1 - a3
    d23 = a2 - a3
    t3 = (1.0 / 3.0) * ((a1 + a2 + a3) + _sqrt_floored(
        3.0 * s2h2 - (d12 * d12 + d13 * d13 + d23 * d23)))
    return torch.where(t1 <= a2, t1, torch.where(t2 <= a3, t2, t3))


def local_solve(a: Sequence[torch.Tensor], spacing: Sequence[float],
                s: torch.Tensor) -> torch.Tensor:
    """Solve the Godunov upwind quadratic at every node.

    Args:
      a: per-axis upwind neighbour minima (D tensors of one shape).
      spacing: per-axis grid spacing (floats, length D in {2, 3}).
      s: slowness, same shape.

    Returns the candidate traveltime per node (not yet min'd with T).
    """
    D = len(a)
    if D in (2, 3) and len(set(float(h) for h in spacing)) == 1:
        return _local_solve_iso(a, float(spacing[0]), s)
    w = [1.0 / (h * h) for h in spacing]
    s2 = s * s

    if D == 2:
        a1, a2 = a[0], a[1]
        w1, w2 = torch.full_like(a1, w[0]), torch.full_like(a2, w[1])
        swap = a2 < a1
        a1, a2 = torch.where(swap, a2, a1), torch.where(swap, a1, a2)
        w1, w2 = torch.where(swap, w2, w1), torch.where(swap, w1, w2)

        t1 = a1 + s * _sqrt_rn(1.0 / w1)
        A2 = w1 + w2
        B2 = w1 * a1 + w2 * a2
        d12 = a1 - a2
        disc2 = A2 * s2 - w1 * w2 * (d12 * d12)
        t2 = (B2 + _sqrt_floored(disc2)) / A2
        return torch.where(t1 <= a2, t1, t2)

    if D == 3:
        a1, a2, a3 = a[0], a[1], a[2]
        w1 = torch.full_like(a1, w[0])
        w2 = torch.full_like(a2, w[1])
        w3 = torch.full_like(a3, w[2])
        a1, w1, a2, w2, a3, w3 = _sort3(a1, w1, a2, w2, a3, w3)

        t1 = a1 + s * _sqrt_rn(1.0 / w1)

        A2 = w1 + w2
        B2 = w1 * a1 + w2 * a2
        d12 = a1 - a2
        disc2 = A2 * s2 - w1 * w2 * (d12 * d12)
        t2 = (B2 + _sqrt_floored(disc2)) / A2

        A3 = A2 + w3
        B3 = B2 + w3 * a3
        d13 = a1 - a3
        d23 = a2 - a3
        disc3 = A3 * s2 - (w1 * w2 * (d12 * d12) + w1 * w3 * (d13 * d13)
                           + w2 * w3 * (d23 * d23))
        t3 = (B3 + _sqrt_floored(disc3)) / A3

        return torch.where(t1 <= a2, t1, torch.where(t2 <= a3, t2, t3))

    raise ValueError(f"only 2-D/3-D grids supported, got D={D}")


def godunov_update(T: torch.Tensor, s: torch.Tensor,
                   spacing: Sequence[float]) -> torch.Tensor:
    """One monotone Jacobi pass over a batch ``(B,) + grid``: every node
    from its neighbours, ``T_new = min(T, local_solve(neighbour minima))``.
    Values only decrease, so iterating from BIG with frozen seeds converges
    monotonically to the sweeps' fixed point."""
    a = [neighbor_min(T, d + 1) for d in range(T.ndim - 1)]
    return torch.minimum(T, local_solve(a, spacing, s))
