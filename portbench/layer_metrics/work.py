"""The work of the eikonal solve and of its adjoint transport, counted from the
plain cycle in ``portbench/reference/eikonal.py``: the same count whatever
kernel, launch pattern or number of launches implements it.

What counts as one operation: an add, subtract, multiply, minimum, maximum,
compare, select, clamp or square root on one fp32 value. Moving a value (a
shift, a transpose, a gather of a plane) is not an operation. A value that
depends on the node alone (``s h``, ``s^2 h^2`` and its multiples, the floor,
the positive and negative parts of a transport weight) is made once per solve
and counted there; a subexpression that two branches share (``a1 + a2``,
``d12^2``) once.

The sweep, per node and plane visit: ``a_ax = min(T[i-1], T[i+1])`` (1); then
per Jacobi step, on a 3-D grid: the two in-plane neighbour minima (2); the
sort of three values (6); ``d12, d13, d23`` (3); ``t1 = a1 + s h`` (1);
``t2``: ``a1 + a2``, ``d12^2``, the discriminant, its clamp, its square root,
the add and the halving (7); ``t3``: ``+ a3``, ``d13^2``, ``d23^2``, two adds,
the discriminant, clamp, root, add, third (10); the two compares and two
selects between ``t1, t2, t3`` (4); ``min`` with T and ``max`` with the floor
(2): 35. On a 2-D grid: one in-plane minimum (1), the sort of two (2),
``d12`` (1), ``t1`` (1), ``t2`` (7), one compare and one select (2), ``min``
and ``max`` (2): 16. A cycle visits every node once per axis and direction,
``2 D`` times, and the convergence test reads ``|T_new - T|`` and its maximum
once per cycle (3). Per solve and node: ``s h``, ``s s``, ``s^2 h^2``, ``2 s^2
h^2`` and, in 3-D, ``3 s^2 h^2`` (4 + (D - 2)); the seed: D differences, D
scalings, D squares, D - 1 adds, the ``+ 1e-12``, the root, the compare, the
product with the source's slowness and the select of the floor (4 D + 4).

The transport, per node and plane visit: the two axial inflows, a product
and an add each (4); per Jacobi step, per in-plane axis two products and two
adds (4 (D - 1)); per cycle ``2 D`` visits and the convergence test (3); per
solve and node, the weights' positive and negative parts, ``max(w, 0)`` and
``max(-w, 0)`` (3 per axis).

Bytes: a solve reads each field's input once and writes its output once,
whatever a kernel reads again: the sweep reads s and writes T (8 per node)
and reads the source's D index coordinates and its slowness (4 (D + 1) per
field); the transport reads g and the D weights and writes lambda
(4 (D + 2) per node). They are far below the operations' time at every
shape the cells run (a 64^3 field's solve of ~10 cycles: ~1e9 operations
against ~2 MB), so the shares are bounded by the operations.
"""

from __future__ import annotations

from typing import Dict

STEP_OPS = {2: 16, 3: 35}


def sweep_cycle_ops(ndim: int, n_inner: int) -> int:
    """Operations per node of one sweep cycle."""
    return 2 * ndim * (1 + n_inner * STEP_OPS[ndim]) + 3


def sweep_solve_ops(ndim: int) -> int:
    """Operations per node made once per field solve (constants, seed)."""
    return (4 + (ndim - 2)) + (4 * ndim + 4)


def sweep_bytes(ndim: int, nodes: int) -> int:
    """Bytes per field solve."""
    return 8 * nodes + 4 * (ndim + 1)


def transport_cycle_ops(ndim: int, n_inner: int) -> int:
    """Operations per node of one transport cycle."""
    return 2 * ndim * (4 + n_inner * 4 * (ndim - 1)) + 3


def transport_solve_ops(ndim: int) -> int:
    return 3 * ndim


def transport_bytes(ndim: int, nodes: int) -> int:
    return 4 * (ndim + 2) * nodes


def nodes_of(shapes: Dict) -> int:
    n = 1
    for x in shapes["grid"]:
        n *= x
    return n
