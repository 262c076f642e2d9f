"""Regular-grid geometry shared by the solver, forward model and datasets.

Counterpart of ``mceik_tpu/grid.py``: the same frozen dataclass, with host
coordinates in numpy and device coordinates in torch.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Grid:
    """A regular 2-D or 3-D grid.

    Attributes:
      shape:   number of nodes per axis, e.g. ``(nx, ny)`` or ``(nx, ny, nz)``.
      spacing: node spacing per axis (same length as ``shape``), in km.
      origin:  physical coordinate of node ``(0, ..., 0)``.
    """

    shape: Tuple[int, ...]
    spacing: Tuple[float, ...]
    origin: Tuple[float, ...] = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.origin is None:
            object.__setattr__(self, "origin", (0.0,) * len(self.shape))
        if not (len(self.shape) == len(self.spacing) == len(self.origin)):
            raise ValueError(
                f"rank mismatch: shape={self.shape} spacing={self.spacing} "
                f"origin={self.origin}"
            )
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        object.__setattr__(self, "spacing", tuple(float(h) for h in self.spacing))
        object.__setattr__(self, "origin", tuple(float(o) for o in self.origin))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def extent(self) -> Tuple[float, ...]:
        """Physical size per axis (distance from first to last node)."""
        return tuple((n - 1) * h for n, h in zip(self.shape, self.spacing))

    def axes(self):
        """Per-axis physical coordinate vectors (numpy, host-side)."""
        return tuple(
            np.asarray(o + h * np.arange(n))
            for n, h, o in zip(self.shape, self.spacing, self.origin)
        )

    def to_index_coords(self, xyz: torch.Tensor) -> torch.Tensor:
        """Physical coords ``(..., ndim)`` -> fractional index coords."""
        xyz = torch.as_tensor(xyz)
        o = torch.tensor(self.origin, dtype=xyz.dtype, device=xyz.device)
        h = torch.tensor(self.spacing, dtype=xyz.dtype, device=xyz.device)
        return (xyz - o) / h

    def to_physical_coords(self, idx: torch.Tensor) -> torch.Tensor:
        """Fractional index coords ``(..., ndim)`` -> physical coords."""
        idx = torch.as_tensor(idx)
        o = torch.tensor(self.origin, dtype=idx.dtype, device=idx.device)
        h = torch.tensor(self.spacing, dtype=idx.dtype, device=idx.device)
        return o + idx * h

    def node_coords(self) -> np.ndarray:
        """Dense physical coordinates of every node, shape ``shape + (ndim,)``
        (numpy, host-side: dataset generators and tests)."""
        mesh = np.meshgrid(*self.axes(), indexing="ij")
        return np.stack(mesh, axis=-1)


def sample_linear(fields: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Multilinear interpolation of a batch of fields at fractional index
    coords, with indices clamped to the grid: what
    ``map_coordinates(order=1, mode="nearest")`` computes, in its order.

    Args:
      fields: ``(N,) + grid_shape`` (2-D or 3-D grids).
      idx: ``(N, P, D)`` fractional index coords, in grid axis order.

    Returns ``(N, P)``, differentiable in both the fields and the coords.

    Per axis the corners are ``floor(x)`` and ``floor(x) + 1``, clamped to
    the axis, with weights ``1 - f`` and ``f`` for ``f = x - floor(x)``; the
    ``2^D`` corner terms (product of weights times the gathered value) are
    summed in ``itertools.product`` order. Working in index coordinates
    keeps the slopes between nodes exact, which hypocentre gradients are
    (``grid_sample``'s normalised coordinates cost ~2e-5 on values).
    """
    N, P, D = idx.shape
    shape = tuple(fields.shape[1:])
    if len(shape) != D or D not in (2, 3):
        raise ValueError(f"fields {tuple(fields.shape)} vs coords {tuple(idx.shape)}")
    flat = fields.reshape(N, -1)
    lo = torch.floor(idx)
    w_hi = idx - lo
    w_lo = 1.0 - w_hi
    lo_i = lo.to(torch.long)
    strides = [math.prod(shape[d + 1:]) for d in range(D)]
    per_axis = []
    for d in range(D):
        i0 = lo_i[..., d]
        per_axis.append(
            [(i0.clamp(0, shape[d] - 1) * strides[d], w_lo[..., d]),
             ((i0 + 1).clamp(0, shape[d] - 1) * strides[d], w_hi[..., d])])
    out = None
    for corner in itertools.product(*per_axis):
        lin = corner[0][0]
        w = corner[0][1]
        for off, wd in corner[1:]:
            lin = lin + off
            w = w * wd
        term = w * flat.gather(1, lin)
        out = term if out is None else out + term
    return out
