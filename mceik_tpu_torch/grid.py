"""Regular-grid geometry shared by the solver, forward model and datasets.

Counterpart of ``mceik_tpu/grid.py``: the same frozen dataclass, with host
coordinates in numpy and device coordinates in torch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


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

    def node_coords(self) -> np.ndarray:
        """Dense physical coordinates of every node, shape ``shape + (ndim,)``
        (numpy, host-side: dataset generators and tests)."""
        mesh = np.meshgrid(*self.axes(), indexing="ij")
        return np.stack(mesh, axis=-1)


def sample_linear(fields: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Multilinear interpolation of a batch of fields at fractional index
    coords, with coordinates clamped to the grid (the counterpart of
    ``map_coordinates(order=1, mode="nearest")``).

    Args:
      fields: ``(N,) + grid_shape`` (2-D or 3-D grids).
      idx: ``(N, P, D)`` fractional index coords, in grid axis order.

    Returns ``(N, P)``.

    ``grid_sample`` with ``align_corners=True`` maps -1/+1 to the first/last
    node and ``padding_mode="border"`` clamps, which is the "nearest" edge
    mode; it wants the coordinates in reversed axis order (x indexes the
    last dim).
    """
    N, P, D = idx.shape
    shape = fields.shape[1:]
    if len(shape) != D or D not in (2, 3):
        raise ValueError(f"fields {tuple(fields.shape)} vs coords {tuple(idx.shape)}")
    denom = torch.tensor([max(n - 1, 1) for n in shape], dtype=idx.dtype,
                         device=idx.device)
    norm = (2.0 * idx / denom - 1.0).flip(-1)
    grid = norm.reshape((N,) + (1,) * (D - 1) + (P, D))
    out = F.grid_sample(fields.unsqueeze(1), grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.reshape(N, P)
