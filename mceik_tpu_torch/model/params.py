"""Parameters and reparameterizations.

Counterpart of ``mceik_tpu/model/params.py``. Parameters live in an
unconstrained basis; the slowness is ``s = s_bg * exp(upsample(u))`` with
``u`` on the coarse inversion grid, and hypocentres are ``hypo_raw`` mapped
into the grid's box by a scaled sigmoid (a uniform-in-box prior becomes
the logistic Jacobian term :func:`box_logjac`). Leaves may carry a leading
chain axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from mceik_tpu_torch.grid import Grid


@dataclasses.dataclass
class Params:
    u: Optional[torch.Tensor] = None          # (inv_shape) log-slowness deviation
    hypo_raw: Optional[torch.Tensor] = None   # (n_ev, D) unconstrained
    t0: Optional[torch.Tensor] = None         # (n_ev,)
    log_sigma: Optional[torch.Tensor] = None  # () or (n_sta,)
    noise_z: Optional[torch.Tensor] = None    # (n_sta,) spike-slab indicators


def slowness_from_u(u: torch.Tensor, grid: Grid,
                    background: torch.Tensor) -> torch.Tensor:
    """Coarse unconstrained field -> positive slowness on the forward grid.

    ``u``: ``inv_shape`` or ``(C,) + inv_shape``. Linear upsampling with
    half-pixel centres and clamped edges (``align_corners=False``) is what
    ``jax.image.resize(method="linear")`` does when it upsamples; it
    antialiases when it downsamples, which this does not, so a coarser
    forward grid is refused.
    """
    nd = grid.ndim
    batched = u.ndim == nd + 1
    x = u if batched else u.unsqueeze(0)
    if any(a > b for a, b in zip(x.shape[1:], grid.shape)):
        raise ValueError(f"inversion grid {tuple(x.shape[1:])} is finer than "
                         f"the forward grid {grid.shape}")
    mode = {2: "bilinear", 3: "trilinear"}[nd]
    up = F.interpolate(x.unsqueeze(1), size=grid.shape, mode=mode,
                       align_corners=False).squeeze(1)
    if not batched:
        up = up[0]
    return background * torch.exp(up)


def _box(grid: Grid, margin: float, like: torch.Tensor):
    lo = torch.tensor(grid.origin, dtype=like.dtype, device=like.device) + margin
    hi = lo + torch.tensor(grid.extent, dtype=like.dtype,
                           device=like.device) - 2 * margin
    return lo, hi


def box_from_raw(hypo_raw: torch.Tensor, grid: Grid,
                 margin: float = 0.0) -> torch.Tensor:
    """Sigmoid-map unconstrained coords ``(..., D)`` into the grid's
    physical box."""
    lo, hi = _box(grid, margin, hypo_raw)
    return lo + (hi - lo) * torch.sigmoid(hypo_raw)


def box_logjac(hypo_raw: torch.Tensor) -> torch.Tensor:
    """log|d box / d raw| per chain, ``(C, ...) -> (C,)`` (the
    uniform-in-box prior in raw coords), dropping the constant log(hi - lo)
    terms."""
    t = F.logsigmoid(hypo_raw) + F.logsigmoid(-hypo_raw)
    return t.flatten(1).sum(1)


def raw_from_box(xyz: torch.Tensor, grid: Grid,
                 margin: float = 0.0) -> torch.Tensor:
    """Inverse of :func:`box_from_raw` (for starting chains at points)."""
    lo, hi = _box(grid, margin, xyz)
    p = torch.clamp((xyz - lo) / (hi - lo), 1e-5, 1 - 1e-5)
    return torch.log(p) - torch.log1p(-p)
