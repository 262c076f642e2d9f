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
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.io.trace import span


@dataclasses.dataclass
class Params:
    u: Optional[torch.Tensor] = None          # (inv_shape) log-slowness deviation
    hypo_raw: Optional[torch.Tensor] = None   # (n_ev, D) unconstrained
    t0: Optional[torch.Tensor] = None         # (n_ev,)
    log_sigma: Optional[torch.Tensor] = None  # () or (n_sta,)
    noise_z: Optional[torch.Tensor] = None    # (n_sta,) spike-slab indicators


_MODES = {2: "bilinear", 3: "trilinear"}


@functools.lru_cache(maxsize=64)
def linear_resample_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """``(n_out, n_in)`` weights of 1-D linear resampling with half-pixel
    centres and clamped edges, computed as ``F.interpolate(...,
    align_corners=False)`` computes them (fp32 source index
    ``max(n_in / n_out * (i + 0.5) - 0.5, 0)``). Cached per shape and
    device: treat the result as read-only."""
    scale = torch.tensor(n_in, dtype=torch.float32) / n_out
    i = torch.arange(n_out, dtype=torch.float32)
    src = torch.clamp(scale * (i + 0.5) - 0.5, min=0.0)
    i0 = src.long()
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    l1 = src - i0.to(torch.float32)
    A = torch.zeros((n_out, n_in), dtype=torch.float32)
    rows = torch.arange(n_out)
    A.index_put_((rows, i0), 1.0 - l1, accumulate=True)
    A.index_put_((rows, i1), l1, accumulate=True)
    return A.to(device)


class _Upsample(torch.autograd.Function):
    """``F.interpolate``'s linear upsampling of a ``(C,) + coarse`` batch,
    whose backward is the separable transpose, one matrix product per axis,
    in place of ``interpolate``'s own backward (atomic adds on CUDA): the
    same gradient to rounding, but the same bits on every run and the same
    code on every device, so that a seeded gradient sampler is
    reproducible."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.shapes = (tuple(x.shape[1:]), size)
        return F.interpolate(x.unsqueeze(1), size=size,
                             mode=_MODES[len(size)],
                             align_corners=False).squeeze(1)

    @staticmethod
    def backward(ctx, g):
        coarse, fine = ctx.shapes
        for d in reversed(range(len(fine))):
            A = linear_resample_matrix(coarse[d], fine[d], str(g.device))
            g = torch.tensordot(g, A, dims=([d + 1], [0])).movedim(-1, d + 1)
        return g, None


def slowness_from_u(u: torch.Tensor, grid: Grid,
                    background: torch.Tensor) -> torch.Tensor:
    """Coarse unconstrained field -> positive slowness on the forward grid.

    ``u``: ``inv_shape`` or ``(C,) + inv_shape``. Linear upsampling with
    half-pixel centres and clamped edges (``align_corners=False``) is what
    ``jax.image.resize(method="linear")`` does when it upsamples; it
    antialiases when it downsamples, which this does not, so a coarser
    forward grid is refused. The backward is :class:`_Upsample`'s, which
    is reproducible bit for bit.
    """
    nd = grid.ndim
    batched = u.ndim == nd + 1
    x = u if batched else u.unsqueeze(0)
    if any(a > b for a, b in zip(x.shape[1:], grid.shape)):
        raise ValueError(f"inversion grid {tuple(x.shape[1:])} is finer than "
                         f"the forward grid {grid.shape}")
    with span("mceik.forward.slowness"):
        up = _Upsample.apply(x, tuple(grid.shape))
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
