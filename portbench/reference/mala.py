"""The Metropolis-adjusted Langevin step's acceptance, by the plain
posterior.

Plain PyTorch, imports nothing of the program. A MALA step from ``x``
with the lower Cholesky factor ``L`` of its preconditioner, the step
``eps`` and the standard normals ``xi`` proposes

    y = x + (eps^2 / 2) L L^T g(x) + eps L xi

and accepts where ``log u < log_ratio``:

    log_ratio = lp(y) - lp(x) + |xi|^2 / 2 - |z|^2 / 2,
    z = xi + (eps / 2) L^T (g(x) + g(y)),

with ``lp`` and ``g`` the log posterior and its gradient, computed here by
the reference at both points. Coordinates whose ``active`` is 0 neither
move nor enter the ratio.
"""

from __future__ import annotations

import torch


def _lp_grad(ref, u: torch.Tensor, C: int):
    r = ref.gradient_terms(u)
    return r["prior"] + r["lik"], (r["g_prior"] + r["g_lik"]).reshape(C, -1)


def log_ratio(ref, x: torch.Tensor, xi: torch.Tensor, eps: float,
              L: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """``(C,)`` log acceptance ratio of each chain's proposal; ``x`` is
    ``(C,) + shape`` as ``ref`` takes it, ``xi`` ``(C, d)``, ``L`` ``(d,
    d)``, ``active`` ``(d,)`` of 0 and 1. A ratio that is not finite is
    ``-inf`` (never accepted)."""
    C = x.shape[0]
    lp_x, g_x = _lp_grad(ref, x, C)
    xi = xi * active
    a = (g_x * active) @ L
    y = x.reshape(C, -1) + (0.5 * eps * eps * a + eps * xi) @ L.T
    lp_y, g_y = _lp_grad(ref, y.reshape(x.shape), C)
    z = xi + 0.5 * eps * (a + (g_y * active) @ L)
    lr = lp_y - lp_x + 0.5 * (xi * xi).sum(1) - 0.5 * (z * z).sum(1)
    return torch.where(torch.isfinite(lr), lr,
                       torch.full_like(lr, -float("inf")))


def wrong_side(lr: torch.Tensor, log_u: torch.Tensor,
               moved: torch.Tensor) -> torch.Tensor:
    """How far, in units of log probability, each chain's move (or stay)
    lies on the wrong side of the decision ``log u < log_ratio``: 0 where
    it lies on the right side."""
    d = torch.where(moved, log_u - lr, lr - log_u)
    return torch.nan_to_num(d.double(), nan=float("inf")).clamp(min=0.0)
