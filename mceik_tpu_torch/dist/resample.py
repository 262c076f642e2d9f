"""Systematic resampling of a particle population, sharded or not.

Counterpart of ``mceik_tpu/dist/resample.py``: the indices come from
globally normalised weights and one shared uniform offset, and the
population is gathered by them. The uniform is an argument (a tensor), so a
test can hand in JAX's draw.

Sharded over ranks (a ``mesh``, ``dist/mesh.py``) each rank holds its rows
of the population: the indices and the ESS take the global log-weights
(all-gathered by the caller, ``samplers/smc.py``), so every rank computes
the same indices from the same uniform; :func:`resample_tree` all-gathers
the population and each rank keeps the rows its share of the indices picks.
"""

from __future__ import annotations

from typing import Any

import torch

from mceik_tpu_torch.dist.mesh import Mesh, gather_chains
from mceik_tpu_torch.utils import tree_map


def systematic_indices(log_weights: torch.Tensor,
                       u: torch.Tensor) -> torch.Tensor:
    """Systematic resampling indices ``(N,)`` from unnormalised log-weights
    and one uniform ``u`` in [0, 1): low-variance stratified inversion of
    the weight CDF (searchsorted, left side)."""
    n = log_weights.shape[0]
    w = torch.exp(log_weights - torch.logsumexp(log_weights, 0))
    cdf = torch.cumsum(w, 0)
    cdf = cdf / cdf[-1]
    positions = (u + torch.arange(n, dtype=torch.float32,
                                  device=log_weights.device)) / n
    return torch.clamp(torch.searchsorted(cdf, positions), 0, n - 1)


def resample_tree(tree: Any, indices: torch.Tensor,
                  mesh: Mesh = Mesh()) -> Any:
    """Gather every leaf's leading (particle) axis by the global
    ``indices``; sharded, this rank's rows of the result."""
    if mesh.sharded:
        lo, hi = mesh.rows(indices.shape[0])
        tree, indices = gather_chains(tree, mesh), indices[lo:hi]
    return tree_map(lambda x: x[indices], tree)


def ess_from_log_weights(log_weights: torch.Tensor) -> torch.Tensor:
    """Effective sample size (Kish) of unnormalised log-weights."""
    w = torch.exp(log_weights - log_weights.max())
    return torch.square(w.sum()) / torch.clamp((w * w).sum(), min=1e-30)
