"""Online (Welford) moments over parameter trees.

Counterpart of ``mceik_tpu/diag/moments.py``. Works per chain (leading
chain axis on ``count`` and every leaf) and merges across chains with the
Chan batch update.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mceik_tpu_torch.io.trace import device_tensor
from mceik_tpu_torch.utils import tree_leaves, tree_map


@dataclasses.dataclass
class Welford:
    count: torch.Tensor  # scalar (or per-chain) sample count
    mean: Any            # tree
    m2: Any              # tree of sums of squared deviations


def _bcast(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return c.reshape(c.shape + (1,) * (x.ndim - c.ndim))


def welford_init(example: Any, batch_shape=()) -> Welford:
    leaf = tree_leaves(example)[0]
    zeros = lambda x: torch.zeros(tuple(batch_shape) + tuple(x.shape),
                                  dtype=torch.float32, device=x.device)
    return Welford(
        count=torch.zeros(tuple(batch_shape), dtype=torch.float32,
                          device=leaf.device),
        mean=tree_map(zeros, example),
        m2=tree_map(zeros, example),
    )


def welford_update(w: Welford, x: Any) -> Welford:
    """Add one sample (a tree shaped like ``w.mean``)."""
    n = w.count + 1.0
    deltas = tree_map(lambda mean, xi: xi - mean, w.mean, x)
    mean = tree_map(lambda mean, d: mean + d / _bcast(n, d), w.mean, deltas)
    m2 = tree_map(lambda m2, d, xi, mn: m2 + d * (xi - mn),
                  w.m2, deltas, x, mean)
    return Welford(count=n, mean=mean, m2=m2)


def welford_update_batch(w: Welford, x: Any, axis: int = 0) -> Welford:
    """Merge a batch of samples (e.g. every chain's position) into a running
    accumulator with a scalar count (Chan parallel merge)."""
    leaf = tree_leaves(x)[0]
    nb = device_tensor(float(leaf.shape[axis]), torch.float32, leaf.device)
    n_new = w.count + nb

    def merge_mean(mean, xi):
        mb = xi.mean(dim=axis)
        return mean + (mb - mean) * (nb / torch.clamp(n_new, min=1.0))

    def merge_m2(m2, mean, xi):
        mb = xi.mean(dim=axis)
        sb = ((xi - mb.unsqueeze(axis)) ** 2).sum(dim=axis)
        delta = mb - mean
        return m2 + sb + delta ** 2 * (w.count * nb / torch.clamp(n_new, min=1.0))

    mean = tree_map(merge_mean, w.mean, x)
    m2 = tree_map(merge_m2, w.m2, w.mean, x)
    return Welford(count=n_new, mean=mean, m2=m2)


def welford_finalize(w: Welford):
    """Return ``(mean, variance)`` trees."""
    var = tree_map(lambda m2: m2 / torch.clamp(_bcast(w.count, m2) - 1.0,
                                               min=1.0), w.m2)
    return w.mean, var


def welford_merge_chains(w: Welford) -> Welford:
    """Collapse a per-chain accumulator (leading chain axis) into one pooled
    accumulator (total-population moments across chains)."""
    counts = w.count  # (C,)
    n_tot = counts.sum()

    def grand_mean(mean_c):
        return (_bcast(counts, mean_c) * mean_c).sum(0) / torch.clamp(n_tot, min=1.0)

    mean = tree_map(grand_mean, w.mean)
    m2 = tree_map(lambda m2_c, mean_c, gm: (
        m2_c + _bcast(counts, mean_c) * (mean_c - gm) ** 2).sum(0),
        w.m2, w.mean, mean)
    return Welford(count=n_tot, mean=mean, m2=m2)
