"""The per-answer comparisons the drivers' checks are made of."""

from __future__ import annotations

import torch


def rel_gap(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``|x - ref| / max(1, |ref|)`` per answer."""
    return (x - ref).abs() / ref.abs().clamp(min=1.0)


def unchanged(x: torch.Tensor, before: torch.Tensor) -> torch.Tensor:
    """1.0 for each row of ``x`` equal to its row in ``before``, else 0.0."""
    return (x == before).flatten(1).all(1).to(torch.float64)


def seen(x: torch.Tensor, population: torch.Tensor,
         block: int = 128) -> torch.Tensor:
    """1.0 for each row of ``x`` equal to some row of ``population``, else
    0.0 (compared ``block`` rows of ``x`` at a time)."""
    pop = population.flatten(1)
    out = [(r[:, None, :] == pop[None]).all(2).any(1)
           for r in x.flatten(1).split(block)]
    return torch.cat(out).to(torch.float64)
