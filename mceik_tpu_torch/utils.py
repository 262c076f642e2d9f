"""Tree helpers over parameter containers (``Params``, dicts of tensors).

Counterpart of ``mceik_tpu/utils.py``. A tree is a tensor, a dict, tuple
or list of trees or a dataclass of trees; ``None`` leaves are skipped, as in a JAX
pytree. Trees of chain states carry a leading chain axis on every leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"not a tree node: {type(tree).__name__}")


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in field/key order (the JAX flattening order for Params)."""
    out: List[torch.Tensor] = []
    tree_map(lambda x: out.append(x), tree)
    return out


def tree_random_normal(gen: torch.Generator, example: Any) -> Any:
    """Standard-normal tree with the shapes of ``example``, drawn leaf by
    leaf from ``gen`` on its device and moved to each leaf's."""
    return tree_map(lambda x: torch.randn(
        x.shape, generator=gen, dtype=x.dtype, device=gen.device).to(x.device),
        example)


def tree_where(pred: torch.Tensor, a: Any, b: Any) -> Any:
    """Select whole trees per chain: ``pred`` is ``(C,)`` and every leaf has
    a leading chain axis."""
    def sel(x, y):
        return torch.where(pred.reshape(pred.shape + (1,) * (x.ndim - 1)), x, y)
    return tree_map(sel, a, b)


def tree_size(tree: Any) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))


def per_chain(c, x: torch.Tensor):
    """A scalar as it is; a ``(C,)`` tensor shaped to broadcast along the
    chain axis of ``x``."""
    if isinstance(c, torch.Tensor) and c.ndim == 1:
        return c.reshape(c.shape + (1,) * (x.ndim - 1))
    return c


def tree_mul(a: Any, b: Any) -> Any:
    return tree_map(torch.mul, a, b)


def tree_axpy(c, x: Any, y: Any) -> Any:
    """``y + c * x``; ``c`` a scalar or one value per chain."""
    return tree_map(lambda xi, yi: yi + per_chain(c, xi) * xi, x, y)


def tree_dot(a: Any, b: Any) -> torch.Tensor:
    """Per-chain inner product of two chain-batched trees: ``(C,)``, each
    leaf summed over its non-chain axes and the leaves added in order."""
    parts = [(x * y).flatten(1).sum(1)
             for x, y in zip(tree_leaves(a), tree_leaves(b))]
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out
