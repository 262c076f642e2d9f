"""Checkpoint/resume of sampler state, as a torch-native ``.pt`` file.

Counterpart of ``mceik_tpu/io/checkpoint.py`` without JAX or HDF5.
Checkpoints are complete: every chain's parameters, log-posterior,
adaptation state and, where the caller puts it in, the ``torch.Generator``
state (a uint8 tensor), so a resumed run continues the interrupted one's
random stream. A checkpoint is one flat dict, written by ``torch.save`` to
a tmp file and renamed over the path (atomic):

- ``"state"``: the tree's tensor leaves, saved from the CPU and keyed by
  their path in the tree (``states/params/u``, ``hyper/da/log_eps``: a
  dataclass field by its name, a dict entry by its key, a tuple or list
  entry by its index; ``_root`` for a bare tensor). ``None`` leaves are
  skipped, as in a JAX pytree.
- ``"meta"``: a JSON string.

Restoring is example-driven: leaves are looked up by the paths of a
structurally identical example and come back on the example's device and
dtype, so the format survives dataclass changes that only reorder fields.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional

import torch


def _map_with_paths(fn: Callable[[str, torch.Tensor], Any], tree: Any,
                    prefix: str = "") -> Any:
    """Rebuild ``tree`` with every tensor leaf ``x`` at path ``p`` replaced
    by ``fn(p, x)``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(prefix or "_root", tree)
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_paths(fn, v, join(i))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_with_paths(fn, getattr(tree, f.name), join(f.name))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"not a tree node: {type(tree).__name__}")


def _flatten_with_paths(tree: Any) -> Dict[str, torch.Tensor]:
    """``{path: CPU tensor}`` over the tree's tensor leaves."""
    out: Dict[str, torch.Tensor] = {}

    def keep(path, x):
        out[path] = x.detach().cpu().contiguous()
        return x

    _map_with_paths(keep, tree)
    return out


def save_checkpoint(path: str, state: Any,
                    meta: Optional[Dict] = None) -> None:
    """Write ``state`` (a tree of tensors) and ``meta`` (JSON-able)
    atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"state": _flatten_with_paths(state),
                "meta": json.dumps(meta or {})}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, example: Any):
    """Load a checkpoint into the structure of ``example``.

    Returns ``(state, meta)``. Raises KeyError if a leaf of the example is
    missing from the checkpoint and ValueError if its shape differs (a
    config mismatch)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    stored = obj["state"]

    def restore(key, leaf):
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = stored[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key!r}: checkpoint "
                             f"{tuple(arr.shape)} vs example "
                             f"{tuple(leaf.shape)}")
        return arr.to(device=leaf.device, dtype=leaf.dtype)

    return _map_with_paths(restore, example), json.loads(obj.get("meta",
                                                                 "{}"))
