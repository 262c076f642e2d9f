"""Ranks, chain sharding and the collectives, over ``torch.distributed``.

Counterpart of ``mceik_tpu/dist/mesh.py``. Where the JAX package builds one
process's ``Mesh`` of devices and lets XLA emit the collectives, the port
runs one process per rank, started by ``torchrun``
(``python -m torch.distributed.run``), which sets ``WORLD_SIZE``, ``RANK``
and ``LOCAL_RANK``. A rank's device is ``cuda:(LOCAL_RANK % cards)``, or the
CPU when the caller asks for it.

The backend: NCCL when every rank of a host has a card of its own, gloo when
the ranks run on the CPU or share a card (NCCL refuses two ranks on one
device). Gloo runs little on CUDA tensors beyond ``all_reduce`` and
``broadcast``, so under gloo every helper here stages a CUDA tensor through
host memory, and nothing else in the port does. A collective that fails
raises; nothing is caught or retried.

A :class:`Mesh` without a process group (one process, no launcher) makes
every helper the identity: it issues no collective.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from mceik_tpu_torch.utils import tree_map


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks a run shards over: ``world`` ranks of which this process is
    ``rank``, on ``device``. ``backend`` is None when there is no process
    group (the helpers are then the identity); ``group`` is the process
    group (None: the default one). ``root`` marks the process that reports
    (global rank 0)."""

    world: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    group: Any = None
    root: bool = True

    @property
    def sharded(self) -> bool:
        """True when the helpers run collectives."""
        return self.backend is not None

    def rows(self, n: int) -> Tuple[int, int]:
        """``(lo, hi)``: this rank's rows of a leading axis of ``n``."""
        if n % self.world:
            raise ValueError(f"{n} rows do not divide over {self.world} "
                             "ranks")
        k = n // self.world
        return self.rank * k, (self.rank + 1) * k


def pick_backend(device_type: str, local_world: int, n_cards: int,
                 requested: Optional[str] = None) -> str:
    """The process group's backend: NCCL when every rank of the host has a
    card of its own, else gloo (ranks on the CPU, or several ranks on one
    card). ``requested`` ("nccl" or "gloo") overrides the choice, and NCCL
    asked for where it cannot run is refused."""
    shared = device_type == "cuda" and local_world > n_cards
    if requested not in (None, "auto", "nccl", "gloo"):
        raise ValueError(f"unknown backend {requested!r}: nccl or gloo")
    if requested == "nccl" and device_type != "cuda":
        raise ValueError("backend nccl needs CUDA devices; the CPU ranks "
                         "take gloo")
    if requested == "nccl" and shared:
        raise ValueError(
            f"backend nccl with {local_world} ranks on {n_cards} card(s): "
            "NCCL refuses two ranks on one device; use gloo")
    if requested in ("nccl", "gloo"):
        return requested
    return "nccl" if device_type == "cuda" and not shared else "gloo"


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, "") or default)


def init_distributed(cfg, device, backend: Optional[str] = None) -> Mesh:
    """The run's mesh, with the process group brought up when a launcher
    started several ranks (``WORLD_SIZE`` > 1).

    Without a launcher the run is one process on ``device`` (with
    ``dist.n_devices`` or ``dist.multihost`` set, ``api.check_run_options``
    has warned). Under a launcher a CUDA ``device`` becomes this rank's card,
    ``cuda:(LOCAL_RANK % cards)``; ``dist.n_devices`` caps the ranks that
    shard (the first ones; the others run unsharded and report nothing).
    A process group already up (a caller's) is used as it is."""
    device = torch.device(device)
    world = _env_int("WORLD_SIZE", 1)
    if world <= 1 and not dist.is_initialized():
        return Mesh(device=device)
    if device.type == "cuda":
        device = torch.device("cuda", _env_int("LOCAL_RANK", 0)
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        chosen = dist.get_backend()
    else:
        chosen = pick_backend(device.type, _env_int("LOCAL_WORLD_SIZE", world),
                              torch.cuda.device_count()
                              if device.type == "cuda" else 0, backend)
        dist.init_process_group(chosen)
    world, rank = dist.get_world_size(), dist.get_rank()
    k = min(world, cfg.n_devices or world)
    group = None
    if k < world:
        warnings.warn(f"dist.n_devices={cfg.n_devices} caps the mesh at {k} "
                      f"of {world} ranks; the others run unsharded and "
                      "report nothing")
        if k > 1:
            group = dist.new_group(list(range(k)))   # on every rank
        if rank >= k or k == 1:
            return Mesh(device=device, root=rank == 0)
    return Mesh(world=k, rank=rank, device=device, backend=chosen,
                group=group, root=rank == 0)


def unsharded(mesh: Mesh) -> Mesh:
    """The same process with no collectives: every rank runs everything,
    and only the root reports."""
    return Mesh(device=mesh.device, root=mesh.root)


def chain_mesh(mesh: Mesh, n_rows: int, what: str = "chains") -> Mesh:
    """``mesh`` when ``n_rows`` divides over its ranks, else (with a
    warning) :func:`unsharded`, as the reference keeps a batch that does
    not divide unsharded."""
    if not mesh.sharded or n_rows % mesh.world == 0:
        return mesh
    warnings.warn(f"{n_rows} {what} do not divide over {mesh.world} ranks: "
                  "every rank runs all of them and rank 0 reports")
    return unsharded(mesh)


# --- the collectives -------------------------------------------------------

def _stage(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The tensor the collective runs on: a contiguous copy, through host
    memory for a CUDA tensor under gloo; bool travels as uint8."""
    x = x.detach()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if mesh.backend == "gloo" and x.is_cuda:
        x = x.cpu()
    return x.contiguous()


def _unstage(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.to(device=like.device, dtype=like.dtype)


def _all_reduce(x: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    if not mesh.sharded:
        return x
    y = _stage(x, mesh).clone()
    dist.all_reduce(y, op=op, group=mesh.group)
    return _unstage(y, x)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise sum over the ranks."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise max over the ranks."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def any_rank(flag: torch.Tensor, mesh: Mesh) -> bool:
    """True when ``flag`` (a bool scalar) is true on any rank: a loop exit
    decided over all ranks."""
    return bool(all_reduce_max(flag.to(torch.int32), mesh))


def all_gather0(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0, in rank order."""
    if not mesh.sharded:
        return x
    y = _stage(x, mesh)
    parts = [torch.empty_like(y) for _ in range(mesh.world)]
    dist.all_gather(parts, y, group=mesh.group)
    return _unstage(torch.cat(parts), x)


def all_to_all01(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(A, B, ...)`` per rank to ``(A / n, n B, ...)``: axis 0 split over
    the ranks, the pieces each rank receives concatenated along axis 1 in
    rank order (JAX's ``all_to_all(split_axis=0, concat_axis=1,
    tiled=True)``)."""
    if not mesh.sharded:
        return x
    if x.shape[0] % mesh.world:
        raise ValueError(f"axis 0 ({x.shape[0]}) must divide over "
                         f"{mesh.world} ranks")
    y = _stage(x, mesh)
    sends = [c.contiguous() for c in y.chunk(mesh.world, 0)]
    recvs = [torch.empty_like(sends[0]) for _ in range(mesh.world)]
    if mesh.backend == "gloo":
        # Not every gloo build runs all_to_all: one scatter per source
        # moves the same bytes.
        for r in range(mesh.world):
            dist.scatter(recvs[r], sends if r == mesh.rank else None,
                         src=_global(r, mesh), group=mesh.group)
    else:
        dist.all_to_all(recvs, sends, group=mesh.group)
    return _unstage(torch.cat(recvs, dim=1), x)


def _global(r: int, mesh: Mesh) -> int:
    """The global rank of the mesh's rank ``r``."""
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def broadcast0(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's ``x`` on every rank."""
    if not mesh.sharded:
        return x
    y = _stage(x, mesh).clone()
    dist.broadcast(y, src=_global(0, mesh), group=mesh.group)
    return _unstage(y, x)


# --- trees -------------------------------------------------------------------

def shard_chains(tree: Any, mesh: Mesh) -> Any:
    """This rank's rows of every leaf's leading (chain) axis."""
    if not mesh.sharded:
        return tree

    def rows(x):
        lo, hi = mesh.rows(x.shape[0])
        return x[lo:hi]
    return tree_map(rows, tree)


def gather_chains(tree: Any, mesh: Mesh) -> Any:
    """Every rank's rows of every leaf, along the leading axis: the global
    batch on every rank."""
    return tree_map(lambda x: all_gather0(x, mesh), tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's tree on every rank."""
    return tree_map(lambda x: broadcast0(x, mesh), tree)


def draw_rows(draw: Callable, gen: torch.Generator, states: Any,
              mesh: Mesh):
    """``draw(gen, states)`` for the whole chain batch, this rank's rows
    kept: every rank draws the same numbers from its generator (in step
    with the others), so a sharded run takes the unsharded run's draws.
    ``draw`` reads only the shapes, dtypes and devices of ``states``, whose
    leaves all carry the chain axis first."""
    if not mesh.sharded:
        return draw(gen, states)
    whole = tree_map(lambda x: x[:1].expand((x.shape[0] * mesh.world,)
                                            + tuple(x.shape[1:])), states)
    return shard_chains(draw(gen, whole), mesh)
