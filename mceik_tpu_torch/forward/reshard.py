"""Station-axis resharding of traveltime tables over ranks.

Counterpart of ``mceik_tpu/forward/reshard.py`` (the Ulysses-style
all-to-all). Tables solved grid-sharded (``eikonal/dist_sweep.py``: each
rank holds a slab of every station's field) are moved by one all-to-all
from

    (S, X/n, Y, Z)  per rank   [grid-sharded, stations on every rank]
to
    (S/n, X, Y, Z)  per rank   [station-sharded, the whole grid]

so that each rank interpolates its own stations' whole fields at the
events; the ``(S/n, E)`` arrivals are all-gathered. Every table value
changes owner at most once.
"""

from __future__ import annotations

import torch

from mceik_tpu_torch.dist.mesh import Mesh, all_gather0, all_to_all01
from mceik_tpu_torch.forward.predict import interp_tables
from mceik_tpu_torch.grid import Grid


def reshard_tables_to_stations(tables: torch.Tensor,
                               mesh: Mesh) -> torch.Tensor:
    """This rank's grid slab of every station's table, ``(S, X/n, ...)``,
    to its stations' whole tables, ``(S/n, X, ...)``. The station count
    must divide over the ranks."""
    S = tables.shape[0]
    if S % mesh.world:
        raise ValueError(f"n_stations ({S}) must divide over {mesh.world} "
                         "ranks")
    return all_to_all01(tables, mesh)


def predict_events_resharded(tables: torch.Tensor, event_xyz: torch.Tensor,
                             t0: torch.Tensor, grid: Grid,
                             mesh: Mesh) -> torch.Tensor:
    """Predicted arrivals ``(n_ev, n_sta)`` on every rank from this rank's
    grid slab of the station tables: the reshard, each rank's stations
    interpolated at the events (``forward/predict.interp_tables``), the
    rows all-gathered and the origin times added."""
    tabs = reshard_tables_to_stations(tables, mesh)
    tt = all_gather0(interp_tables(tabs, event_xyz, grid), mesh)   # (S, E)
    return tt.T + t0.unsqueeze(-1)
