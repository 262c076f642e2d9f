"""Traveltime tables + receiver interpolation -> predicted arrivals.

Counterpart of ``mceik_tpu/forward/predict.py``. A leading chain axis on
the slowness is carried through: every chain's tables go into ONE batched
solve of ``chains x table points`` fields. With ``differentiable=True`` the
solve is the implicit-adjoint one (``eikonal/adjoint.py``), so gradients
reach the slowness; interpolation gradients (to the tables and to event
positions) flow through ``grid.sample_linear``'s autograd. The route is
chosen here as the reference chooses it (``solve.solve_route``): with the
kernels on, whole-field solves up to 2 MB per field and the blocked route's
count above (two whole-field cycles per iteration, e.g. at 128^3); with
them off, the plain cycle. The forward solve and its transport take the
same route.
"""

from __future__ import annotations

import torch

from mceik_tpu_torch.eikonal.adjoint import solve_eikonal_diff_batched
from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched
from mceik_tpu_torch.eikonal.solve import EikonalConfig, solve_route
from mceik_tpu_torch.grid import Grid, sample_linear


def traveltime_tables(slowness: torch.Tensor, table_xyz: torch.Tensor,
                      grid: Grid, config: EikonalConfig = EikonalConfig(),
                      differentiable: bool = False) -> torch.Tensor:
    """Solve one traveltime field per table point (station or source).

    Args:
      slowness: grid-shaped, or ``(C,) + grid.shape`` for C chains.
      table_xyz: ``(n_tab, D)`` physical coordinates of the solve origins.

    Returns ``(n_tab,) + grid.shape``, or ``(C, n_tab) + grid.shape``.
    """
    lead = tuple(slowness.shape[:-grid.ndim])
    s = slowness.reshape((-1,) + grid.shape)
    C, n_tab = s.shape[0], table_xyz.shape[0]
    s_b = s.unsqueeze(1).expand((C, n_tab) + grid.shape)
    srcs = table_xyz.unsqueeze(0).expand(C, n_tab, grid.ndim)
    impl = solve_route(grid.shape, config.use_pallas, s.device)
    s_b = s_b.reshape((C * n_tab,) + grid.shape)
    srcs = srcs.reshape(C * n_tab, grid.ndim)
    if differentiable:
        T = solve_eikonal_diff_batched(s_b, srcs, grid, config, impl=impl)
    else:
        T = solve_eikonal_batched(s_b, srcs, grid, config, impl)
    return T.reshape(lead + (n_tab,) + grid.shape)


def interp_at(T: torch.Tensor, xyz: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Multilinear interpolation of one grid field at physical points
    (coordinates clamped to the grid). ``xyz``: ``(..., D)`` -> ``(...)``."""
    idx = grid.to_index_coords(xyz)
    out = sample_linear(T.unsqueeze(0), idx.reshape(1, -1, grid.ndim))
    return out.reshape(xyz.shape[:-1])


def interp_tables(tables: torch.Tensor, xyz: torch.Tensor,
                  grid: Grid) -> torch.Tensor:
    """Interpolate every table at every point: ``(..., n_tab) + grid`` and
    ``(n_pts, D)`` -> ``(..., n_tab, n_pts)``."""
    lead = tuple(tables.shape[:-grid.ndim])
    flat = tables.reshape((-1,) + grid.shape)
    idx = grid.to_index_coords(xyz).reshape(1, -1, grid.ndim)
    out = sample_linear(flat, idx.expand(flat.shape[0], -1, -1))
    return out.reshape(lead + (idx.shape[1],))


def predict_tomo(slowness: torch.Tensor, src_xyz: torch.Tensor,
                 rec_xyz: torch.Tensor, grid: Grid,
                 config: EikonalConfig = EikonalConfig(),
                 solve_from: str = "auto",
                 differentiable: bool = False) -> torch.Tensor:
    """Predicted traveltimes for known source/receiver pairs.

    Returns ``(n_src, n_rec)`` (or ``(C, n_src, n_rec)`` for a chain batch of
    slowness fields). Solves from whichever side has fewer points
    (reciprocity) unless forced by ``solve_from``.
    """
    n_src, n_rec = src_xyz.shape[0], rec_xyz.shape[0]
    if solve_from == "auto":
        solve_from = "src" if n_src <= n_rec else "rec"
    if solve_from == "src":
        tables = traveltime_tables(slowness, src_xyz, grid, config,
                                   differentiable)
        return interp_tables(tables, rec_xyz, grid)
    tables = traveltime_tables(slowness, rec_xyz, grid, config, differentiable)
    return interp_tables(tables, src_xyz, grid).transpose(-1, -2)


def predict_events(station_tables: torch.Tensor, event_xyz: torch.Tensor,
                   t0: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Predicted arrivals of events with unknown hypocentres.

    Tables are solved from the stations (reciprocity), so an arrival is
    ``T_station(event) + t0`` and its hypocentre gradient flows through the
    interpolation alone; every chain interpolates its own tables at its own
    events.

    Args:
      station_tables: ``lead + (n_sta,) + grid.shape``.
      event_xyz: ``lead + (n_ev, D)`` hypocentres. t0: ``lead + (n_ev,)``.

    Returns ``lead + (n_ev, n_sta)``.
    """
    D = grid.ndim
    lead = tuple(event_xyz.shape[:-2])
    n_ev = event_xyz.shape[-2]
    tabs = station_tables.reshape((-1,) + tuple(station_tables.shape[-D - 1:]))
    L, n_sta = tabs.shape[0], tabs.shape[1]
    idx = grid.to_index_coords(event_xyz).reshape(L, 1, n_ev, D)
    tt = sample_linear(tabs.reshape((L * n_sta,) + grid.shape),
                       idx.expand(L, n_sta, n_ev, D).reshape(L * n_sta, n_ev, D))
    tt = tt.reshape(L, n_sta, n_ev).transpose(1, 2)
    return tt.reshape(lead + (n_ev, n_sta)) + t0.unsqueeze(-1)
