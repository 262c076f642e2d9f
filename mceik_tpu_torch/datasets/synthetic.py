"""Synthetic truth models, acquisition geometries and noisy arrivals: the
2-D crosswell workloads (configs 1 and 4), the 3-D checkerboards (config 2
and its volume-acquisition variant) and the joint events problems
(config 3).

Counterpart of ``mceik_tpu/datasets/synthetic.py``, whose ``make_dataset``
also reads observed data: the "file" dataset (HDF5 or ``.pt``, by
extension) and the "csv" station and arrival tables (``io/loaders.py``),
on the requested device. Geometries and event truths come from numpy's
``default_rng`` with the reference's seeds, so they equal the JAX
package's. The noise comes from a CPU ``torch.Generator`` seeded as the
reference seeds its key (``data.seed``, ``data.seed + 2`` for events), so a
dataset is the same on every device; it is not JAX's noise, and parity
tests carry the JAX package's arrays across with ``convert``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from mceik_tpu_torch.config import DataCfg, ModelCfg
from mceik_tpu_torch.eikonal.solve import EikonalConfig
from mceik_tpu_torch.forward.predict import (predict_events, predict_tomo,
                                             traveltime_tables)
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.data import EventData, TomoData


def checkerboard_slowness(grid: Grid, cells: Tuple[int, ...],
                          amplitude: float, background: float = 1.0,
                          device="cpu") -> torch.Tensor:
    """Smooth sinusoidal checkerboard:
    ``s = s_bg * exp(A * prod_d sin(pi k_d x_d / L_d))``."""
    axes = grid.axes()
    ext = grid.extent
    pattern = torch.ones(grid.shape, dtype=torch.float32, device=device)
    for d in range(grid.ndim):
        x = torch.as_tensor((axes[d] - grid.origin[d]) / max(ext[d], 1e-12),
                            dtype=torch.float32, device=device)
        sd = torch.sin(math.pi * cells[d] * x)
        shape = [1] * grid.ndim
        shape[d] = grid.shape[d]
        pattern = pattern * sd.reshape(shape)
    return background * torch.exp(amplitude * pattern)


def crosswell_geometry(grid: Grid, n_src: int, n_rec: int,
                       margin_frac: float = 0.08, device="cpu"):
    """2-D crosswell: sources down one well, receivers down the other."""
    if grid.ndim != 2:
        raise ValueError(f"crosswell geometry needs a 2-D grid, got {grid.shape}")
    (x0, y0), (ex, ey) = grid.origin, grid.extent
    m = margin_frac
    src = np.stack([np.full(n_src, x0 + m * ex),
                    y0 + ey * np.linspace(m, 1 - m, n_src)], axis=-1)
    rec = np.stack([np.full(n_rec, x0 + (1 - m) * ex),
                    y0 + ey * np.linspace(m, 1 - m, n_rec)], axis=-1)
    return (torch.as_tensor(src, dtype=torch.float32, device=device),
            torch.as_tensor(rec, dtype=torch.float32, device=device))


def borehole_3d_geometry(grid: Grid, n_src: int, n_rec: int, device="cpu"):
    """3-D crosswell-like: sources on one face, receivers on the opposite
    face, laid out on a coarse face grid."""
    if grid.ndim != 3:
        raise ValueError(f"borehole geometry needs a 3-D grid, got {grid.shape}")
    lo = np.asarray(grid.origin)
    ext = np.asarray(grid.extent)

    def face_points(n, xfrac):
        k = int(np.ceil(np.sqrt(n)))
        ys = lo[1] + ext[1] * np.linspace(0.1, 0.9, k)
        zs = lo[2] + ext[2] * np.linspace(0.1, 0.9, k)
        Y, Z = np.meshgrid(ys, zs, indexing="ij")
        pts = np.stack([np.full(k * k, lo[0] + xfrac * ext[0]),
                        Y.ravel(), Z.ravel()], axis=-1)
        return pts[:n]

    return (torch.as_tensor(face_points(n_src, 0.05), dtype=torch.float32,
                            device=device),
            torch.as_tensor(face_points(n_rec, 0.95), dtype=torch.float32,
                            device=device))


def surface_array_geometry(grid: Grid, n_sta: int, seed: int = 0,
                           device="cpu") -> torch.Tensor:
    """3-D: stations scattered on the free surface (the min-z plane)."""
    if grid.ndim != 3:
        raise ValueError(f"surface array needs a 3-D grid, got {grid.shape}")
    rng = np.random.default_rng(seed)
    lo = np.asarray(grid.origin)
    ext = np.asarray(grid.extent)
    xy = lo[:2] + ext[:2] * (0.05 + 0.9 * rng.random((n_sta, 2)))
    z = np.full((n_sta, 1), lo[2])
    return torch.as_tensor(np.concatenate([xy, z], axis=-1),
                           dtype=torch.float32, device=device)


def volume3d_geometry(grid: Grid, n_src: int, n_rec: int, seed: int = 0,
                      device="cpu"):
    """3-D full coverage: sources scattered through the interior, receivers
    on the free surface and two opposite side faces in turn (crossing rays,
    so that a 3-D checkerboard is recoverable)."""
    if grid.ndim != 3:
        raise ValueError(f"volume geometry needs a 3-D grid, got {grid.shape}")
    rng = np.random.default_rng(seed)
    lo = np.asarray(grid.origin)
    ext = np.asarray(grid.extent)
    src = lo + ext * (0.15 + 0.7 * rng.random((n_src, 3)))
    recs = []
    for i in range(n_rec):
        p = lo + ext * (0.1 + 0.8 * rng.random(3))
        face = i % 3
        if face == 0:
            p[2] = lo[2]                         # free surface
        elif face == 1:
            p[0] = lo[0] + 0.97 * ext[0]         # +x face
        else:
            p[1] = lo[1] + 0.97 * ext[1]         # +y face
        recs.append(p)
    return (torch.as_tensor(src, dtype=torch.float32, device=device),
            torch.as_tensor(np.stack(recs), dtype=torch.float32,
                            device=device))


def _noisy(t_clean: torch.Tensor, noise: float, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    eps = torch.randn(tuple(t_clean.shape), generator=gen, dtype=torch.float32)
    return t_clean + noise * eps.to(t_clean.device)


def crosswell_dataset(grid: Grid, dcfg: DataCfg, mcfg: ModelCfg,
                      eik: EikonalConfig = EikonalConfig(), device="cpu"):
    """Configs 1 and 4: 2-D crosswell arrivals through a checkerboard truth.
    Returns ``(TomoData, s_true)``."""
    s_true = checkerboard_slowness(grid, dcfg.checker_cells,
                                   dcfg.checker_amplitude,
                                   mcfg.background_slowness, device=device)
    src, rec = crosswell_geometry(grid, dcfg.n_src, dcfg.n_rec, device=device)
    t_clean = predict_tomo(s_true, src, rec, grid, eik)
    return (TomoData(src_xyz=src, rec_xyz=rec,
                     t_obs=_noisy(t_clean, dcfg.noise, dcfg.seed)), s_true)


def checkerboard3d_dataset(grid: Grid, dcfg: DataCfg, mcfg: ModelCfg,
                           eik: EikonalConfig = EikonalConfig(),
                           device="cpu"):
    """Config 2: 3-D checkerboard, borehole-face acquisition, known sources.
    Returns ``(TomoData, s_true)``."""
    s_true = checkerboard_slowness(grid, dcfg.checker_cells,
                                   dcfg.checker_amplitude,
                                   mcfg.background_slowness, device=device)
    src, rec = borehole_3d_geometry(grid, dcfg.n_src, dcfg.n_rec,
                                    device=device)
    t_clean = predict_tomo(s_true, src, rec, grid, eik)
    return (TomoData(src_xyz=src, rec_xyz=rec,
                     t_obs=_noisy(t_clean, dcfg.noise, dcfg.seed)), s_true)


def checkerboard3d_volume_dataset(grid: Grid, dcfg: DataCfg, mcfg: ModelCfg,
                                  eik: EikonalConfig = EikonalConfig(),
                                  device="cpu"):
    """3-D checkerboard with volume acquisition (recovery-capable). Returns
    ``(TomoData, s_true)``."""
    s_true = checkerboard_slowness(grid, dcfg.checker_cells,
                                   dcfg.checker_amplitude,
                                   mcfg.background_slowness, device=device)
    src, rec = volume3d_geometry(grid, dcfg.n_src, dcfg.n_rec, dcfg.seed,
                                 device=device)
    t_clean = predict_tomo(s_true, src, rec, grid, eik)
    return (TomoData(src_xyz=src, rec_xyz=rec,
                     t_obs=_noisy(t_clean, dcfg.noise, dcfg.seed)), s_true)


def _events(grid: Grid, dcfg: DataCfg, mcfg: ModelCfg, eik: EikonalConfig,
            sta: torch.Tensor, lo_frac: float, span: float, device):
    """Checkerboard truth, interior events drawn from ``seed + 1`` in
    ``[lo_frac, lo_frac + span]`` of the box per axis, station tables,
    noisy arrivals (noise seed ``seed + 2``). Returns
    ``(EventData, s_true, hypo_true, t0_true)``."""
    s_true = checkerboard_slowness(grid, dcfg.checker_cells,
                                   dcfg.checker_amplitude,
                                   mcfg.background_slowness, device=device)
    rng = np.random.default_rng(dcfg.seed + 1)
    lo = np.asarray(grid.origin)
    ext = np.asarray(grid.extent)
    hypo = torch.as_tensor(
        lo + ext * (lo_frac + span * rng.random((dcfg.n_events, grid.ndim))),
        dtype=torch.float32, device=device)
    t0 = torch.as_tensor(0.2 * rng.standard_normal(dcfg.n_events),
                         dtype=torch.float32, device=device)
    tables = traveltime_tables(s_true, sta, grid, eik)
    t_clean = predict_events(tables, hypo, t0, grid)
    return (EventData(sta_xyz=sta,
                      t_obs=_noisy(t_clean, dcfg.noise, dcfg.seed + 2)),
            s_true, hypo, t0)


def events_dataset(grid: Grid, dcfg: DataCfg, mcfg: ModelCfg,
                   eik: EikonalConfig = EikonalConfig(), device="cpu"):
    """Configs 3 and 5: surface stations observing interior earthquakes
    through a checkerboard truth."""
    sta = surface_array_geometry(grid, dcfg.n_stations, seed=dcfg.seed,
                                 device=device)
    return _events(grid, dcfg, mcfg, eik, sta, 0.15, 0.7, device)


def events_volume_dataset(grid: Grid, dcfg: DataCfg, mcfg: ModelCfg,
                          eik: EikonalConfig = EikonalConfig(), device="cpu"):
    """The joint problem with volume acquisition: stations on the free
    surface and two side faces (``volume3d_geometry``'s receivers), which
    close the depth-velocity trade-off of a surface-only net (the golden
    c3_joint_small problem)."""
    _, sta = volume3d_geometry(grid, 1, dcfg.n_stations, dcfg.seed,
                               device=device)
    return _events(grid, dcfg, mcfg, eik, sta, 0.2, 0.6, device)


def make_dataset(grid: Grid, dcfg: DataCfg, mcfg: ModelCfg,
                 eik: EikonalConfig = EikonalConfig(), device="cpu"):
    """Dispatch on ``DataCfg.dataset``; returns ``(data, truth_dict)``."""
    tomo = {"crosswell2d": crosswell_dataset,
            "checkerboard3d": checkerboard3d_dataset,
            "checkerboard3d_volume": checkerboard3d_volume_dataset}
    events = {"events3d": events_dataset,
              "events3d_volume": events_volume_dataset}
    if dcfg.dataset in tomo:
        data, s_true = tomo[dcfg.dataset](grid, dcfg, mcfg, eik, device)
        return data, {"slowness": s_true}
    if dcfg.dataset in events:
        data, s_true, hypo, t0 = events[dcfg.dataset](grid, dcfg, mcfg, eik,
                                                      device)
        return data, {"slowness": s_true, "hypo": hypo, "t0": t0}
    if dcfg.dataset == "file":
        from mceik_tpu_torch.io.loaders import load_dataset
        if not dcfg.path:
            raise ValueError('dataset="file" requires data.path')
        data, truth = load_dataset(dcfg.path, device=device)
        if ("slowness" in truth
                and tuple(truth["slowness"].shape) != tuple(grid.shape)):
            raise ValueError(
                f"{dcfg.path}: stored truth slowness "
                f"{tuple(truth['slowness'].shape)} != grid "
                f"{tuple(grid.shape)}")
        return data, truth
    if dcfg.dataset == "csv":
        from mceik_tpu_torch.io.loaders import load_events_csv
        if not (dcfg.stations_path and dcfg.arrivals_path):
            raise ValueError(
                'dataset="csv" requires data.stations_path and '
                'data.arrivals_path')
        return load_events_csv(dcfg.stations_path, dcfg.arrivals_path,
                               device=device), {}
    raise ValueError(f"unknown dataset {dcfg.dataset!r}")
