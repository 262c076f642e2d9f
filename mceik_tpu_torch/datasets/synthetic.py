"""Synthetic truth model, acquisition geometry and noisy arrivals for the
3-D checkerboard workload (config 2).

Counterpart of the checkerboard3d pieces of
``mceik_tpu/datasets/synthetic.py``. The noise comes from a CPU
``torch.Generator`` seeded with ``data.seed``, so a dataset is the same on
every device (it is not JAX's noise: parity tests carry the JAX package's
arrays across with ``convert.tomo_data_from_jax``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from mceik_tpu_torch.config import DataCfg, ModelCfg
from mceik_tpu_torch.eikonal.solve import EikonalConfig
from mceik_tpu_torch.forward.predict import predict_tomo
from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.data import TomoData


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
    gen = torch.Generator().manual_seed(dcfg.seed)
    noise = torch.randn(tuple(t_clean.shape), generator=gen,
                        dtype=torch.float32).to(device)
    t_obs = t_clean + dcfg.noise * noise
    return TomoData(src_xyz=src, rec_xyz=rec, t_obs=t_obs), s_true


def make_dataset(grid: Grid, dcfg: DataCfg, mcfg: ModelCfg,
                 eik: EikonalConfig = EikonalConfig(), device="cpu"):
    """Dispatch on ``DataCfg.dataset``; returns ``(data, truth_dict)``."""
    if dcfg.dataset == "checkerboard3d":
        data, s_true = checkerboard3d_dataset(grid, dcfg, mcfg, eik, device)
        return data, {"slowness": s_true}
    later = {"crosswell2d": "slice 3", "checkerboard3d_volume": "slice 4",
             "events3d": "slice 4", "events3d_volume": "slice 4",
             "file": "slice 5", "csv": "slice 5"}
    if dcfg.dataset in later:
        raise NotImplementedError(
            f"dataset {dcfg.dataset!r} is {later[dcfg.dataset]} of the port")
    raise ValueError(f"unknown dataset {dcfg.dataset!r}")
