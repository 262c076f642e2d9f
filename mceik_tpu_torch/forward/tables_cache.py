"""On-disk cache of station traveltime tables.

Counterpart of ``mceik_tpu/forward/tables_cache.py``, with ``.pt`` files in
place of HDF5. In-memory batched solves are the hot path; the disk cache
serves locate workflows that reuse one velocity model across many event
batches. The key hashes the grid geometry, the solver config, the station
coordinates and the slowness field (the reference's key, so both packages
name the same inputs alike), so a stale model can never serve wrong
tables. A miss solves through ``forward.predict.traveltime_tables``: on the
card, K1 for 3-D grids and K3 for 2-D ones.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

from mceik_tpu_torch.eikonal.solve import EikonalConfig
from mceik_tpu_torch.forward import predict
from mceik_tpu_torch.grid import Grid


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, np.float32))


def _table_key(slowness, sta_xyz, grid: Grid, config: EikonalConfig) -> str:
    h = hashlib.sha256()
    h.update(repr((grid.shape, grid.spacing, grid.origin)).encode())
    h.update(repr((config.method, config.tol, config.max_iters,
                   config.n_inner, config.seed_radius)).encode())
    h.update(_np32(sta_xyz).tobytes())
    h.update(_np32(slowness).tobytes())
    return h.hexdigest()[:16]


def cached_traveltime_tables(slowness: torch.Tensor, sta_xyz: torch.Tensor,
                             grid: Grid,
                             config: EikonalConfig = EikonalConfig(),
                             cache_dir: Optional[str] = None) -> torch.Tensor:
    """Compute (or load) per-station traveltime tables
    ``(n_sta,) + grid.shape`` on ``slowness``'s device.

    With ``cache_dir`` set, tables are stored as ``tables_{key}.pt`` (a
    dict with ``tables``, ``key`` and ``n_sta``, written to a tmp file and
    renamed) and a later call with the same inputs loads them and solves
    nothing."""
    if cache_dir is None:
        return predict.traveltime_tables(slowness, sta_xyz, grid, config)

    key = _table_key(slowness, sta_xyz, grid, config)
    path = os.path.join(cache_dir, f"tables_{key}.pt")
    if os.path.exists(path):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        return obj["tables"].to(slowness.device)

    tables = predict.traveltime_tables(slowness, sta_xyz, grid, config)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"tables": tables.detach().cpu().contiguous(), "key": key,
                "n_sta": int(tables.shape[0])}, tmp)
    os.replace(tmp, path)
    return tables
