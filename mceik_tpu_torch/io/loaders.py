"""Observed-data ingestion: datasets and slowness models from files, and
station/arrival tables from CSV.

Counterpart of ``mceik_tpu/io/loaders.py``. Three on-disk forms, the format
following the file's extension:

- **HDF5** (``.h5``, ``.hdf5``), the reference's self-describing files:
  root attr ``kind`` in {"tomo", "events"}; datasets per kind (tomo:
  ``src_xyz``/``rec_xyz``/``t_obs``[/``mask``]; events:
  ``sta_xyz``/``t_obs``[/``mask``]), plus an optional ``slowness`` field
  with ``spacing``/``origin`` attrs and extras such as ``hypo`` and
  ``t0``. These need ``h5py``, imported where a file is read or written;
  without it they raise an ``ImportError`` naming ``h5py`` and the
  ``.pt`` form. They never switch format on their own.
- **torch** (``.pt``): one flat dict written by ``torch.save``: the
  ``kind`` ("tomo", "events" or "slowness"), the same arrays as CPU
  tensors under the same names, and the grid's ``spacing`` and ``origin``
  as lists of floats. Read with ``torch.load(..., weights_only=True)``.
- **CSV** station + arrival tables: ``stations.csv`` with header
  ``station,x,y[,z]`` and ``arrivals.csv`` with header
  ``event,station,time``. Missing (event, station) pairs become
  ``mask = 0`` entries, so ragged pick sets go through the masked
  likelihood as they are.

Every write goes to ``path + ".tmp"`` and is renamed over ``path``
(atomic). Loaded data are tensors on the requested device.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mceik_tpu_torch.grid import Grid
from mceik_tpu_torch.model.data import EventData, TomoData

HDF5_SUFFIXES = (".h5", ".hdf5")


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "h5py is not installed: reading or writing .h5 files needs h5py; "
            "use the torch-native .pt format instead (save_dataset / "
            "save_slowness with a .pt path)") from e
    return h5py


def _np(x, dtype=np.float32) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _cpu(x, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(_np(x), dtype=dtype).contiguous()


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _format(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext in HDF5_SUFFIXES:
        return "hdf5"
    if ext == ".pt":
        return "pt"
    raise ValueError(f"{path}: unknown file format {ext!r} (expected "
                     f"{', '.join(HDF5_SUFFIXES)} or .pt)")


def _atomic_target(path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return path + ".tmp"


def _torch_save(obj, path: str) -> None:
    tmp = _atomic_target(path)
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _torch_load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _build_data(kind, get, path, device):
    """(data, truth) from the arrays ``get(name)`` (None when absent)."""
    t_obs = _t(get("t_obs"), device)
    mask = get("mask")
    mask = _t(mask, device) if mask is not None else None
    truth: Dict[str, torch.Tensor] = {}
    for k in ("slowness", "hypo", "t0"):
        v = get(k)
        if v is not None:
            truth[k] = torch.as_tensor(np.asarray(v), device=device)
    if kind == "tomo":
        data = TomoData(src_xyz=_t(get("src_xyz"), device),
                        rec_xyz=_t(get("rec_xyz"), device),
                        t_obs=t_obs, mask=mask)
    elif kind == "events":
        data = EventData(sta_xyz=_t(get("sta_xyz"), device), t_obs=t_obs,
                         mask=mask)
    else:
        raise ValueError(
            f"{path}: missing/unknown 'kind' attr {kind!r} "
            "(expected 'tomo' or 'events')")
    return data, truth


def _dataset_arrays(data) -> Tuple[str, Dict[str, np.ndarray]]:
    if isinstance(data, TomoData):
        kind = "tomo"
        arrays = {"src_xyz": _np(data.src_xyz), "rec_xyz": _np(data.rec_xyz)}
    elif isinstance(data, EventData):
        kind = "events"
        arrays = {"sta_xyz": _np(data.sta_xyz)}
    else:
        raise TypeError(f"unsupported dataset type {type(data).__name__}")
    arrays["t_obs"] = _np(data.t_obs)
    if data.mask is not None:
        arrays["mask"] = _np(data.mask)
    return kind, arrays


def _check_slowness(path, s_shape, spacing, expect_grid: Optional[Grid]):
    if expect_grid is None:
        return
    if tuple(s_shape) != tuple(expect_grid.shape):
        raise ValueError(f"{path}: slowness shape {tuple(s_shape)} != grid "
                         f"{tuple(expect_grid.shape)}")
    if spacing is not None and not np.allclose(spacing, expect_grid.spacing):
        raise ValueError(f"{path}: slowness spacing {spacing} != grid "
                         f"{expect_grid.spacing}")


# ---------------------------------------------------------------------------
# HDF5 (the reference's files; needs h5py)
# ---------------------------------------------------------------------------

def save_dataset_hdf5(path: str, data, slowness=None,
                      grid: Optional[Grid] = None,
                      extra: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write a TomoData/EventData (and optionally a slowness model) as the
    reference's HDF5 file, atomically."""
    h5py = _h5py()
    kind, arrays = _dataset_arrays(data)
    tmp = _atomic_target(path)
    with h5py.File(tmp, "w") as f:
        f.attrs["kind"] = kind
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
        if slowness is not None:
            ds = f.create_dataset("slowness", data=_np(slowness))
            if grid is not None:
                ds.attrs["spacing"] = np.asarray(grid.spacing, np.float64)
                ds.attrs["origin"] = np.asarray(grid.origin, np.float64)
        for k, v in (extra or {}).items():
            f.create_dataset(k, data=_np(v, None))
    os.replace(tmp, path)


def load_dataset_hdf5(path: str, device="cpu"):
    """Load ``(data, truth)`` from an HDF5 dataset; ``truth`` carries the
    stored slowness model and any ``hypo``/``t0`` extras."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        kind = f.attrs.get("kind")
        return _build_data(kind, lambda k: np.asarray(f[k]) if k in f
                           else None, path, device)


def save_slowness_hdf5(path: str, slowness, grid: Grid) -> None:
    """A standalone slowness-model file (locate mode's fixed model)."""
    h5py = _h5py()
    tmp = _atomic_target(path)
    with h5py.File(tmp, "w") as f:
        ds = f.create_dataset("slowness", data=_np(slowness))
        ds.attrs["spacing"] = np.asarray(grid.spacing, np.float64)
        ds.attrs["origin"] = np.asarray(grid.origin, np.float64)
    os.replace(tmp, path)


def load_slowness_hdf5(path: str, expect_grid: Optional[Grid] = None,
                       device="cpu") -> torch.Tensor:
    """Load a slowness field, its geometry checked against
    ``expect_grid``."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        ds = f["slowness"]
        s = np.asarray(ds, np.float32)
        _check_slowness(path, s.shape, ds.attrs.get("spacing"), expect_grid)
    return torch.as_tensor(s, device=device)


# ---------------------------------------------------------------------------
# torch-native .pt
# ---------------------------------------------------------------------------

def save_dataset_pt(path: str, data, slowness=None,
                    grid: Optional[Grid] = None,
                    extra: Optional[Dict[str, np.ndarray]] = None) -> None:
    """The same content as :func:`save_dataset_hdf5`, as a ``.pt`` dict."""
    kind, arrays = _dataset_arrays(data)
    obj = {"kind": kind, **{k: _cpu(v) for k, v in arrays.items()}}
    if slowness is not None:
        obj["slowness"] = _cpu(slowness)
        if grid is not None:
            obj["spacing"] = list(grid.spacing)
            obj["origin"] = list(grid.origin)
    for k, v in (extra or {}).items():
        obj[k] = torch.as_tensor(_np(v, None)).contiguous()
    _torch_save(obj, path)


def load_dataset_pt(path: str, device="cpu"):
    """Load ``(data, truth)`` from a ``.pt`` dataset."""
    obj = _torch_load(path)
    return _build_data(obj.get("kind"), lambda k: (
        obj[k].numpy() if isinstance(obj.get(k), torch.Tensor) else None),
        path, device)


def save_slowness_pt(path: str, slowness, grid: Grid) -> None:
    _torch_save({"kind": "slowness", "slowness": _cpu(slowness),
                 "spacing": list(grid.spacing), "origin": list(grid.origin)},
                path)


def load_slowness_pt(path: str, expect_grid: Optional[Grid] = None,
                     device="cpu") -> torch.Tensor:
    obj = _torch_load(path)
    s = obj["slowness"].to(torch.float32)
    _check_slowness(path, s.shape, obj.get("spacing"), expect_grid)
    return s.to(device)


# ---------------------------------------------------------------------------
# By extension
# ---------------------------------------------------------------------------

def save_dataset(path: str, data, slowness=None, grid: Optional[Grid] = None,
                 extra: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write a dataset as HDF5 or ``.pt``, by ``path``'s extension."""
    fn = save_dataset_hdf5 if _format(path) == "hdf5" else save_dataset_pt
    fn(path, data, slowness=slowness, grid=grid, extra=extra)


def load_dataset(path: str, device="cpu"):
    """``(data, truth)`` from an HDF5 or ``.pt`` dataset, by extension."""
    fn = load_dataset_hdf5 if _format(path) == "hdf5" else load_dataset_pt
    return fn(path, device=device)


def save_slowness(path: str, slowness, grid: Grid) -> None:
    fn = save_slowness_hdf5 if _format(path) == "hdf5" else save_slowness_pt
    fn(path, slowness, grid)


def load_slowness(path: str, expect_grid: Optional[Grid] = None,
                  device="cpu") -> torch.Tensor:
    fn = load_slowness_hdf5 if _format(path) == "hdf5" else load_slowness_pt
    return fn(path, expect_grid, device=device)


# ---------------------------------------------------------------------------
# CSV station/arrival tables
# ---------------------------------------------------------------------------

def load_stations_csv(path: str) -> Tuple[list, np.ndarray]:
    """``station,x,y[,z]`` -> (names, xyz(n_sta, D)); order = file order."""
    names, rows = [], []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        cols = [c for c in ("x", "y", "z") if c in reader.fieldnames]
        if "station" not in reader.fieldnames or len(cols) < 2:
            raise ValueError(
                f"{path}: need header 'station,x,y[,z]', got "
                f"{reader.fieldnames}")
        for row in reader:
            names.append(row["station"])
            rows.append([float(row[c]) for c in cols])
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: duplicate station names")
    return names, np.asarray(rows, np.float32)


def load_arrivals_csv(path: str, station_names: list
                      ) -> Tuple[list, np.ndarray, np.ndarray]:
    """``event,station,time`` -> (event_ids, t_obs(n_ev, n_sta), mask).

    Events ordered by first appearance; stations resolved against
    ``station_names``; missing picks get mask=0 (t_obs entry 0.0, never
    read through the masked likelihood).
    """
    sta_index = {s: j for j, s in enumerate(station_names)}
    events: list = []
    ev_index: Dict[str, int] = {}
    picks = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        need = {"event", "station", "time"}
        if not need.issubset(set(reader.fieldnames or ())):
            raise ValueError(
                f"{path}: need header 'event,station,time', got "
                f"{reader.fieldnames}")
        for row in reader:
            ev = row["event"]
            sta = row["station"]
            if sta not in sta_index:
                raise ValueError(f"{path}: unknown station {sta!r}")
            if ev not in ev_index:
                ev_index[ev] = len(events)
                events.append(ev)
            picks.append((ev_index[ev], sta_index[sta], float(row["time"])))
    n_ev, n_sta = len(events), len(station_names)
    t_obs = np.zeros((n_ev, n_sta), np.float32)
    mask = np.zeros((n_ev, n_sta), np.float32)
    for i, j, t in picks:
        if mask[i, j]:
            raise ValueError(
                f"{path}: duplicate pick for event {events[i]!r} / "
                f"station {station_names[j]!r}")
        t_obs[i, j] = t
        mask[i, j] = 1.0
    return events, t_obs, mask


def load_events_csv(stations_path: str, arrivals_path: str,
                    device="cpu") -> EventData:
    """Station + arrival CSV tables -> EventData (masked) on ``device``."""
    names, sta_xyz = load_stations_csv(stations_path)
    _, t_obs, mask = load_arrivals_csv(arrivals_path, names)
    return EventData(sta_xyz=_t(sta_xyz, device), t_obs=_t(t_obs, device),
                     mask=_t(mask, device))


def save_events_csv(stations_path: str, arrivals_path: str,
                    data: EventData) -> None:
    """Write EventData out as the CSV pair (round trip of
    :func:`load_events_csv`)."""
    sta = _np(data.sta_xyz)
    t_obs = _np(data.t_obs)
    mask = _np(data.mask) if data.mask is not None else np.ones_like(t_obs)
    cols = ["x", "y", "z"][:sta.shape[1]]
    with open(stations_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["station"] + cols)
        for j in range(sta.shape[0]):
            w.writerow([f"STA{j:03d}"] + [repr(float(v)) for v in sta[j]])
    with open(arrivals_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["event", "station", "time"])
        for i in range(t_obs.shape[0]):
            for j in range(t_obs.shape[1]):
                if mask[i, j]:
                    w.writerow([f"EV{i:04d}", f"STA{j:03d}",
                                repr(float(t_obs[i, j]))])
