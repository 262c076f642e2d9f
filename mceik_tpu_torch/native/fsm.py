"""ctypes binding of the serial C++ fast-sweeping solver ``native/fsm.cc``.

Counterpart of ``mceik_tpu/native/fsm.py``, taking the port's ``Grid``. The
solver is an independent implementation of the same discrete Godunov fixed
point (serial Gauss-Seidel sweeps in fp64 on the host), so it is the oracle
the batched solves and the kernels are held to. It is compiled by ``g++``
at first use into ``build/native/``, one library per hash of the source
and the flags (delete the directory to force a rebuild); nothing is built
when this module is imported. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from mceik_tpu_torch.grid import Grid

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "fsm.cc"
BUILD_DIR = _REPO / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"fsm_{digest}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE} (rc {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.fsm_solve.restype = ctypes.c_int
        lib.fsm_solve.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
        return lib


def have_native() -> bool:
    """Whether the library builds and loads here (for tests to skip on)."""
    try:
        _load()
        return True
    except Exception:
        return False


def fsm_solve(slowness, src_xyz, grid: Grid, seed_radius: float = 3.0,
              tol: float = 1e-6, max_passes: int = 100):
    """Serial Gauss-Seidel fast-sweeping solve of one field on the host from
    the physical source ``src_xyz``. ``slowness``: a grid-shaped array or
    tensor. Returns ``(T, n_passes)``, T a float32 numpy array."""
    lib = _load()
    if hasattr(slowness, "detach"):
        slowness = slowness.detach().cpu().numpy()
    if hasattr(src_xyz, "detach"):
        src_xyz = src_xyz.detach().cpu().numpy()
    s = np.ascontiguousarray(np.asarray(slowness, dtype=np.float32))
    if s.shape != tuple(grid.shape):
        raise ValueError(f"slowness {s.shape} != grid {tuple(grid.shape)}")
    shape = np.asarray(grid.shape, dtype=np.int64)
    spacing = np.asarray(grid.spacing, dtype=np.float64)
    src = (np.asarray(src_xyz, dtype=np.float64)
           - np.asarray(grid.origin, dtype=np.float64))
    out = np.empty(tuple(grid.shape), dtype=np.float32)
    n_passes = lib.fsm_solve(
        grid.ndim,
        shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        spacing.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        float(seed_radius), float(tol), int(max_passes),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if n_passes < 0:
        raise RuntimeError("fsm_solve failed")
    return out, n_passes
