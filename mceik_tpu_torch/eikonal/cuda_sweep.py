"""CUDA sweep kernel K1: build, bind and launch ``csrc/sweep3d.cu``.

Counterpart of ``mceik_tpu/eikonal/pallas_sweep.py``. One launch runs one
full sweep cycle (axes 0, 1, 2, each forward then backward) on every field
of a ``(B, nx, ny, nz)`` fp32 batch whose done flag is clear; it replaces
the Pallas kernel ``sweep_axes012_fused`` (pallas_sweep.py:372). The design
note is in the CUDA source.

The kernel is compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` (keyed by a hash of the source and flags) and loaded with
``ctypes``. Nothing is imported or built when this module is imported.

:func:`sweep_cycle` launches the kernel for CUDA tensors and runs the plain
version, ``solve.sweep_cycle_plain``, for CPU tensors; there is no other
fallback. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

from mceik_tpu_torch.eikonal.solve import sweep_cycle_plain

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "sweep3d.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# Dynamic shared memory one block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448
MAX_THREADS = 1024


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found (looked on PATH and at {path}): the CUDA sweep "
            f"kernel is built from {SOURCE} at first use")
    return path


class Sweep3dKernel:
    """The built kernel and its launch count.

    ``launches`` is a plain integer that grows by one per kernel launch and
    nowhere else, so a run can show that its solves went through the kernel.
    """

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
        self._fn = None
        self._lock = threading.Lock()

    def build(self):
        """Compile (once per source hash) and load the kernel; returns the
        bound C entry point."""
        with self._lock:
            if self._fn is not None:
                return self._fn
            t0 = time.perf_counter()
            digest = hashlib.sha256(
                SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
            ).hexdigest()[:16]
            lib_path = BUILD_DIR / f"sweep3d_{digest}.so"
            if not lib_path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {SOURCE} (rc {proc.returncode}):\n"
                        f"{self.build_log}")
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            fn = lib.sweep3d_cycle
            vp, ci = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp, ci, ci, ci, ci, vp]
            fn.restype = ci
            self._fn = fn
            self.build_seconds = time.perf_counter() - t0
            return fn

    def __call__(self, T: torch.Tensor, s: torch.Tensor, floor: torch.Tensor,
                 spacing: Sequence[float], n_inner: int,
                 done: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One cycle on a copy of ``T``; returns the swept batch."""
        dev = T.device
        if dev.type != "cuda":
            raise ValueError(f"sweep3d kernel needs CUDA tensors, got {dev}")
        if T.ndim != 4:
            raise ValueError(
                f"sweep3d kernel takes a (B, nx, ny, nz) batch, got shape "
                f"{tuple(T.shape)}")
        for name, x in (("T", T), ("s", s), ("floor", floor)):
            if x.device != dev or x.dtype != torch.float32:
                raise ValueError(f"{name}: need float32 on {dev}, got "
                                 f"{x.dtype} on {x.device}")
            if x.shape != T.shape or not x.is_contiguous():
                raise ValueError(f"{name}: need a contiguous {tuple(T.shape)} "
                                 f"tensor, got {tuple(x.shape)}")
        B, n0, n1, n2 = T.shape
        if done is None:
            done = torch.zeros(B, dtype=torch.bool, device=dev)
        if (done.device != dev or done.dtype != torch.bool
                or done.shape != (B,) or not done.is_contiguous()):
            raise ValueError(f"done: need a contiguous bool ({B},) tensor on {dev}")
        if len(spacing) != 3 or n_inner < 0:
            raise ValueError(f"bad spacing {spacing} or n_inner {n_inner}")
        max_plane = max(n1 * n2, n0 * n2, n0 * n1)
        if 3 * 4 * max_plane > MAX_SMEM_BYTES:
            raise ValueError(
                f"grid {(n0, n1, n2)}: three fp32 plane buffers of "
                f"{max_plane} nodes exceed {MAX_SMEM_BYTES} bytes of shared "
                f"memory")
        fn = self.build()
        out = T.clone()
        if B == 0:
            return out
        h = [float(x) for x in spacing]
        consts = (ctypes.c_float * 9)(*h, *[x * x for x in h],
                                      *[1.0 / (x * x) for x in h])
        iso = int(len(set(h)) == 1)
        threads = min(MAX_THREADS, (max_plane + 31) // 32 * 32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(out.data_ptr(), s.data_ptr(), floor.data_ptr(),
                done.data_ptr(), B, n0, n1, n2, consts, iso, int(n_inner),
                threads, dev.index if dev.index is not None
                else torch.cuda.current_device(), stream)
        if rc != 0:
            raise RuntimeError(f"sweep3d_cycle launch failed: CUDA error {rc}")
        self.launches += 1
        return out


SWEEP3D = Sweep3dKernel()


def sweep_cycle(T: torch.Tensor, s: torch.Tensor, floor: torch.Tensor,
                spacing: Sequence[float], n_inner: int,
                done: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One full sweep cycle on the fields whose ``done`` flag is clear.

    CUDA tensors go to the kernel; CPU tensors to the plain version
    (``solve.sweep_cycle_plain``). Any other device raises.
    """
    if T.device.type == "cpu":
        return sweep_cycle_plain(T, s, floor, spacing, n_inner, done)
    if T.device.type == "cuda":
        if T.ndim != 4:
            raise NotImplementedError(
                "2-D fields on CUDA need the 2-D sweep kernel (K3), which "
                "is slice 2 of the port")
        return SWEEP3D(T, s, floor, spacing, n_inner, done)
    raise ValueError(f"no sweep for device {T.device}")
