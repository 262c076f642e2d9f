"""Build and load the port's CUDA kernels: ``nvcc`` at first use, ``ctypes``.

Each kernel source in ``mceik_tpu_torch/csrc/`` has a plain C entry point.
It is compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` (one shared
library per source, keyed by a hash of the source and the flags) and loaded
with ``ctypes``. Nothing is built or loaded when this module is imported.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# Dynamic shared memory one block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448
MAX_THREADS = 1024


def _nvcc(source: Path) -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found (looked on PATH and at {path}): the CUDA kernel "
            f"is built from {source} at first use")
    return path


def check_fields(name: str, fields, n_planes: int) -> torch.device:
    """Validate a kernel's field operands before their pointers go to C:
    ``fields`` are ``(label, tensor)`` pairs that must all be contiguous
    fp32 ``(B, nx, ny, nz)`` CUDA tensors of one shape on one device, and
    ``n_planes`` fp32 planes of the largest cross-section must fit in a
    block's shared memory. Returns the device; raises ValueError."""
    ref = fields[0][1]
    dev = ref.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {dev}")
    if ref.ndim != 4:
        raise ValueError(f"{name} kernel takes a (B, nx, ny, nz) batch, got "
                         f"shape {tuple(ref.shape)}")
    for label, x in fields:
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{label}: need float32 on {dev}, got "
                             f"{x.dtype} on {x.device}")
        if x.shape != ref.shape or not x.is_contiguous():
            raise ValueError(f"{label}: need a contiguous {tuple(ref.shape)} "
                             f"tensor, got {tuple(x.shape)}")
    _, n0, n1, n2 = ref.shape
    max_plane = max(n1 * n2, n0 * n2, n0 * n1)
    if n_planes * 4 * max_plane > MAX_SMEM_BYTES:
        raise ValueError(
            f"grid {(n0, n1, n2)}: {n_planes} fp32 plane buffers of "
            f"{max_plane} nodes exceed {MAX_SMEM_BYTES} bytes of shared "
            f"memory")
    return dev


def done_flags(done: Optional[torch.Tensor], B: int,
               dev: torch.device) -> torch.Tensor:
    """The per-field done flags a kernel takes (all clear by default)."""
    if done is None:
        return torch.zeros(B, dtype=torch.bool, device=dev)
    if (done.device != dev or done.dtype != torch.bool
            or done.shape != (B,) or not done.is_contiguous()):
        raise ValueError(f"done: need a contiguous bool ({B},) tensor on {dev}")
    return done


def launch_config(shape, dev: torch.device):
    """``(threads per block, device index, stream)`` for a one-CTA-per-field
    launch over a ``(B, nx, ny, nz)`` batch."""
    _, n0, n1, n2 = shape
    max_plane = max(n1 * n2, n0 * n2, n0 * n1)
    threads = min(MAX_THREADS, (max_plane + 31) // 32 * 32)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return threads, index, torch.cuda.current_stream(dev).cuda_stream


class NvccKernel:
    """One kernel source, its C entry point once built, and its launch count.

    ``launches`` is a plain integer that the wrapper raises by one per kernel
    launch and nowhere else, so a run can show that it went through the
    kernel.
    """

    def __init__(self, source: Path, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self.build_seconds = 0.0
        self._fn = None
        self._lock = threading.Lock()

    def build(self):
        """Compile (once per source hash) and load; returns the bound C
        entry point. Safe to call from several threads: two kernels build in
        parallel, one kernel once."""
        with self._lock:
            if self._fn is not None:
                return self._fn
            t0 = time.perf_counter()
            digest = hashlib.sha256(
                self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
            ).hexdigest()[:16]
            lib_path = BUILD_DIR / f"{self.source.stem}_{digest}.so"
            if not lib_path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_name(
                    f"{lib_path.stem}.{os.getpid()}.{threading.get_ident()}"
                    ".tmp.so")
                proc = subprocess.run(
                    [_nvcc(self.source), *NVCC_FLAGS, "-o", str(tmp),
                     str(self.source)],
                    capture_output=True, text=True)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {self.source} (rc {proc.returncode}):"
                        f"\n{self.build_log}")
                os.replace(tmp, lib_path)
            fn = getattr(ctypes.CDLL(str(lib_path)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
            self.build_seconds = time.perf_counter() - t0
            return fn
