"""Build and load the port's CUDA kernels: ``nvcc`` at first use, ``ctypes``.

Each kernel source in ``mceik_tpu_torch/csrc/`` has a plain C entry point.
It is compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` (one shared
library per source, keyed by a hash of the source and the flags) and loaded
with ``ctypes``. Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

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


def max_plane_nodes(grid) -> int:
    """Nodes of the largest cross-section of an ``(nx, ny, nz)`` grid."""
    n0, n1, n2 = grid
    return max(n1 * n2, n0 * n2, n0 * n1)


def plane_smem(n_planes: int) -> Callable[[Tuple[int, ...]], int]:
    """Shared memory of a 3-D transport kernel that holds ``n_planes`` fp32
    buffers of the largest cross-section of an ``(nx, ny, nz)`` grid, each
    with a one-node halo (K4: 11, K5: 3; K1's formula is
    ``cuda_sweep.sweep3d_smem``)."""
    def smem(grid):
        n0, n1, n2 = grid
        return n_planes * 4 * max((n1 + 2) * (n2 + 2), (n0 + 2) * (n2 + 2),
                                  (n0 + 2) * (n1 + 2))
    return smem


def plane_limit(n_planes: int, max_nodes: int) -> str:
    """The largest square cross-section a 3-D transport kernel with
    ``n_planes`` haloed fp32 plane buffers in shared memory and at most
    ``max_nodes`` nodes per plane takes, as text for its error messages:
    eleven planes and 4096 nodes (K4) take 64^2, three planes and 20,480
    nodes (K5) 137^2."""
    side = min(math.isqrt(MAX_SMEM_BYTES // (4 * n_planes)) - 2,
               math.isqrt(max_nodes))
    return (f"{n_planes} fp32 planes with a one-node halo and at most "
            f"{max_nodes} nodes per plane ({max_nodes // MAX_THREADS} per "
            f"thread) take square cross-sections up to {side}^2 but not "
            f"{side + 1}^2")


def check_fields(name: str, fields, smem_bytes: Callable[[Tuple[int, ...]], int],
                 ndim: int = 3, limit: str = "",
                 max_nodes: Optional[int] = None) -> torch.device:
    """Validate a kernel's field operands before their pointers go to C:
    ``fields`` are ``(label, tensor)`` pairs that must all be contiguous
    fp32 CUDA tensors of one ``(B,) + grid`` shape with ``ndim`` grid axes
    on one device, ``smem_bytes(grid)``, the shared memory one block
    needs, must fit, and a 3-D grid's largest plane must have at most
    ``max_nodes`` nodes where that is given (``limit`` says what fits).
    Returns the device; raises ValueError."""
    ref = fields[0][1]
    dev = ref.device
    if ref.ndim != ndim + 1:
        axes = ("nx, ny, nz" if ndim == 3 else "n0, n1")
        raise ValueError(f"{name} kernel takes a (B, {axes}) batch, got "
                         f"shape {tuple(ref.shape)}")
    for label, x in fields:
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{label}: need float32 on {dev}, got "
                             f"{x.dtype} on {x.device}")
        if x.shape != ref.shape or not x.is_contiguous():
            raise ValueError(f"{label}: need a contiguous {tuple(ref.shape)} "
                             f"tensor, got {tuple(x.shape)}")
    grid = tuple(ref.shape[1:])
    need = smem_bytes(grid)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"grid {grid}: {name} needs {need} bytes of shared "
                         f"memory per block, more than {MAX_SMEM_BYTES}"
                         + (f": {limit}" if limit else ""))
    if max_nodes is not None and max_plane_nodes(grid) > max_nodes:
        raise ValueError(f"grid {grid}: {name} takes planes of at most "
                         f"{max_nodes} nodes, not {max_plane_nodes(grid)}"
                         + (f": {limit}" if limit else ""))
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {dev}")
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


# The longest line a 2-D kernel (K3, K6) holds in one warp: 32 lanes of at
# most 32 nodes.
MAX_LINE = 1024


def row_stride(n1: int) -> int:
    """The padded row stride in shared memory: ``n1`` rounded up to an odd
    number of floats, so that 32 consecutive nodes of a column fall in 32
    distinct banks (see the design note in ``csrc/sweep2d.cu``)."""
    return n1 | 1


def check_line(name: str, grid: Tuple[int, ...]) -> None:
    """Refuse a grid whose longest line one warp cannot hold."""
    if max(grid, default=0) > MAX_LINE:
        raise ValueError(f"grid {tuple(grid)}: {name} holds a line in one "
                         f"warp, at most {MAX_LINE} nodes")


class FieldCycles:
    """The cycles a kernel's launches ran, summed over fields by the kernel
    itself (one atomic add per field into a counter on each device), so
    that reading them costs no sync until :meth:`field_cycles`."""

    def __init__(self):
        self._counters = {}

    def counter(self, dev: torch.device) -> torch.Tensor:
        key = dev.index if dev.index is not None else torch.cuda.current_device()
        if key not in self._counters:
            self._counters[key] = torch.zeros(1, dtype=torch.int64, device=dev)
        return self._counters[key]

    def field_cycles(self) -> int:
        """Cycles run so far, summed over every field of every launch."""
        return sum(int(c.item()) for c in self._counters.values())


def launch_threads(shape) -> int:
    """Threads of a one-CTA-per-field launch over a ``(B,) + grid`` batch:
    one per node of the largest plane of a 3-D grid, one per node of the
    longest line of a 2-D grid, rounded up to whole warps."""
    grid = tuple(shape[1:])
    nodes = max_plane_nodes(grid) if len(grid) == 3 else max(grid)
    return min(MAX_THREADS, (nodes + 31) // 32 * 32)


def launch_config(shape, dev: torch.device):
    """``(threads per block, device index, stream)`` for a one-CTA-per-field
    launch over a ``(B,) + grid`` batch."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return (launch_threads(shape), index,
            torch.cuda.current_stream(dev).cuda_stream)


_SOURCE_LOCKS = {}
_SOURCE_LOCKS_GUARD = threading.Lock()


def _source_lock(source: Path) -> threading.Lock:
    """One lock per source, so that two entry points of one source build it
    once."""
    with _SOURCE_LOCKS_GUARD:
        return _SOURCE_LOCKS.setdefault(source, threading.Lock())


class NvccKernel:
    """One C entry point of a kernel source, bound once built, and its
    launch count.

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

    def build(self):
        """Compile (once per source hash) and load; returns the bound C
        entry point. Safe to call from several threads: two sources build in
        parallel, one source once."""
        with _source_lock(self.source):
            if self._fn is not None:
                return self._fn
            t0 = time.perf_counter()
            # The headers of csrc/ go into the key too: a source may
            # include them.
            digest = hashlib.sha256(
                self.source.read_bytes()
                + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            lib_path = BUILD_DIR / f"{self.source.stem}_{digest}.so"
            if not lib_path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_name(
                    f"{lib_path.stem}.{os.getpid()}.{threading.get_ident()}"
                    ".tmp.so")
                proc = subprocess.run(
                    [_nvcc(self.source), *NVCC_FLAGS, "-I", str(CSRC),
                     "-o", str(tmp), str(self.source)],
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
