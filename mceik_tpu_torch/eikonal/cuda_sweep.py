"""CUDA sweep kernel K1: build, bind and launch ``csrc/sweep3d.cu``; and the
sweep dispatch of every batch to its kernel (K1 for 3-D fields, K3,
``eikonal/cuda_sweep2d.py``, for 2-D fields; both compute the seed floor in
the kernel from the source scalars).

Counterpart of ``mceik_tpu/eikonal/pallas_sweep.py``. One launch runs one
full sweep cycle (axes 0, 1, 2, each forward then backward) on every field
of a ``(B, nx, ny, nz)`` fp32 batch whose done flag is clear. It replaces
the Pallas kernel ``sweep_axes012_fused`` (pallas_sweep.py:372) on cube
grids, on config 3's non-cube route (n_x == n_y, 48x48x32) the pair
``sweep_axes01_fused`` (pallas_sweep.py:222, call :230) + ``sweep_axis0``
on axis 2 (:132, call :139) that ``sweep_cycle_pallas_packed`` takes
there, ``sweep_axis0`` on the blocked 128^3 route, and
``sweep_axis0_gridbatch`` (pallas_sweep.py:740, call :762) on the
``impl="gridbatch"`` route: every 3-D route of ``solve_eikonal_batched``
but the plain one launches it. The design notes are in the CUDA source.

The kernel is compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` and loaded with ``ctypes`` (``eikonal/cuda_build.py``).
Nothing is built when this module is imported.

:func:`seeded_cycle` launches K1 or K3's cycle for CUDA tensors and runs
the plain version, ``solve.sweep_seeded_cycle_plain``, for CPU tensors;
:func:`solve` runs a whole solve: K3's solve entry on CUDA 2-D batches (one
launch), else the host loop ``solve.sweep_solve`` around
:func:`seeded_cycle`. There is no other fallback. A failed build or launch
raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Sequence

import torch

from mceik_tpu_torch.eikonal.cuda_build import (CSRC, MAX_SMEM_BYTES,
                                                MAX_THREADS, FieldCycles,
                                                NvccKernel, check_fields,
                                                done_flags, launch_config,
                                                launch_threads)
from mceik_tpu_torch.eikonal.cuda_sweep2d import SWEEP2D
from mceik_tpu_torch.eikonal.solve import (sweep_seeded_cycle_plain,
                                           sweep_solve)

SOURCE = CSRC / "sweep3d.cu"
# Nodes per thread up to which K1 keeps T, s and the floor in registers and
# two shared planes (the exchange buffer); above, s takes a third plane.
REG_NODES = 4
# Shared memory of one warp's 32 x 33 fp32 transposition tile.
TILE_BYTES = 32 * 33 * 4


def sweep3d_smem(grid) -> int:
    """K1's shared memory per block for an ``(nx, ny, nz)`` grid: up to
    ``REG_NODES`` nodes per thread (planes up to 4096 nodes) the largest
    plane with a one-node halo, double-buffered; above, three planes (the
    third is the staged s); or, where that is less, one transposition
    tile per warp (132 KB at 1024 threads), which reuses the same memory
    between the marches."""
    n0, n1, n2 = grid
    plane = max(n1 * n2, n0 * n2, n0 * n1)
    if plane <= REG_NODES * MAX_THREADS:
        planes = 2 * 4 * max((n1 + 2) * (n2 + 2), (n0 + 2) * (n2 + 2),
                             (n0 + 2) * (n1 + 2))
    else:
        planes = 3 * 4 * plane
    return max(planes, launch_threads((1,) + tuple(grid)) // 32 * TILE_BYTES)


def sweep3d_limit() -> str:
    """The largest cross-section K1 takes, as text for its error message."""
    nodes = MAX_SMEM_BYTES // 12
    side = math.isqrt(nodes)
    return (f"K1 holds 2 fp32 planes up to {REG_NODES * MAX_THREADS} nodes "
            f"per plane and 3 above, so cross-sections of at most {nodes} "
            f"nodes ({side}^2 but not {side + 1}^2); a larger one needs a "
            "thread-block-cluster kernel, later work")


class Sweep3dKernel(NvccKernel, FieldCycles):
    """K1 built from ``csrc/sweep3d.cu`` (or ``source``), with its launch
    count and its field-cycles (one per field not done, per launch, counted
    by the kernel)."""

    def __init__(self, source: Path = SOURCE):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        NvccKernel.__init__(self, source, "sweep3d_cycle",
                            [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp, ci,
                             ci, ctypes.c_float, ci, ci, vp])
        FieldCycles.__init__(self)

    def __call__(self, T: torch.Tensor, s: torch.Tensor, scal: torch.Tensor,
                 spacing: Sequence[float], n_inner: int,
                 done: Optional[torch.Tensor] = None, *,
                 seed_radius: float) -> torch.Tensor:
        """One cycle on a copy of ``T``; returns the swept batch. ``scal``
        holds the ``(B, 4)`` rows ``(a, b, c, s_src)`` of
        ``solve.source_scalars``; the seed ball's radius is ``seed_radius``
        times the largest spacing."""
        B = T.shape[0] if T.ndim else 0
        if (scal.device != T.device or scal.dtype != torch.float32
                or tuple(scal.shape) != (B, 4) or not scal.is_contiguous()):
            raise ValueError(f"scal: need a contiguous float32 ({B}, 4) "
                             f"tensor on {T.device}, got {scal.dtype} "
                             f"{tuple(scal.shape)} on {scal.device}")
        dev = check_fields("sweep3d", [("T", T), ("s", s)], sweep3d_smem,
                           limit=sweep3d_limit())
        B, n0, n1, n2 = T.shape
        if n0 * n1 * n2 >= 2 ** 31:
            raise ValueError(f"grid {(n0, n1, n2)}: K1 indexes a field with "
                             "32-bit offsets")
        done = done_flags(done, B, dev)
        if len(spacing) != 3 or n_inner < 0:
            raise ValueError(f"bad spacing {spacing} or n_inner {n_inner}")
        h = [float(x) for x in spacing]
        fn = self.build()
        out = T.clone()
        if B == 0:
            return out
        consts = (ctypes.c_float * 9)(*h, *[x * x for x in h],
                                      *[1.0 / (x * x) for x in h])
        iso = int(len(set(h)) == 1)
        radius = ctypes.c_float(float(seed_radius) * max(h))
        # The axis-2 march's (n2, n0, n1) copies of T and s, per field.
        scratch = torch.empty((B, 2, n2, n0, n1), dtype=torch.float32,
                              device=dev)
        threads, index, stream = launch_config(T.shape, dev)
        rc = fn(out.data_ptr(), s.data_ptr(), scal.data_ptr(),
                scratch.data_ptr(), done.data_ptr(),
                self.counter(dev).data_ptr(), B, n0, n1, n2, consts, iso,
                int(n_inner), radius, threads, index, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1
        return out


SWEEP3D = Sweep3dKernel()


def seeded_cycle(T: torch.Tensor, s: torch.Tensor, scal: torch.Tensor,
                 spacing: Sequence[float], n_inner: int,
                 done: Optional[torch.Tensor] = None, *,
                 seed_radius: float) -> torch.Tensor:
    """One full sweep cycle with the seed floor rebuilt from the
    ``(B, D + 1)`` source scalars and ``seed_radius`` (in units of the
    largest spacing), on the fields whose ``done`` flag is clear.

    CUDA tensors go to K1 (a ``(B, nx, ny, nz)`` batch) or to K3's cycle
    (a ``(B, n0, n1)`` batch), CPU tensors to the plain version
    (``solve.sweep_seeded_cycle_plain``). Any other device raises.
    """
    if T.device.type == "cpu":
        return sweep_seeded_cycle_plain(T, s, scal, spacing, n_inner, done,
                                        seed_radius=seed_radius)
    if T.device.type == "cuda":
        if T.ndim == 3:
            return SWEEP2D.cycle(T, s, scal, spacing, n_inner, done,
                                 seed_radius=seed_radius)
        return SWEEP3D(T, s, scal, spacing, n_inner, done,
                       seed_radius=seed_radius)
    raise ValueError(f"no seeded sweep for device {T.device}")


def solve(T0: torch.Tensor, s: torch.Tensor, scal: torch.Tensor,
          spacing: Sequence[float], tol: float, max_cycles: int,
          n_inner: int, *, seed_radius: float,
          cycles_per_iter: int = 1) -> torch.Tensor:
    """The sweep solve of the kernels' routes, from ``T0`` with the seed
    floor rebuilt from the source scalars: on a CUDA ``(B, n0, n1)`` batch
    K3's solve, each field's whole solve in one launch; otherwise
    ``solve.sweep_solve`` around :func:`seeded_cycle` (K1 on CUDA 3-D
    batches, the plain cycle on CPU tensors), ``cycles_per_iter`` cycles
    per counted iteration. The same bits and per-field counts either way."""
    if T0.device.type == "cuda" and T0.ndim == 3:
        return SWEEP2D.solve(T0, s, scal, spacing, n_inner, tol, max_cycles,
                             seed_radius=seed_radius,
                             cycles_per_iter=cycles_per_iter)[0]
    return sweep_solve(T0, scal, s, spacing, tol, max_cycles, n_inner,
                       cycle=functools.partial(seeded_cycle,
                                               seed_radius=seed_radius),
                       cycles_per_iter=cycles_per_iter)
