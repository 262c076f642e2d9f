"""CUDA sweep kernel K1: build, bind and launch ``csrc/sweep3d.cu``; and the
sweep dispatch of every batch to its kernel (K1 for 3-D fields, K3,
``eikonal/cuda_sweep2d.py``, for 2-D fields; both compute the seed floor in
the kernel from the source scalars).

Counterpart of ``mceik_tpu/eikonal/pallas_sweep.py``. One launch of K1
runs each field's whole solve on a ``(B, nx, ny, nz)`` fp32 batch, full
sweep cycles (axes 0, 1, 2, each forward then backward) until the field's
own convergence (:meth:`Sweep3dKernel.solve`). Its cycle replaces
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

:func:`seeded_cycle` launches K3's cycle for CUDA 2-D batches and runs
the plain version, ``solve.sweep_seeded_cycle_plain``, for CPU tensors;
:func:`solve` runs a whole solve: K1's or K3's solve entry on CUDA tensors
(one launch), the host loop ``solve.sweep_solve`` around
:func:`seeded_cycle` on CPU tensors. There is no other fallback. A failed
build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from mceik_tpu_torch.eikonal.cuda_build import (CSRC, MAX_SMEM_BYTES,
                                                MAX_THREADS, FieldCycles,
                                                NvccKernel, check_fields,
                                                launch_config, launch_threads)
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
    """K1 built from ``csrc/sweep3d.cu`` (or ``source``): each field's whole
    solve per launch, with its launch count and its field-cycles (each
    field's cycles, counted by the kernel)."""

    def __init__(self, source: Path = SOURCE):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        NvccKernel.__init__(self, source, "sweep3d_solve",
                            [vp] * 7 + [ci] * 4 + [vp, ci, ci, cf, ci, ci,
                                                   cf, ci, ci, vp])
        FieldCycles.__init__(self)

    def solve(self, T0: torch.Tensor, s: torch.Tensor, scal: torch.Tensor,
              spacing: Sequence[float], n_inner: int, tol: float,
              max_cycles: int, *, seed_radius: float,
              cycles_per_iter: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each field's solve from ``T0`` in one launch: counted iterations
        of ``cycles_per_iter`` cycles until the field's
        ``max|T_end - T_start|`` over one is not above ``tol`` (a NaN
        residual also stops it), at most ``max_cycles`` iterations. Returns
        the batch and each field's cycle count (``(B,)`` int32), those of
        ``solve.sweep_solve`` with ``return_cycles``. ``scal`` holds the
        ``(B, 4)`` rows ``(a, b, c, s_src)`` of ``solve.source_scalars``;
        the seed ball's radius is ``seed_radius`` times the largest
        spacing. Bad counts and inputs raise ValueError before anything is
        built."""
        if (cycles_per_iter < 1 or max_cycles < 0
                or max_cycles * cycles_per_iter >= 2 ** 31):
            raise ValueError(f"bad max_cycles {max_cycles} or "
                             f"cycles_per_iter {cycles_per_iter}")
        B = T0.shape[0] if T0.ndim else 0
        if (scal.device != T0.device or scal.dtype != torch.float32
                or tuple(scal.shape) != (B, 4) or not scal.is_contiguous()):
            raise ValueError(f"scal: need a contiguous float32 ({B}, 4) "
                             f"tensor on {T0.device}, got {scal.dtype} "
                             f"{tuple(scal.shape)} on {scal.device}")
        dev = check_fields("sweep3d", [("T", T0), ("s", s)], sweep3d_smem,
                           limit=sweep3d_limit())
        B, n0, n1, n2 = T0.shape
        if n0 * n1 * n2 >= 2 ** 31:
            raise ValueError(f"grid {(n0, n1, n2)}: K1 indexes a field with "
                             "32-bit offsets")
        if len(spacing) != 3 or n_inner < 0:
            raise ValueError(f"bad spacing {spacing} or n_inner {n_inner}")
        h = [float(x) for x in spacing]
        fn = self.build()
        out = T0.clone()
        cycles = torch.empty(B, dtype=torch.int32, device=dev)
        if B == 0:
            return out, cycles
        consts = (ctypes.c_float * 9)(*h, *[x * x for x in h],
                                      *[1.0 / (x * x) for x in h])
        iso = int(len(set(h)) == 1)
        radius = ctypes.c_float(float(seed_radius) * max(h))
        # Per field, the axis-2 march's (n2, n0, n1) copies of T and s, and
        # the counted iteration's start values.
        scratch = torch.empty((B, 3, n2, n0, n1), dtype=torch.float32,
                              device=dev)
        threads, index, stream = launch_config(T0.shape, dev)
        rc = fn(T0.data_ptr(), out.data_ptr(), s.data_ptr(), scal.data_ptr(),
                scratch.data_ptr(), cycles.data_ptr(),
                self.counter(dev).data_ptr(), B, n0, n1, n2, consts, iso,
                int(n_inner), radius, int(max_cycles), int(cycles_per_iter),
                float(tol), threads, index, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1
        return out, cycles


SWEEP3D = Sweep3dKernel()


def seeded_cycle(T: torch.Tensor, s: torch.Tensor, scal: torch.Tensor,
                 spacing: Sequence[float], n_inner: int,
                 done: Optional[torch.Tensor] = None, *,
                 seed_radius: float) -> torch.Tensor:
    """One full sweep cycle with the seed floor rebuilt from the
    ``(B, D + 1)`` source scalars and ``seed_radius`` (in units of the
    largest spacing), on the fields whose ``done`` flag is clear.

    A CUDA ``(B, n0, n1)`` batch goes to K3's cycle, CPU tensors to the
    plain version (``solve.sweep_seeded_cycle_plain``). Any other batch
    raises: K1 runs whole solves only (:func:`solve`).
    """
    if T.device.type == "cpu":
        return sweep_seeded_cycle_plain(T, s, scal, spacing, n_inner, done,
                                        seed_radius=seed_radius)
    if T.device.type == "cuda" and T.ndim == 3:
        return SWEEP2D.cycle(T, s, scal, spacing, n_inner, done,
                             seed_radius=seed_radius)
    raise ValueError(f"no seeded sweep cycle for a {T.ndim - 1}-D batch on "
                     f"{T.device}: K1 runs whole solves (cuda_sweep.solve)")


def solve(T0: torch.Tensor, s: torch.Tensor, scal: torch.Tensor,
          spacing: Sequence[float], tol: float, max_cycles: int,
          n_inner: int, *, seed_radius: float,
          cycles_per_iter: int = 1) -> torch.Tensor:
    """The sweep solve of the kernels' routes, from ``T0`` with the seed
    floor rebuilt from the source scalars, ``cycles_per_iter`` cycles per
    counted iteration: on CUDA tensors the solve entry of K3 (a
    ``(B, n0, n1)`` batch) or K1 (``(B, nx, ny, nz)``), each field's whole
    solve in one launch; on CPU tensors ``solve.sweep_solve`` around
    :func:`seeded_cycle`. The same bits and per-field counts either way."""
    if T0.device.type == "cuda":
        kernel = SWEEP2D if T0.ndim == 3 else SWEEP3D
        return kernel.solve(T0, s, scal, spacing, n_inner, tol, max_cycles,
                            seed_radius=seed_radius,
                            cycles_per_iter=cycles_per_iter)[0]
    return sweep_solve(T0, scal, s, spacing, tol, max_cycles, n_inner,
                       cycle=functools.partial(seeded_cycle,
                                               seed_radius=seed_radius),
                       cycles_per_iter=cycles_per_iter)
