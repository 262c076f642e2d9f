"""CUDA sweep kernels K1 and K7: build, bind and launch the two entry points
of ``csrc/sweep3d.cu``; and the sweep-cycle dispatch of every batch to its
kernel (K1 for 3-D fields, K3, ``eikonal/cuda_sweep2d.py``, for 2-D fields;
K7 for the 3-D gridbatch route).

Counterpart of ``mceik_tpu/eikonal/pallas_sweep.py``. One launch runs one
full sweep cycle (axes 0, 1, 2, each forward then backward) on every field
of a ``(B, nx, ny, nz)`` fp32 batch whose done flag is clear. It replaces
the Pallas kernel ``sweep_axes012_fused`` (pallas_sweep.py:372) on cube
grids, and on config 3's non-cube route (n_x == n_y, 48x48x32) the pair
``sweep_axes01_fused`` (pallas_sweep.py:222, call :230) + ``sweep_axis0``
on axis 2 (:132, call :139) that ``sweep_cycle_pallas_packed`` takes
there. K7 is the same kernel with the seed floor rebuilt in the kernel
from four scalars per field (``sweep3d_seeded_cycle``), which replaces
``sweep_axis0_gridbatch`` (pallas_sweep.py:740, call :762) on the opt-in
``impl="gridbatch"`` route. The design notes are in the CUDA source.

The kernel is compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` and loaded with ``ctypes`` (``eikonal/cuda_build.py``).
Nothing is built when this module is imported.

:func:`sweep_cycle` launches the kernel for CUDA tensors and runs the plain
version, ``solve.sweep_cycle_plain``, for CPU tensors; there is no other
fallback; :func:`seeded_cycle` does the same for K7 and its plain version
``solve.sweep_seeded_cycle_plain``. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from mceik_tpu_torch.eikonal.cuda_build import (CSRC, NvccKernel,
                                                check_fields, done_flags,
                                                launch_config, plane_limit,
                                                plane_smem)
from mceik_tpu_torch.eikonal.cuda_sweep2d import SWEEP2D
from mceik_tpu_torch.eikonal.solve import (sweep_cycle_plain,
                                           sweep_seeded_cycle_plain)

SOURCE = CSRC / "sweep3d.cu"
# Shared-memory planes per CTA: a_ax and the plane double-buffered.
N_PLANES = 3


class Sweep3dKernel(NvccKernel):
    """K1 built from ``csrc/sweep3d.cu``, with its launch count."""

    SYMBOL = "sweep3d_cycle"
    # C arguments between n_inner and the launch shape.
    EXTRA_ARGS: tuple = ()

    def __init__(self):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        super().__init__(SOURCE, self.SYMBOL,
                         [vp, vp, vp, vp, ci, ci, ci, ci, vp, ci, ci,
                          *self.EXTRA_ARGS, ci, ci, vp])

    def __call__(self, T: torch.Tensor, s: torch.Tensor, floor: torch.Tensor,
                 spacing: Sequence[float], n_inner: int,
                 done: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One cycle on a copy of ``T`` with the floor field ``floor``;
        returns the swept batch."""
        return self._launch(T, s, [("floor", floor)], floor, spacing,
                            n_inner, done, ())

    def _launch(self, T, s, fields, third, spacing, n_inner, done, extra):
        """Check the fields, then launch on a copy of ``T`` with ``third``
        as the entry's third pointer and ``extra`` before the launch shape;
        returns the swept batch."""
        dev = check_fields(self.symbol[:-len("_cycle")],
                           [("T", T), ("s", s)] + fields,
                           plane_smem(N_PLANES), limit=plane_limit(N_PLANES))
        B, n0, n1, n2 = T.shape
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
        threads, index, stream = launch_config(T.shape, dev)
        rc = fn(out.data_ptr(), s.data_ptr(), third.data_ptr(),
                done.data_ptr(), B, n0, n1, n2, consts, iso, int(n_inner),
                *extra, threads, index, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1
        return out


class SeededSweep3dKernel(Sweep3dKernel):
    """K7, the seeded entry point of ``csrc/sweep3d.cu``: K1's cycle with
    the seed floor rebuilt in the kernel from four scalars per field, with
    its own launch count."""

    SYMBOL = "sweep3d_seeded_cycle"
    EXTRA_ARGS = (ctypes.c_float,)  # the seed radius

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
        radius = ctypes.c_float(float(seed_radius) *
                                max(float(x) for x in spacing))
        return self._launch(T, s, [], scal, spacing, n_inner, done,
                            (radius,))


SWEEP3D = Sweep3dKernel()
SWEEP3D_SEEDED = SeededSweep3dKernel()


def sweep_cycle(T: torch.Tensor, s: torch.Tensor, floor: torch.Tensor,
                spacing: Sequence[float], n_inner: int,
                done: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One full sweep cycle on the fields whose ``done`` flag is clear.

    CUDA tensors go to the kernel, K3 for a ``(B, n0, n1)`` batch and K1
    for a ``(B, nx, ny, nz)`` one; CPU tensors to the plain version
    (``solve.sweep_cycle_plain``). Any other device raises.
    """
    if T.device.type == "cpu":
        return sweep_cycle_plain(T, s, floor, spacing, n_inner, done)
    if T.device.type == "cuda":
        if T.ndim == 3:
            return SWEEP2D(T, s, floor, spacing, n_inner, done)
        return SWEEP3D(T, s, floor, spacing, n_inner, done)
    raise ValueError(f"no sweep for device {T.device}")


def seeded_cycle(T: torch.Tensor, s: torch.Tensor, scal: torch.Tensor,
                 spacing: Sequence[float], n_inner: int,
                 done: Optional[torch.Tensor] = None, *,
                 seed_radius: float) -> torch.Tensor:
    """One full sweep cycle with the seed floor rebuilt from the ``(B, 4)``
    source scalars and ``seed_radius`` (in units of the largest spacing),
    on the fields whose ``done`` flag is clear.

    CUDA tensors go to K7 (3-D batches only; a 2-D one raises), CPU tensors
    to the plain version (``solve.sweep_seeded_cycle_plain``). Any other
    device raises.
    """
    if T.device.type == "cpu":
        return sweep_seeded_cycle_plain(T, s, scal, spacing, n_inner, done,
                                        seed_radius=seed_radius)
    if T.device.type == "cuda":
        return SWEEP3D_SEEDED(T, s, scal, spacing, n_inner, done,
                              seed_radius=seed_radius)
    raise ValueError(f"no seeded sweep for device {T.device}")
