"""CUDA sweep kernel K1: build, bind and launch ``csrc/sweep3d.cu``; and
the sweep-cycle dispatch of every batch to its kernel (K1 for 3-D fields,
K3, ``eikonal/cuda_sweep2d.py``, for 2-D fields).

Counterpart of ``mceik_tpu/eikonal/pallas_sweep.py``. One launch runs one
full sweep cycle (axes 0, 1, 2, each forward then backward) on every field
of a ``(B, nx, ny, nz)`` fp32 batch whose done flag is clear; it replaces
the Pallas kernel ``sweep_axes012_fused`` (pallas_sweep.py:372). The design
note is in the CUDA source.

The kernel is compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` and loaded with ``ctypes`` (``eikonal/cuda_build.py``).
Nothing is built when this module is imported.

:func:`sweep_cycle` launches the kernel for CUDA tensors and runs the plain
version, ``solve.sweep_cycle_plain``, for CPU tensors; there is no other
fallback. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from mceik_tpu_torch.eikonal.cuda_build import (CSRC, NvccKernel,
                                                check_fields, done_flags,
                                                launch_config, plane_smem)
from mceik_tpu_torch.eikonal.cuda_sweep2d import SWEEP2D
from mceik_tpu_torch.eikonal.solve import sweep_cycle_plain

SOURCE = CSRC / "sweep3d.cu"
# Shared-memory planes per CTA: a_ax and the plane double-buffered.
N_PLANES = 3


class Sweep3dKernel(NvccKernel):
    """K1 built from ``csrc/sweep3d.cu``, with its launch count."""

    def __init__(self):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        super().__init__(SOURCE, "sweep3d_cycle",
                         [vp, vp, vp, vp, ci, ci, ci, ci, vp, ci, ci, ci, ci,
                          vp])

    def __call__(self, T: torch.Tensor, s: torch.Tensor, floor: torch.Tensor,
                 spacing: Sequence[float], n_inner: int,
                 done: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One cycle on a copy of ``T``; returns the swept batch."""
        dev = check_fields("sweep3d", [("T", T), ("s", s), ("floor", floor)],
                           plane_smem(N_PLANES))
        B, n0, n1, n2 = T.shape
        done = done_flags(done, B, dev)
        if len(spacing) != 3 or n_inner < 0:
            raise ValueError(f"bad spacing {spacing} or n_inner {n_inner}")
        fn = self.build()
        out = T.clone()
        if B == 0:
            return out
        h = [float(x) for x in spacing]
        consts = (ctypes.c_float * 9)(*h, *[x * x for x in h],
                                      *[1.0 / (x * x) for x in h])
        iso = int(len(set(h)) == 1)
        threads, index, stream = launch_config(T.shape, dev)
        rc = fn(out.data_ptr(), s.data_ptr(), floor.data_ptr(),
                done.data_ptr(), B, n0, n1, n2, consts, iso, int(n_inner),
                threads, index, stream)
        if rc != 0:
            raise RuntimeError(f"sweep3d_cycle launch failed: CUDA error {rc}")
        self.launches += 1
        return out


SWEEP3D = Sweep3dKernel()


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
