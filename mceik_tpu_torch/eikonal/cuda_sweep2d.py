"""CUDA sweep kernel K3: bind and launch ``csrc/sweep2d.cu``.

Counterpart of the lane-batched 2-D solve in
``mceik_tpu/eikonal/pallas_sweep.py``. One launch runs one full sweep cycle
(rows forward and backward, then columns forward and backward) on every
field of a ``(B, n0, n1)`` fp32 batch whose done flag is clear; it replaces
the Pallas kernel ``_sweep2d_axis0`` (pallas_sweep.py:890) as
``sweep_solve_pallas_2d_lanebatched`` (:907) drives it. One CTA holds one
whole field in shared memory; the design note is in the CUDA source.

The kernel is compiled by ``nvcc`` at first use (``eikonal/cuda_build.py``).
Its plain version is ``solve.sweep_cycle_plain`` on a 2-D batch;
``cuda_sweep.sweep_cycle`` sends CUDA 2-D batches here and CPU tensors to
the plain version. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from mceik_tpu_torch.eikonal.cuda_build import (CSRC, MAX_THREADS, NvccKernel,
                                                check_fields, done_flags,
                                                launch_config, launch_threads)

SOURCE = CSRC / "sweep2d.cu"


def row_stride(n1: int) -> int:
    """The padded row stride in shared memory: ``n1`` rounded up to an odd
    number of floats, so a column's nodes fall in 32 distinct banks."""
    return n1 | 1


def smem_bytes(grid: Tuple[int, ...]) -> int:
    """Dynamic shared memory of one CTA: T, s and floor of the whole field
    with the padded row stride, and two line buffers of one float per
    thread."""
    n0, n1 = grid
    threads = launch_threads((1, n0, n1))
    return 4 * (3 * n0 * row_stride(n1) + 2 * threads)


class Sweep2dKernel(NvccKernel):
    """K3 built from ``csrc/sweep2d.cu``, with its launch count."""

    def __init__(self):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        super().__init__(SOURCE, "sweep2d_cycle",
                         [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp, ci, ci, ci,
                          ci, ci, vp])

    def __call__(self, T: torch.Tensor, s: torch.Tensor, floor: torch.Tensor,
                 spacing: Sequence[float], n_inner: int,
                 done: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One cycle of ``T``; returns the swept batch in a new tensor."""
        dev = check_fields("sweep2d", [("T", T), ("s", s), ("floor", floor)],
                           smem_bytes, ndim=2)
        B, n0, n1 = T.shape
        if max(n0, n1) > MAX_THREADS:
            raise ValueError(f"grid {(n0, n1)}: a line longer than "
                             f"{MAX_THREADS} nodes exceeds one block's threads")
        done = done_flags(done, B, dev)
        if len(spacing) != 2 or n_inner < 0:
            raise ValueError(f"bad spacing {spacing} or n_inner {n_inner}")
        fn = self.build()
        out = torch.empty_like(T)
        if B == 0:
            return out
        h = [float(x) for x in spacing]
        consts = (ctypes.c_float * 6)(*h, *[x * x for x in h],
                                      *[1.0 / (x * x) for x in h])
        iso = int(h[0] == h[1])
        threads, index, stream = launch_config(T.shape, dev)
        rc = fn(T.data_ptr(), out.data_ptr(), s.data_ptr(), floor.data_ptr(),
                done.data_ptr(), B, n0, n1, row_stride(n1), consts, iso,
                int(n_inner), threads, smem_bytes((n0, n1)), index, stream)
        if rc != 0:
            raise RuntimeError(f"sweep2d_cycle launch failed: CUDA error {rc}")
        self.launches += 1
        return out


SWEEP2D = Sweep2dKernel()
