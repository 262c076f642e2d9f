"""CUDA transport kernel K6: bind and launch ``csrc/transport2d.cu``.

Counterpart of ``mceik_tpu/eikonal/pallas_transport.py`` on 2-D fields. One
launch runs one full adjoint transport cycle (rows forward and backward,
then columns forward and backward) on every field of a ``(B, n0, n1)`` fp32
batch whose done flag is clear; it replaces the Pallas kernel
``transport_axis0`` (pallas_transport.py:132) as ``transport_cycle_pallas``
(:148) drives it on 2-D fields, the transport of every 2-D gradient
(configs 1 and 4 under hmc, nuts, mala, am_full and gpCN). One CTA holds
one whole field in shared memory; the design note is in the CUDA source.

The kernel is compiled by ``nvcc`` at first use (``eikonal/cuda_build.py``).
Its plain version is ``adjoint_sweep.transport_cycle_plain`` on a 2-D
batch; ``cuda_transport.transport_cycle`` sends CUDA 2-D batches here and
CPU tensors to the plain version. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from mceik_tpu_torch.eikonal.cuda_build import (CSRC, MAX_SMEM_BYTES,
                                                MAX_THREADS, NvccKernel,
                                                check_fields, done_flags,
                                                launch_config, launch_threads)
from mceik_tpu_torch.eikonal.cuda_sweep2d import row_stride

SOURCE = CSRC / "transport2d.cu"
# Whole fields per CTA in shared memory: lam, g, w0 and w1.
N_FIELDS = 4


def smem_bytes(grid: Tuple[int, ...]) -> int:
    """Dynamic shared memory of one CTA: lam, g, w0 and w1 of the whole
    field with the padded row stride, and two line buffers of one float per
    thread."""
    n0, n1 = grid
    threads = launch_threads((1, n0, n1))
    return 4 * (N_FIELDS * n0 * row_stride(n1) + 2 * threads)


def field_limit() -> str:
    """The largest square grid K6 takes, as text for its error message:
    four fp32 fields fit 119^2 (14,161 nodes) but not 120^2."""
    side = math.isqrt(MAX_SMEM_BYTES // (4 * N_FIELDS))
    while smem_bytes((side, side)) > MAX_SMEM_BYTES:
        side -= 1
    return (f"{N_FIELDS} fp32 fields of the whole grid fit {side}^2 "
            f"({side * side} nodes) but not {side + 1}^2; a larger grid "
            "needs a thread-block-cluster kernel, later work")


class Transport2dKernel(NvccKernel):
    """K6 built from ``csrc/transport2d.cu``, with its launch count."""

    def __init__(self):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        super().__init__(SOURCE, "transport2d_cycle",
                         [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                          ci, vp])

    def __call__(self, lam: torch.Tensor, g: torch.Tensor,
                 wsigned: Sequence[torch.Tensor], n_inner: int,
                 done: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One cycle of ``lam``; returns the swept batch in a new tensor."""
        if len(wsigned) != 2:
            raise ValueError(f"transport2d kernel takes two weight fields, "
                             f"got {len(wsigned)}")
        dev = check_fields(
            "transport2d",
            [("lam", lam), ("g", g)] + [(f"w{d}", w)
                                        for d, w in enumerate(wsigned)],
            smem_bytes, ndim=2, limit=field_limit())
        B, n0, n1 = lam.shape
        if max(n0, n1) > MAX_THREADS:
            raise ValueError(f"grid {(n0, n1)}: a line longer than "
                             f"{MAX_THREADS} nodes exceeds one block's threads")
        done = done_flags(done, B, dev)
        if n_inner < 0:
            raise ValueError(f"bad n_inner {n_inner}")
        fn = self.build()
        out = torch.empty_like(lam)
        if B == 0:
            return out
        threads, index, stream = launch_config(lam.shape, dev)
        rc = fn(lam.data_ptr(), out.data_ptr(), g.data_ptr(),
                wsigned[0].data_ptr(), wsigned[1].data_ptr(), done.data_ptr(),
                B, n0, n1, row_stride(n1), int(n_inner), threads,
                smem_bytes((n0, n1)), index, stream)
        if rc != 0:
            raise RuntimeError(f"transport2d_cycle launch failed: CUDA error "
                               f"{rc}")
        self.launches += 1
        return out


TRANSPORT2D = Transport2dKernel()
