"""CUDA transport kernel K4: bind and launch ``csrc/transport3d.cu``.

Counterpart of ``mceik_tpu/eikonal/pallas_transport.py``. One launch runs
one full adjoint transport cycle (axes 0, 1, 2, each forward then backward)
on every field of a ``(B, nx, ny, nz)`` fp32 batch whose done flag is clear;
it replaces the Pallas kernel ``transport_axis0`` (pallas_transport.py:132)
as ``transport_solve_pallas_packed`` drives it. The design note is in the
CUDA source. The blocked 128^3 route of that module (halo planes and
pinned rows, K5) is not ported.

The kernel is compiled by ``nvcc`` at first use (``eikonal/cuda_build.py``).
:func:`transport_cycle` launches it for CUDA tensors and runs the plain
version, ``adjoint_sweep.transport_cycle_plain``, for CPU tensors; there is
no other fallback. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from mceik_tpu_torch.eikonal.adjoint_sweep import transport_cycle_plain
from mceik_tpu_torch.eikonal.cuda_build import (CSRC, NvccKernel,
                                                check_fields, done_flags,
                                                launch_config, plane_smem)

SOURCE = CSRC / "transport3d.cu"
# Shared-memory planes per CTA: base, lam (double-buffered), two weights.
N_PLANES = 5


class Transport3dKernel(NvccKernel):
    """K4 built from ``csrc/transport3d.cu``, with its launch count."""

    def __init__(self):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        super().__init__(SOURCE, "transport3d_cycle",
                         [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                          vp])

    def __call__(self, lam: torch.Tensor, g: torch.Tensor,
                 wsigned: Sequence[torch.Tensor], n_inner: int,
                 done: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One cycle on a copy of ``lam``; returns the swept batch."""
        if len(wsigned) != 3:
            raise ValueError(f"transport3d kernel takes three weight fields, "
                             f"got {len(wsigned)}")
        dev = check_fields(
            "transport3d",
            [("lam", lam), ("g", g)] + [(f"w{d}", w)
                                        for d, w in enumerate(wsigned)],
            plane_smem(N_PLANES))
        B, n0, n1, n2 = lam.shape
        done = done_flags(done, B, dev)
        if n_inner < 0:
            raise ValueError(f"bad n_inner {n_inner}")
        fn = self.build()
        out = lam.clone()
        if B == 0:
            return out
        threads, index, stream = launch_config(lam.shape, dev)
        rc = fn(out.data_ptr(), g.data_ptr(), wsigned[0].data_ptr(),
                wsigned[1].data_ptr(), wsigned[2].data_ptr(), done.data_ptr(),
                B, n0, n1, n2, int(n_inner), threads, index, stream)
        if rc != 0:
            raise RuntimeError(f"transport3d_cycle launch failed: CUDA error {rc}")
        self.launches += 1
        return out


TRANSPORT3D = Transport3dKernel()


def transport_cycle(lam: torch.Tensor, g: torch.Tensor,
                    wsigned: Sequence[torch.Tensor], n_inner: int,
                    done: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One full transport cycle on the fields whose ``done`` flag is clear.

    CUDA tensors go to the kernel; CPU tensors to the plain version
    (``adjoint_sweep.transport_cycle_plain``). Any other device raises.
    """
    if lam.device.type == "cpu":
        return transport_cycle_plain(lam, g, wsigned, n_inner, done)
    if lam.device.type == "cuda":
        if lam.ndim != 4:
            raise NotImplementedError(
                "2-D transport on CUDA needs a 2-D transport kernel, which "
                "is slice 4 of the port")
        return TRANSPORT3D(lam, g, wsigned, n_inner, done)
    raise ValueError(f"no transport cycle for device {lam.device}")
