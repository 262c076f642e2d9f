"""CUDA transport kernels K4 and K5: bind and launch the two entry points of
``csrc/transport3d.cu``; and the transport-cycle dispatch of every batch to
its kernel (K4 or K5 for 3-D fields, K6, ``eikonal/cuda_transport2d.py``,
for 2-D fields).

Counterpart of ``mceik_tpu/eikonal/pallas_transport.py``. One launch runs
one full adjoint transport cycle (axes 0, 1, 2, each forward then backward)
on every field of a ``(B, nx, ny, nz)`` fp32 batch whose done flag is clear.
Both replace the Pallas kernel ``transport_axis0`` (pallas_transport.py:132):
K4 as ``transport_solve_pallas_packed`` drives it (cube grids, config 3's
48x48x32), K5 as ``transport_solve_pallas_blocked`` (:216) drives it on
fields too big for one VMEM block (config 5's 128^3). The two compute the
same cycle, as two instances of one templated CUDA kernel that differ only
in what they stage in shared memory. K4 holds five planes, so it takes
cross-sections up to 107^2; K5 holds three and reads the in-plane weights
from global memory, up to 139^2. :func:`transport_kernel_for` picks between
them by shape. The design notes are in the CUDA source.

The kernels are compiled by ``nvcc`` at first use (``eikonal/cuda_build.py``).
:func:`transport_cycle` launches one for CUDA tensors and runs the plain
version, ``adjoint_sweep.transport_cycle_plain``, for CPU tensors; there is
no other fallback. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from mceik_tpu_torch.eikonal.adjoint_sweep import transport_cycle_plain
from mceik_tpu_torch.eikonal.cuda_build import (CSRC, MAX_SMEM_BYTES,
                                                NvccKernel, check_fields,
                                                done_flags, launch_config,
                                                plane_limit, plane_smem)
from mceik_tpu_torch.eikonal.cuda_transport2d import TRANSPORT2D


class Transport3dKernel(NvccKernel):
    """The transport-cycle entry point ``{name}_cycle`` of
    ``csrc/transport3d.cu``, holding ``n_planes`` fp32 planes in shared
    memory, with its own launch count (by default K4)."""

    def __init__(self, name: str = "transport3d", n_planes: int = 5):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        super().__init__(CSRC / "transport3d.cu", f"{name}_cycle",
                         [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                          vp])
        self.name = name
        self.n_planes = n_planes

    def fits(self, grid) -> bool:
        """Whether one CTA's planes of a ``grid`` field fit in shared
        memory."""
        return plane_smem(self.n_planes)(tuple(grid)) <= MAX_SMEM_BYTES

    def __call__(self, lam: torch.Tensor, g: torch.Tensor,
                 wsigned: Sequence[torch.Tensor], n_inner: int,
                 done: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One cycle on a copy of ``lam``; returns the swept batch."""
        if len(wsigned) != 3:
            raise ValueError(f"{self.name} kernel takes three weight fields, "
                             f"got {len(wsigned)}")
        dev = check_fields(
            self.name,
            [("lam", lam), ("g", g)] + [(f"w{d}", w)
                                        for d, w in enumerate(wsigned)],
            plane_smem(self.n_planes), limit=plane_limit(self.n_planes))
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
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1
        return out


# K4: base, lam double-buffered and the two in-plane weight planes.
TRANSPORT3D = Transport3dKernel()
# K5: base and lam double-buffered; the weights stay in global memory.
TRANSPORT3D_LARGE = Transport3dKernel("transport3d_large", 3)


def transport_kernel_for(grid) -> Transport3dKernel:
    """The kernel for fields of shape ``grid`` (nx, ny, nz): K4 where its
    five planes fit in shared memory, else K5 where its three do. A choice
    by shape between two kernels of the same cycle; a grid neither takes
    raises ValueError."""
    for kernel in (TRANSPORT3D, TRANSPORT3D_LARGE):
        if kernel.fits(grid):
            return kernel
    raise ValueError(f"grid {tuple(grid)}: no transport kernel takes it: "
                     f"{plane_limit(TRANSPORT3D_LARGE.n_planes)}")


def transport_cycle(lam: torch.Tensor, g: torch.Tensor,
                    wsigned: Sequence[torch.Tensor], n_inner: int,
                    done: Optional[torch.Tensor] = None,
                    kernel: Optional[Transport3dKernel] = None) -> torch.Tensor:
    """One full transport cycle on the fields whose ``done`` flag is clear.

    CUDA tensors go to K6 for a ``(B, n0, n1)`` batch and for a
    ``(B, nx, ny, nz)`` one to ``kernel`` (by default
    :func:`transport_kernel_for` the grid; pass ``TRANSPORT3D_LARGE`` to run
    K5 on any shape); CPU tensors to the plain version
    (``adjoint_sweep.transport_cycle_plain``). ``kernel`` names a 3-D
    kernel: given with a 2-D batch it raises ValueError, as does any other
    device.
    """
    if kernel is not None and lam.ndim == 3:
        raise ValueError(f"kernel {kernel.symbol} is a 3-D transport; a "
                         f"(B, n0, n1) batch {tuple(lam.shape)} takes K6")
    if lam.device.type == "cpu":
        return transport_cycle_plain(lam, g, wsigned, n_inner, done)
    if lam.device.type == "cuda":
        if lam.ndim == 3:
            return TRANSPORT2D(lam, g, wsigned, n_inner, done)
        if kernel is None:
            kernel = transport_kernel_for(lam.shape[1:])
        return kernel(lam, g, wsigned, n_inner, done)
    raise ValueError(f"no transport cycle for device {lam.device}")
