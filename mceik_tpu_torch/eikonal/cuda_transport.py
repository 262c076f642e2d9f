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
same cycle bit for bit, as two instances of one templated CUDA kernel that
differ in where a thread's nodes live: K4 keeps them in registers, up to 4
per thread (planes of at most 4096 nodes, 64^2), with eleven haloed planes
in shared memory; K5 stages them in three, up to 20 per thread and 137^2.
:func:`transport_kernel_for` picks between them by shape. Both march axis 2
on a ring of z-planes, scratch the wrapper allocates at the size the
library states (``{name}_ring_planes``: five fields per field for K4,
0.625 for K5 at 128^3). :func:`solve_cycle` keeps K4's ring through a
solve, so that g and the weights, constant there, are transposed into it
once per field and only lam on every cycle. The design notes are in the
CUDA source.

The kernels are compiled by ``nvcc`` at first use (``eikonal/cuda_build.py``).
:func:`transport_cycle` launches one for CUDA tensors and runs the plain
version, ``adjoint_sweep.transport_cycle_plain``, for CPU tensors;
:func:`solve` runs a whole solve: K6's solve entry on CUDA 2-D batches (one
launch), else the host loop ``adjoint_sweep.transport_solve``. There is no
other fallback. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from mceik_tpu_torch.eikonal.adjoint_sweep import (transport_cycle_plain,
                                                   transport_solve)
from mceik_tpu_torch.eikonal.cuda_build import (CSRC, MAX_SMEM_BYTES,
                                                MAX_THREADS, FieldCycles,
                                                NvccKernel,
                                                check_fields, done_flags,
                                                launch_config,
                                                max_plane_nodes, plane_limit,
                                                plane_smem)
from mceik_tpu_torch.eikonal.cuda_transport2d import TRANSPORT2D

SOURCE = CSRC / "transport3d.cu"
# Nodes per thread K4 holds in registers, and K5 stages: the library's
# own rules (``{name}_nodes_per_thread``, ``{name}_smem_bytes``), copied so
# that the choice and the refusals work on the CPU too; a card test holds
# the copies to the library.
REG_NODES = 4
LARGE_NODES = 20
# Axis 2's ring holds z-planes of five operands: lam, g and the three
# weights.
RING_OPERANDS = 5


class Transport3dKernel(NvccKernel, FieldCycles):
    """The transport-cycle entry point ``{name}_cycle`` of
    ``csrc/transport3d.cu`` (or ``source``), holding ``n_planes`` haloed
    fp32 planes in shared memory and up to ``max_nodes`` nodes per plane,
    with its own launch count and field-cycles (one per field not done, per
    launch, counted by the kernel; by default K4)."""

    def __init__(self, name: str = "transport3d", n_planes: int = 11,
                 max_nodes: int = REG_NODES * MAX_THREADS,
                 source: Path = SOURCE):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        NvccKernel.__init__(self, source, f"{name}_cycle",
                            [vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                             ci, ci, ci, ci, vp])
        FieldCycles.__init__(self)
        # The ring's z-planes per operand for n2, from the same library; and
        # the library's own size rules, which tests hold to fits().
        self.ring_planes = NvccKernel(source, f"{name}_ring_planes", [ci])
        self.smem_bytes = NvccKernel(source, f"{name}_smem_bytes", [ci] * 4)
        self.nodes_per_thread = NvccKernel(
            source, f"{name}_nodes_per_thread", [])
        self.name = name
        self.n_planes = n_planes
        self.max_nodes = max_nodes

    def limit(self) -> str:
        """The largest cross-section it takes, as text."""
        return plane_limit(self.n_planes, self.max_nodes)

    def fits(self, grid) -> bool:
        """Whether one CTA takes a ``grid`` field: its planes fit in shared
        memory and its nodes in the threads' slots."""
        grid = tuple(grid)
        return (plane_smem(self.n_planes)(grid) <= MAX_SMEM_BYTES
                and max_plane_nodes(grid) <= self.max_nodes)

    def solve_ring(self, shape, dev) -> Tuple[torch.Tensor, torch.Tensor]:
        """Axis 2's ring for a ``shape`` batch kept from cycle to cycle,
        and its per-field flags, clear: K4 sets a field's flag once its ring
        holds g and the weights (K5 refills its ring every cycle)."""
        B, n0, n1, n2 = shape
        return (torch.empty((B, RING_OPERANDS, self.ring_planes.build()(n2),
                             n0 * n1), dtype=torch.float32, device=dev),
                torch.zeros(B, dtype=torch.uint8, device=dev))

    def __call__(self, lam: torch.Tensor, g: torch.Tensor,
                 wsigned: Sequence[torch.Tensor], n_inner: int,
                 done: Optional[torch.Tensor] = None,
                 ring: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """One cycle on a copy of ``lam``; returns the swept batch.
        ``ring`` is a :meth:`solve_ring` of this batch's shape that earlier
        cycles with the same ``g`` and ``wsigned`` have used, or None (a
        ring of this cycle's own)."""
        if len(wsigned) != 3:
            raise ValueError(f"{self.name} kernel takes three weight fields, "
                             f"got {len(wsigned)}")
        dev = check_fields(
            self.name,
            [("lam", lam), ("g", g)] + [(f"w{d}", w)
                                        for d, w in enumerate(wsigned)],
            plane_smem(self.n_planes), limit=self.limit(),
            max_nodes=self.max_nodes)
        B, n0, n1, n2 = lam.shape
        if n0 * n1 * n2 >= 2 ** 31:
            raise ValueError(f"grid {(n0, n1, n2)}: {self.name} indexes a "
                             "field with 32-bit offsets")
        done = done_flags(done, B, dev)
        if n_inner < 0:
            raise ValueError(f"bad n_inner {n_inner}")
        fn = self.build()
        out = lam.clone()
        if B == 0:
            return out
        # Axis 2's ring of z-planes of the five operands, per field.
        if ring is None:
            buf, ready = self.solve_ring(lam.shape, dev)[0], None
        else:
            buf, ready = ring
            if (buf.shape != (B, RING_OPERANDS, self.ring_planes.build()(n2),
                              n0 * n1) or ready.shape != (B,)
                    or buf.dtype != torch.float32 or ready.dtype != torch.uint8
                    or not buf.is_contiguous() or buf.device != dev
                    or ready.device != dev):
                raise ValueError(f"{self.name}: the ring is not a solve_ring "
                                 f"of a {tuple(lam.shape)} batch on {dev}")
        threads, index, stream = launch_config(lam.shape, dev)
        rc = fn(out.data_ptr(), g.data_ptr(), wsigned[0].data_ptr(),
                wsigned[1].data_ptr(), wsigned[2].data_ptr(), buf.data_ptr(),
                None if ready is None else ready.data_ptr(), done.data_ptr(),
                self.counter(dev).data_ptr(), B, n0, n1, n2, int(n_inner),
                threads, index, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1
        return out


# K4: registers; exchange, weight and staging planes in shared memory.
TRANSPORT3D = Transport3dKernel()
# K5: the exchange buffer and the two weight planes staged.
TRANSPORT3D_LARGE = Transport3dKernel("transport3d_large", 3,
                                      LARGE_NODES * MAX_THREADS)


def transport_kernel_for(grid) -> Transport3dKernel:
    """The kernel for fields of shape ``grid`` (nx, ny, nz): K4 where its
    registers and eleven planes take it, else K5 where its three do. A choice
    by shape between two kernels of the same cycle; a grid neither takes
    raises ValueError."""
    for kernel in (TRANSPORT3D, TRANSPORT3D_LARGE):
        if kernel.fits(grid):
            return kernel
    raise ValueError(f"grid {tuple(grid)}: no transport kernel takes it: "
                     f"{TRANSPORT3D_LARGE.limit()}; a larger one needs a "
                     "thread-block-cluster kernel, later work")


def transport_cycle(lam: torch.Tensor, g: torch.Tensor,
                    wsigned: Sequence[torch.Tensor], n_inner: int,
                    done: Optional[torch.Tensor] = None,
                    kernel: Optional[Transport3dKernel] = None) -> torch.Tensor:
    """One full transport cycle on the fields whose ``done`` flag is clear.

    CUDA tensors go to K6 for a ``(B, n0, n1)`` batch and for a
    ``(B, nx, ny, nz)`` one to ``kernel`` (by default
    :func:`transport_kernel_for` the grid; pass ``TRANSPORT3D_LARGE`` to run
    K5 on any shape it takes); CPU tensors to the plain version
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
            return TRANSPORT2D.cycle(lam, g, wsigned, n_inner, done)
        if kernel is None:
            kernel = transport_kernel_for(lam.shape[1:])
        return kernel(lam, g, wsigned, n_inner, done)
    raise ValueError(f"no transport cycle for device {lam.device}")


def solve_cycle(g: torch.Tensor, wsigned: Sequence[torch.Tensor]):
    """The cycle for one transport solve of ``g`` with ``wsigned``
    (``adjoint_sweep.transport_solve``'s ``cycle``): :func:`transport_cycle`,
    except where the batch takes K4, whose axis-2 ring it then keeps from
    cycle to cycle, so that the kernel transposes g and the weights into it
    once per field and only lam on the later cycles (the same bits). The
    cycle it returns raises ValueError when given another g or weights."""
    if (g.device.type != "cuda" or g.ndim != 4
            or transport_kernel_for(g.shape[1:]) is not TRANSPORT3D):
        return transport_cycle
    ring = TRANSPORT3D.solve_ring(g.shape, g.device)
    wsigned = tuple(wsigned)

    def cycle(lam, g_, wsigned_, n_inner, done=None):
        if g_ is not g or len(wsigned_) != 3 or any(
                a is not b for a, b in zip(wsigned_, wsigned)):
            raise ValueError("a solve's cycle takes the g and weights it "
                             "was made for")
        return TRANSPORT3D(lam, g, wsigned, n_inner, done, ring=ring)
    return cycle


def solve(g: torch.Tensor, wsigned: Sequence[torch.Tensor], tol: float,
          max_cycles: int, n_inner: int = 2,
          cycles_per_iter: int = 1) -> torch.Tensor:
    """The transport solve of the kernels' routes: on a CUDA
    ``(B, n0, n1)`` batch K6's solve, each field's whole solve in one
    launch; otherwise ``adjoint_sweep.transport_solve`` around
    :func:`solve_cycle` (K4 or K5 on CUDA 3-D batches, the plain cycle on
    CPU tensors), ``cycles_per_iter`` cycles per counted iteration. The same
    bits either way."""
    if g.device.type == "cuda" and g.ndim == 3:
        return TRANSPORT2D.solve(g, wsigned, tol, max_cycles, n_inner,
                                 cycles_per_iter)[0]
    return transport_solve(g, wsigned, tol, max_cycles, n_inner,
                           cycle=solve_cycle(g, wsigned),
                           cycles_per_iter=cycles_per_iter)
