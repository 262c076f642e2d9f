"""CUDA transport kernel K6: bind and launch ``csrc/transport2d.cu``.

Counterpart of ``mceik_tpu/eikonal/pallas_transport.py`` on 2-D fields: it
replaces the Pallas kernel ``transport_axis0`` (pallas_transport.py:132) as
``transport_cycle_pallas`` (:148) drives it on 2-D fields, the transport of
every 2-D gradient (configs 1 and 4 under hmc, nuts, mala, am_full and
gpCN). One C entry, two uses, one launch each: :meth:`Transport2dKernel.cycle`
runs one full adjoint transport cycle (rows forward and backward, then
columns forward and backward) on every field of a ``(B, n0, n1)`` fp32
batch whose done flag is clear; :meth:`Transport2dKernel.solve` runs each
field's whole solve from ``lam = g`` until its own convergence or
divergence (then all NaN), and returns the cycles each field took. One
warp holds one whole field in shared memory, as K3; the design note is in
the CUDA source.

The kernel is compiled by ``nvcc`` at first use (``eikonal/cuda_build.py``).
Its plain versions are ``adjoint_sweep.transport_cycle_plain`` for a cycle,
and ``adjoint_sweep.transport_solve`` around it (or, field by field,
``adjoint_sweep.transport_solve_fields_plain``) for a solve;
``cuda_transport.transport_cycle`` and ``cuda_transport.solve`` send CUDA
2-D batches here and CPU tensors to the plain versions. A failed build or
launch raises.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from mceik_tpu_torch.eikonal.cuda_build import (CSRC, MAX_SMEM_BYTES,
                                                FieldCycles, NvccKernel,
                                                check_fields, check_line,
                                                done_flags, row_stride)

SOURCE = CSRC / "transport2d.cu"
# Whole fields per CTA in shared memory: lam, g, w0 and w1.
N_FIELDS = 4


def smem_bytes(grid: Tuple[int, ...]) -> int:
    """Dynamic shared memory of one CTA (one field): lam, g, w0 and w1 of
    the whole field with the padded row stride."""
    n0, n1 = grid
    return 4 * N_FIELDS * n0 * row_stride(n1)


def field_limit() -> str:
    """The largest square grid K6 takes, as text for its error message:
    four fp32 fields fit 120^2 (14,400 nodes) but not 121^2."""
    side = math.isqrt(MAX_SMEM_BYTES // (4 * N_FIELDS))
    while smem_bytes((side, side)) > MAX_SMEM_BYTES:
        side -= 1
    return (f"{N_FIELDS} fp32 fields of the whole grid fit {side}^2 "
            f"({side * side} nodes) but not {side + 1}^2; a larger grid "
            "needs a thread-block-cluster kernel, later work")


class Transport2dKernel(NvccKernel, FieldCycles):
    """K6 built from ``csrc/transport2d.cu`` (or ``source``): a cycle or a
    whole solve per launch, one launch count for both."""

    def __init__(self, source: Path = SOURCE):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        NvccKernel.__init__(self, source, "transport2d_solve",
                            [vp] * 8 + [ci] * 6 + [cf, ci, ci, ci, vp])
        FieldCycles.__init__(self)

    def _launch(self, lam, g, wsigned, n_inner, done, max_cycles, tol, solve):
        if len(wsigned) != 2:
            raise ValueError(f"transport2d kernel takes two weight fields, "
                             f"got {len(wsigned)}")
        check_line("transport2d", lam.shape[1:])
        dev = check_fields(
            "transport2d",
            [("lam", lam), ("g", g)] + [(f"w{d}", w)
                                        for d, w in enumerate(wsigned)],
            smem_bytes, ndim=2, limit=field_limit())
        B, n0, n1 = lam.shape
        if n_inner < 0:
            raise ValueError(f"bad n_inner {n_inner}")
        fn = self.build()
        out = torch.empty_like(lam)
        cycles = torch.empty(B, dtype=torch.int32, device=dev)
        if B == 0:
            return out, cycles
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        rc = fn(lam.data_ptr(), out.data_ptr(), g.data_ptr(),
                wsigned[0].data_ptr(), wsigned[1].data_ptr(),
                None if done is None else done.data_ptr(), cycles.data_ptr(),
                self.counter(dev).data_ptr(), B, n0, n1, row_stride(n1),
                int(n_inner), int(max_cycles), float(tol), int(solve),
                smem_bytes((n0, n1)), index,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1
        return out, cycles

    def cycle(self, lam: torch.Tensor, g: torch.Tensor,
              wsigned: Sequence[torch.Tensor], n_inner: int,
              done: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One cycle of ``lam`` on the fields whose ``done`` flag is clear
        (done fields come back as they were); returns a new tensor."""
        B = lam.shape[0] if lam.ndim else 0
        done = done_flags(done, B, lam.device)
        return self._launch(lam, g, wsigned, n_inner, done, 1, 0.0, False)[0]

    def solve(self, g: torch.Tensor, wsigned: Sequence[torch.Tensor],
              tol: float, max_cycles: int, n_inner: int = 2,
              cycles_per_iter: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each field's solve of ``lam = W^T lam + g`` from ``lam = g``, as
        ``adjoint_sweep.transport_solve`` decides convergence and divergence
        (a diverged field comes back all NaN), all in one launch. Returns lam
        and each field's cycle count (``(B,)`` int32). Every 2-D route
        counts one cycle per iteration; ``cycles_per_iter`` other than 1
        raises ValueError."""
        if cycles_per_iter != 1:
            raise ValueError(f"the 2-D solve runs one cycle per counted "
                             f"iteration, not {cycles_per_iter}")
        if max_cycles < 0:
            raise ValueError(f"bad max_cycles {max_cycles}")
        return self._launch(g, g, wsigned, n_inner, None, max_cycles, tol,
                            True)


TRANSPORT2D = Transport2dKernel()
