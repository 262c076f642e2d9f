"""CUDA sweep kernel K3: bind and launch ``csrc/sweep2d.cu``.

Counterpart of the lane-batched 2-D solve in
``mceik_tpu/eikonal/pallas_sweep.py``: it replaces the Pallas kernel
``_sweep2d_axis0`` (pallas_sweep.py:890) as
``sweep_solve_pallas_2d_lanebatched`` (:907) drives it under its
``lax.while_loop``. One C entry, two uses, one launch each:
:meth:`Sweep2dKernel.cycle` runs one full sweep cycle (rows forward and
backward, then columns forward and backward) on every field of a
``(B, n0, n1)`` fp32 batch whose done flag is clear; :meth:`Sweep2dKernel.solve`
runs each field's whole solve, cycle after cycle until its own
convergence, and returns the cycles each field took. Both compute the seed
floor in the kernel from the ``(B, 3)`` source scalars
(``solve.source_scalars``: the source's index coordinates and slowness),
as K1 does. Two routes, one C entry, the same bits: one warp holds one
whole field in shared memory ("warp", for batches that fill the card), or
a CTA of one thread per node of a line does ("block", for batches of no
more fields than the card has SMs); :func:`route_for` picks. The design
note is in the CUDA source.

The kernel is compiled by ``nvcc`` at first use (``eikonal/cuda_build.py``).
Its plain versions are ``solve.sweep_seeded_cycle_plain`` for a cycle, and
``solve.sweep_solve`` around it (or, field by field,
``solve.sweep_solve_fields_plain``) for a solve; ``cuda_sweep.seeded_cycle``
and ``cuda_sweep.solve`` send CUDA 2-D batches here and CPU tensors to the
plain versions. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from mceik_tpu_torch.eikonal.cuda_build import (CSRC, MAX_SMEM_BYTES,
                                                FieldCycles, NvccKernel,
                                                check_fields, check_line,
                                                done_flags, launch_threads,
                                                row_stride)

SOURCE = CSRC / "sweep2d.cu"
ROUTES = ("warp", "block")


def smem_bytes(grid: Tuple[int, ...]) -> int:
    """Dynamic shared memory of one CTA (one field) of the warp route: T
    and s of the whole field with the padded row stride."""
    n0, n1 = grid
    return 4 * 2 * n0 * row_stride(n1)


def block_smem_bytes(grid: Tuple[int, ...]) -> int:
    """Dynamic shared memory of one CTA of the block route: the warp
    route's, two line buffers of one float per thread and one float per
    warp."""
    return smem_bytes(grid) + 4 * (2 * launch_threads((0,) + tuple(grid))
                                   + 32)


_SM_COUNTS = {}


def route_for(B: int, grid: Tuple[int, ...], dev: torch.device) -> str:
    """The route K3 takes for ``B`` fields of ``grid`` on ``dev``: "block"
    (a CTA of one thread per node of a line) where the batch has no more
    fields than the card has SMs, so that each field would hold an SM
    alone, and the block's shared memory fits; else "warp" (one warp per
    field, the route for batches that fill the card)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    if B <= _SM_COUNTS[index] and block_smem_bytes(grid) <= MAX_SMEM_BYTES:
        return "block"
    return "warp"


class Sweep2dKernel(NvccKernel, FieldCycles):
    """K3 built from ``csrc/sweep2d.cu`` (or ``source``): a cycle or a
    whole solve per launch, one launch count for both entries and both
    routes, and ``block_launches`` those of the block route."""

    def __init__(self, source: Path = SOURCE):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        NvccKernel.__init__(self, source, "sweep2d_solve",
                            [vp] * 7 + [ci] * 4 + [vp, ci, ci, cf, ci, cf] +
                            [ci] * 5 + [vp])
        FieldCycles.__init__(self)
        self.block_launches = 0

    def _launch(self, Tin, s, scal, spacing, n_inner, seed_radius, done,
                max_cycles, tol, solve, route):
        check_line("sweep2d", Tin.shape[1:])
        dev = check_fields("sweep2d", [("T", Tin), ("s", s)], smem_bytes,
                           ndim=2)
        B, n0, n1 = Tin.shape
        if route is None:
            route = route_for(B, (n0, n1), dev)
        if route not in ROUTES:
            raise ValueError(f"route: one of {ROUTES} or None, not {route!r}")
        block = route == "block"
        smem = block_smem_bytes((n0, n1)) if block else smem_bytes((n0, n1))
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"grid {(n0, n1)}: the block route needs {smem} "
                             f"bytes of shared memory per block, more than "
                             f"{MAX_SMEM_BYTES}")
        if (scal.device != dev or scal.dtype != torch.float32
                or tuple(scal.shape) != (B, 3) or not scal.is_contiguous()):
            raise ValueError(f"scal: need a contiguous float32 ({B}, 3) "
                             f"tensor on {dev}, got {scal.dtype} "
                             f"{tuple(scal.shape)} on {scal.device}")
        if len(spacing) != 2 or n_inner < 0:
            raise ValueError(f"bad spacing {spacing} or n_inner {n_inner}")
        fn = self.build()
        out = torch.empty_like(Tin)
        cycles = torch.empty(B, dtype=torch.int32, device=dev)
        if B == 0:
            return out, cycles
        h = [float(x) for x in spacing]
        consts = (ctypes.c_float * 6)(*h, *[x * x for x in h],
                                      *[1.0 / (x * x) for x in h])
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        rc = fn(Tin.data_ptr(), out.data_ptr(), s.data_ptr(), scal.data_ptr(),
                None if done is None else done.data_ptr(), cycles.data_ptr(),
                self.counter(dev).data_ptr(), B, n0, n1, row_stride(n1),
                consts, int(h[0] == h[1]), int(n_inner),
                float(seed_radius) * max(h), int(max_cycles), float(tol),
                int(solve), int(block), launch_threads(Tin.shape), smem,
                index, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1
        self.block_launches += block
        return out, cycles

    def cycle(self, T: torch.Tensor, s: torch.Tensor, scal: torch.Tensor,
              spacing: Sequence[float], n_inner: int,
              done: Optional[torch.Tensor] = None, *,
              seed_radius: float, route: Optional[str] = None
              ) -> torch.Tensor:
        """One cycle of ``T`` on the fields whose ``done`` flag is clear
        (done fields come back as they were); returns a new tensor. The
        seed ball's radius is ``seed_radius`` times the largest spacing.
        ``route`` ("warp" or "block") overrides :func:`route_for`."""
        B = T.shape[0] if T.ndim else 0
        done = done_flags(done, B, T.device)
        return self._launch(T, s, scal, spacing, n_inner, seed_radius, done,
                            1, 0.0, False, route)[0]

    def solve(self, T0: torch.Tensor, s: torch.Tensor, scal: torch.Tensor,
              spacing: Sequence[float], n_inner: int, tol: float,
              max_cycles: int, *, seed_radius: float,
              cycles_per_iter: int = 1, route: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each field's solve from ``T0``: cycles until its
        ``max|T_new - T_old| <= tol`` (a NaN residual also stops it) or
        ``max_cycles`` cycles, all in one launch. Returns the batch and each
        field's cycle count (``(B,)`` int32), those of ``solve.sweep_solve``.
        Every 2-D route counts one cycle per iteration; ``cycles_per_iter``
        other than 1 raises ValueError. ``route`` as in :meth:`cycle`."""
        if cycles_per_iter != 1:
            raise ValueError(f"the 2-D solve runs one cycle per counted "
                             f"iteration, not {cycles_per_iter}")
        if max_cycles < 0:
            raise ValueError(f"bad max_cycles {max_cycles}")
        return self._launch(T0, s, scal, spacing, n_inner, seed_radius, None,
                            max_cycles, tol, True, route)


SWEEP2D = Sweep2dKernel()
