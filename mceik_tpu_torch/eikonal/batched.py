"""Batched eikonal solve: seed every field, then sweep the batch to its
fixed point in one call.

Counterpart of ``mceik_tpu/eikonal/batched.py``. The batch is explicit
(``(B,) + grid``), so the JAX package's vmap-merging boundary, lane packing,
chunking and sequencing have nothing to do here: they exist for Mosaic and
the TPU backend.
"""

from __future__ import annotations

import torch

from mceik_tpu_torch.eikonal import cuda_sweep
from mceik_tpu_torch.eikonal.solve import (EikonalConfig, seed_floor,
                                           seed_source, sweep_cycle_plain,
                                           sweep_solve)
from mceik_tpu_torch.grid import Grid


def solve_eikonal_batched(slowness: torch.Tensor, srcs: torch.Tensor,
                          grid: Grid,
                          config: EikonalConfig = EikonalConfig()) -> torch.Tensor:
    """Solve one traveltime field per source.

    Args:
      slowness: grid-shaped (shared) or ``(B,) + grid.shape`` (per source).
      srcs: ``(B, D)`` physical source coordinates.

    Returns ``(B,) + grid.shape`` fp32 traveltimes. CUDA tensors are swept
    by the CUDA kernel (K1 on a 3-D grid, K3 on a 2-D one) and CPU tensors
    by the plain sweep, unless
    ``config.use_pallas == "off"`` asks for the plain sweep on any device.
    """
    if config.method != "sweep":
        raise NotImplementedError(
            f"eikonal method {config.method!r}: the port runs 'sweep' only "
            "(the Jacobi solve is slice 4)")
    if config.use_pallas == "interpret":
        raise ValueError("use_pallas='interpret' is a Pallas mode; the port "
                         "takes 'auto', 'on' or 'off'")
    if config.use_pallas not in ("auto", "on", "off"):
        raise ValueError(f"unknown use_pallas {config.use_pallas!r}")
    s = torch.as_tensor(slowness, dtype=torch.float32)
    B = srcs.shape[0]
    if s.ndim == grid.ndim:
        s = s.expand((B,) + grid.shape)
    if tuple(s.shape) != (B,) + grid.shape:
        raise ValueError(f"slowness {tuple(s.shape)} vs {B} sources on grid "
                         f"{grid.shape}")
    s = s.contiguous()
    T0, frozen = seed_source(s, srcs, grid, config.seed_radius)
    floor = seed_floor(T0, frozen)
    cycle = (sweep_cycle_plain if config.use_pallas == "off"
             else cuda_sweep.sweep_cycle)
    return sweep_solve(T0, floor, s, grid.spacing, config.tol,
                       config.max_iters, config.n_inner, cycle=cycle)
