"""Batched eikonal solve: seed every field, then sweep the batch to its
fixed point in one call.

Counterpart of ``mceik_tpu/eikonal/batched.py``. The batch is explicit
(``(B,) + grid``), so the JAX package's vmap-merging boundary, lane packing,
chunking and sequencing have nothing to do here: they exist for Mosaic and
the TPU backend.
"""

from __future__ import annotations

from typing import Optional

import torch

from mceik_tpu_torch.eikonal import cuda_sweep
from mceik_tpu_torch.eikonal.solve import (CYCLES_PER_ITER, EikonalConfig,
                                           jacobi_solve, seed_floor,
                                           seed_source,
                                           solve_route, source_scalars,
                                           sweep_cycle_plain, sweep_solve)
from mceik_tpu_torch.grid import Grid


def solve_eikonal_batched(slowness: torch.Tensor, srcs: torch.Tensor,
                          grid: Grid,
                          config: EikonalConfig = EikonalConfig(),
                          impl: Optional[str] = None) -> torch.Tensor:
    """Solve one traveltime field per source.

    Args:
      slowness: grid-shaped (shared) or ``(B,) + grid.shape`` (per source).
      srcs: ``(B, D)`` physical source coordinates.
      impl: the reference's routes, by default ``solve.solve_route``'s
        choice from ``config.use_pallas`` and the field size:
        ``"field"`` sweeps CUDA tensors with the CUDA kernels, which
        compute the seed floor from the source scalars (no floor field is
        built), one cycle per iteration: on a 3-D grid a K1 launch per
        cycle under the host loop ``solve.sweep_solve``, on a 2-D grid one
        K3 launch that runs every field's whole solve
        (``cuda_sweep.solve``); ``"blocked"`` (3-D) does the same with two
        cycles per iteration (the reference's count on fields above 2 MB);
        ``"gridbatch"``, 3-D only, is the ``"field"`` route under the name
        of the reference's seeded route; ``"xla"`` is the plain sweep with
        a floor operand. CPU tensors take each route's plain version.
        ``config.method="jacobi"`` runs the plain Jacobi solve
        (``solve.jacobi_solve``) on every route and device: it has no
        kernel, and no K1 or K3 launch is made for it. (The reference
        honours it on its ``"xla"`` route only; its kernel routes sweep
        whatever the method says.)

    Returns ``(B,) + grid.shape`` fp32 traveltimes.
    """
    if config.method not in ("sweep", "jacobi"):
        raise ValueError(f"unknown method {config.method!r}")
    s = torch.as_tensor(slowness, dtype=torch.float32)
    if impl is None:
        impl = solve_route(grid.shape, config.use_pallas, s.device)
    if impl not in CYCLES_PER_ITER:
        raise ValueError(f"unknown impl {impl!r}: the port takes "
                         f"{', '.join(CYCLES_PER_ITER)}")
    if impl == "gridbatch" and grid.ndim != 3:
        raise ValueError("impl='gridbatch' is 3-D only (2-D fields take the "
                         "'field' route through K3)")
    B = srcs.shape[0]
    if s.ndim == grid.ndim:
        s = s.expand((B,) + grid.shape)
    if tuple(s.shape) != (B,) + grid.shape:
        raise ValueError(f"slowness {tuple(s.shape)} vs {B} sources on grid "
                         f"{grid.shape}")
    s = s.contiguous()
    T0, frozen = seed_source(s, srcs, grid, config.seed_radius)
    if config.method == "jacobi":
        return jacobi_solve(T0, frozen, s, grid.spacing, config.tol,
                            config.max_iters)
    if impl == "xla":
        return sweep_solve(T0, seed_floor(T0, frozen), s, grid.spacing,
                           config.tol, config.max_iters, config.n_inner,
                           cycle=sweep_cycle_plain)
    scal = torch.cat(source_scalars(s, srcs, grid), dim=1).contiguous()
    return cuda_sweep.solve(T0, s, scal, grid.spacing, config.tol,
                            config.max_iters, config.n_inner,
                            seed_radius=config.seed_radius,
                            cycles_per_iter=CYCLES_PER_ITER[impl])
