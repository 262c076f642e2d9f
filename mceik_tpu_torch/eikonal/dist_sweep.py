"""Grid-sharded (domain-decomposed) eikonal solve over ranks.

Counterpart of ``mceik_tpu/eikonal/dist_sweep.py``. The grid is cut into
slabs along its leading axis, one per rank; each rank sweeps its slab and
exchanges one boundary plane per side per iteration with its neighbours:

    while a field is not converged (the max of the slabs' deltas):
        halo_lo = the lower neighbour's last plane    (BIG on the first rank)
        halo_hi = the upper neighbour's first plane   (BIG on the last rank)
        T_ext = [halo_lo, T_slab, halo_hi]
        T_ext = sweep_cycle(T_ext)   halo planes pinned: floor == value
        T_slab = T_ext's interior

The exchange is an all-gather of every rank's two boundary planes (the
reference's ``ppermute`` pair, in a form gloo also runs), and the delta a
max all-reduce. The local cycle is the plain torch cycle with a floor
operand, ``solve.sweep_cycle_plain``, as the reference's is XLA's
``_sweep_cycle``; the interior floor is the global seed floor's slab. The
fixed point equals the unsharded solve's.
"""

from __future__ import annotations

import torch

from mceik_tpu_torch.dist.mesh import Mesh, all_gather0, all_reduce_max
from mceik_tpu_torch.eikonal.godunov import BIG
from mceik_tpu_torch.eikonal.solve import (EikonalConfig, seed_floor,
                                           seed_source, sweep_cycle_plain)
from mceik_tpu_torch.grid import Grid


def solve_eikonal_sharded(slowness: torch.Tensor, src_xyz: torch.Tensor,
                          grid: Grid, mesh: Mesh,
                          config: EikonalConfig = EikonalConfig(),
                          return_iters: bool = False):
    """Solve with grid axis 0 cut into one slab per rank of ``mesh``.

    ``slowness`` is ``grid.shape`` with ``src_xyz`` ``(D,)``, or a batch
    ``(B,) + grid.shape`` with ``(B, D)`` sources, the whole grid on every
    rank. Each field converges on its own, at the same iteration on every
    rank (the delta is global). Returns this rank's slab,
    ``(..., n0 / world) + grid.shape[1:]``, and with ``return_iters`` also
    the iterations (cycles) run."""
    n0 = grid.shape[0]
    if n0 % mesh.world:
        raise ValueError(f"grid axis 0 ({n0}) must divide over {mesh.world} "
                         "ranks")
    single = slowness.ndim == grid.ndim
    s = slowness.reshape((-1,) + grid.shape).to(torch.float32)
    src = torch.as_tensor(src_xyz, dtype=torch.float32,
                          device=s.device).reshape(-1, grid.ndim)
    T0, frozen = seed_source(s, src, grid, config.seed_radius)
    lo, hi = mesh.rows(n0)
    T = T0[:, lo:hi]
    floor = seed_floor(T0, frozen)[:, lo:hi]
    s_slab = s[:, lo:hi]
    s_ext = torch.cat([s_slab[:, :1], s_slab, s_slab[:, -1:]], dim=1)
    big = torch.full_like(T[:, :1], BIG)
    first, last = mesh.rank == 0, mesh.rank == mesh.world - 1
    done = torch.zeros(s.shape[0], dtype=torch.bool, device=s.device)
    iters = 0
    for iters in range(1, config.max_iters + 1):
        # Every rank's first and last planes: (world, B, 2) + plane.
        ends = all_gather0(torch.stack([T[:, 0], T[:, -1]], dim=1)
                           .unsqueeze(0), mesh)
        halo_lo = big if first else ends[mesh.rank - 1, :, 1:2]
        halo_hi = big if last else ends[mesh.rank + 1, :, 0:1]
        T_ext = torch.cat([halo_lo, T, halo_hi], dim=1)
        # floor == value pins the halo planes under the monotone update.
        f_ext = torch.cat([halo_lo, floor, halo_hi], dim=1)
        T_new = sweep_cycle_plain(T_ext, s_ext, f_ext, grid.spacing,
                                  config.n_inner, done)[:, 1:-1]
        delta = all_reduce_max((T_new - T).abs().flatten(1).amax(1), mesh)
        done = done | ~(delta > config.tol)
        T = T_new
        if bool(done.all()):
            break
    T = T[0] if single else T
    return (T, iters) if return_iters else T
