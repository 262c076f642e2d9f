"""Hypocentre grid search over precomputed station tables.

Counterpart of ``mceik_tpu/forward/locate.py``. For each event the
origin-time-marginalised Gaussian misfit is evaluated at every grid node at
once (the tables hold the traveltime from each station to every node, by
reciprocity) and the best node is taken: one ``(n_sta, n_nodes)``
reduction per event, which the JAX package leaves to XLA and the port
leaves to plain torch on the tables' device. Events go in chunks, so that
memory stays bounded at catalogue sizes (4096 events x 16 stations x 48 x
48 x 32 nodes would be ~19 GB as one tensor); the chunk changes no result.
Used to start chains near the likelihood's mode and as the standalone
locate tool.
"""

from __future__ import annotations

from typing import Optional

import torch

from mceik_tpu_torch.grid import Grid

# Bytes of one (chunk, n_sta, n_nodes) fp32 intermediate; a chunk holds a
# few of them at once.
CHUNK_BYTES = 256 * 2 ** 20


def locate_grid_search(station_tables: torch.Tensor, t_obs: torch.Tensor,
                       grid: Grid, sigma: float = 1.0,
                       mask: Optional[torch.Tensor] = None,
                       chunk: Optional[int] = None):
    """Maximum-likelihood hypocentres on the grid.

    Args:
      station_tables: ``(n_sta,) + grid.shape`` traveltime fields.
      t_obs: ``(n_ev, n_sta)`` observed arrivals.
      mask: optional ``(n_ev, n_sta)`` observation mask.
      chunk: events per reduction (default: as many as keep one
        ``(chunk, n_sta, n_nodes)`` fp32 tensor within ``CHUNK_BYTES``).

    Per event: ``t0* = sum(mask * (t_obs - T)) / max(sum(mask), 1)`` at
    every node, the masked SSE of the residuals about it, the first node of
    least SSE, and there ``t0*`` and ``loglik = -0.5 * SSE / sigma^2``.

    Returns a dict with ``hypo`` ``(n_ev, D)`` physical coords, ``t0``
    ``(n_ev,)``, ``loglik`` ``(n_ev,)`` and ``node`` ``(n_ev,)``, the flat
    index of the chosen node.
    """
    n_sta = station_tables.shape[0]
    Tt = station_tables.reshape(n_sta, -1)              # (n_sta, n_nodes)
    n_nodes = Tt.shape[1]
    t_obs = t_obs.to(Tt)
    mask = torch.ones_like(t_obs) if mask is None else mask.to(Tt)
    if chunk is None:
        chunk = max(1, CHUNK_BYTES // (4 * n_sta * n_nodes))
    nodes, t0s, sses = [], [], []
    for a in range(0, t_obs.shape[0], chunk):
        tobs_c, mask_c = t_obs[a:a + chunk], mask[a:a + chunk]
        r = tobs_c[:, :, None] - Tt[None]               # (c, n_sta, n_nodes)
        w = mask_c[:, :, None]
        n = torch.clamp(mask_c.sum(1), min=1.0)         # (c,)
        t0 = (w * r).sum(1) / n[:, None]                # (c, n_nodes)
        resid = (r - t0[:, None, :]) * w
        del r
        sse = (resid * resid).sum(1)                    # (c, n_nodes)
        del resid
        node = torch.argmin(sse, dim=1)
        nodes.append(node)
        t0s.append(t0.gather(1, node[:, None])[:, 0])
        sses.append(sse.gather(1, node[:, None])[:, 0])
    node = torch.cat(nodes)
    ll = -0.5 * torch.cat(sses) / (sigma * sigma)
    idx = torch.stack(torch.unravel_index(node, grid.shape), dim=-1)
    hypo = grid.to_physical_coords(idx.to(torch.float32))
    return {"hypo": hypo, "t0": torch.cat(t0s), "loglik": ll, "node": node}
