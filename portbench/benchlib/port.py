"""The program's side of a cell: its run configuration and its posterior over
the benchmark's inputs.

The benchmark makes the data (``reference.<name>.make_data``) and hands it to
the program as the program's ``TomoData``; the program never makes its own.
The program's random stream (chain starts, proposals, particles) is seeded
with ``seed + 1``, the data's noise with ``seed``.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

PORT_GROUPS = ("grid", "eikonal", "model")


def program_seed(seed: int) -> int:
    return (seed + 1) % (1 << 63)


def run_config(cell, seed: int):
    """The port's ``RunConfig``: the configuration file's groups and the
    workload's ``sampler`` group, seeded from ``seed``."""
    from mceik_tpu_torch.io.config_io import config_from_dict

    d = {k: cell.config[k] for k in PORT_GROUPS}
    d["sampler"] = dict(cell.workload["sampler"], seed=program_seed(seed))
    return config_from_dict(d)


def posterior(cfg, data: Dict, device, differentiable: bool):
    """The program's posterior over the benchmark's data, on ``device``
    (``api.prepare_device``: fp32 matrix products, no TF32)."""
    from mceik_tpu_torch.api import prepare_device
    from mceik_tpu_torch.model.data import TomoData
    from mceik_tpu_torch.model.posterior import build_posterior

    prepare_device(device)
    td = TomoData(src_xyz=data["src"], rec_xyz=data["rec"],
                  t_obs=data["t_obs"])
    return build_posterior(cfg.model, td, cfg.grid.build(), cfg.eikonal,
                           differentiable=differentiable)


def shapes(cfg, fields_per_solve: int) -> Dict:
    """What the per-layer metrics need of the cell's shapes."""
    return {"grid": list(cfg.grid.shape), "n_inner": cfg.eikonal.n_inner,
            "fields_per_solve": fields_per_solve}


class Clock:
    """Seconds of the set-up's phases, each ended by a device sync (set-up
    only: the window takes no such sync)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.laps: Dict[str, float] = {}
        self.t = time.perf_counter()

    def lap(self, name: str):
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now
