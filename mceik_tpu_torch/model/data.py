"""Observed-data containers. Counterpart of ``mceik_tpu/model/data.py``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class TomoData:
    """Known source/receiver pairs (configs 1-2)."""

    src_xyz: torch.Tensor  # (n_src, D)
    rec_xyz: torch.Tensor  # (n_rec, D)
    t_obs: torch.Tensor    # (n_src, n_rec)
    mask: Optional[torch.Tensor] = None  # (n_src, n_rec) 1.0 = observed


@dataclasses.dataclass
class EventData:
    """Stations + events with unknown hypocentres (configs 3 and 5)."""

    sta_xyz: torch.Tensor  # (n_sta, D)
    t_obs: torch.Tensor    # (n_ev, n_sta)
    mask: Optional[torch.Tensor] = None  # (n_ev, n_sta)
