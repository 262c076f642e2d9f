"""Synthetic dataset generators (the 2-D crosswell of configs 1 and 4, the
3-D checkerboards of config 2 and the joint events problems of config 3)."""

from mceik_tpu_torch.datasets.synthetic import (  # noqa: F401
    checkerboard3d_dataset,
    checkerboard_slowness,
    crosswell_dataset,
    events_dataset,
    make_dataset,
)
