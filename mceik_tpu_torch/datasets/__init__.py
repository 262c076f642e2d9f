"""Synthetic dataset generators (the 2-D crosswell of configs 1 and 4 and
the 3-D checkerboard of config 2)."""

from mceik_tpu_torch.datasets.synthetic import (  # noqa: F401
    checkerboard3d_dataset,
    checkerboard_slowness,
    crosswell_dataset,
    make_dataset,
)
