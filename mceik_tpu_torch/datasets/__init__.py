"""Synthetic dataset generators (the config-2 checkerboard so far)."""

from mceik_tpu_torch.datasets.synthetic import (  # noqa: F401
    checkerboard3d_dataset,
    checkerboard_slowness,
    make_dataset,
)
