"""Eikonal solvers: Godunov local solve, plain plane sweeps, the CUDA sweep
kernel and the batched entry point; the implicit adjoint with its plain
transport sweeps and the CUDA transport kernel."""

from mceik_tpu_torch.eikonal.batched import solve_eikonal_batched  # noqa: F401
from mceik_tpu_torch.eikonal.solve import EikonalConfig  # noqa: F401
