"""mceik_tpu_torch: the PyTorch + CUDA port of mceik-tpu.

Bayesian eikonal traveltime tomography on an NVIDIA GPU. The JAX package
``mceik_tpu`` beside this one is the reference: every module here mirrors
its counterpart's path (``mceik_tpu/eikonal/solve.py`` ->
``mceik_tpu_torch/eikonal/solve.py``) and is tested against it on the CPU.

- ``eikonal``  — Godunov local solver, plain plane-sweep solve (the CPU path
  and the kernels' reference), the plain Jacobi solve
  (``method="jacobi"``), the hand-written CUDA sweep kernels, 3-D
  (``eikonal/cuda_sweep.py`` + ``csrc/sweep3d.cu``) and 2-D
  (``eikonal/cuda_sweep2d.py`` + ``csrc/sweep2d.cu``), and the batched entry;
  the differentiable solve through the implicit adjoint
  (``eikonal/adjoint.py``), its plain transport sweeps
  (``eikonal/adjoint_sweep.py``) and the CUDA transport kernel
  (``eikonal/cuda_transport.py`` + ``csrc/transport3d.cu``).
- ``forward``  — traveltime tables and receiver interpolation.
- ``model``    — parameters, data containers, the tomo posterior (with
  gradients and the Gauss-Newton Jacobian), the Laplace fit.
- ``samplers`` — the generic MCMC runner, dual averaging, random-walk
  Metropolis, adaptive Metropolis (diagonal and full covariance),
  preconditioned MALA, and tempered SMC (its own entry point).
- ``dist``     — ranks under ``torchrun`` (``torch.distributed``): chain and
  particle sharding, the collectives, sharded resampling, the dryrun; the
  grid-sharded solve (``eikonal/dist_sweep.py``) and the station reshard
  of its tables (``forward/reshard.py``).
- ``diag``     — Welford moments, R-hat and ESS; a device profile of
  sampler steps or SMC stages (``python -m mceik_tpu_torch.diag.profile``);
  the golden-run acceptance harness (``diag/golden.py``, ``python -m
  mceik_tpu_torch.diag.golden check``) and the on-card sanity check of
  every batched route (``python -m mceik_tpu_torch.diag.sanity``).
- ``native``   — the C++ serial fast-sweeping oracle (``native/fsm.cc``),
  built by g++ at first use and bound with ctypes.
- ``io``       — JSON configs with dotted overrides, JSONL metrics.
- ``api`` / ``cli`` — ``python -m mceik_tpu_torch run <config>``.

This package imports neither ``jax`` nor ``mceik_tpu``; only its tests
import both. Batch dimensions are explicit: a chain step is one call over a
leading chain axis, and the forward model makes one batched eikonal solve
per step.
"""

__version__ = "0.1.0"

from mceik_tpu_torch.grid import Grid  # noqa: F401
