"""Typed, nested run configuration.

Counterpart of ``mceik_tpu/config.py``: the same frozen dataclasses with
the same fields and defaults, so every ``configs/*.json`` loads unchanged.
Fields whose feature the port does not run yet stay, and the code that
would read them raises ``NotImplementedError`` naming the feature.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from mceik_tpu_torch.grid import Grid


@dataclasses.dataclass(frozen=True)
class GridCfg:
    shape: Tuple[int, ...] = (65, 65)
    spacing: Tuple[float, ...] = (1.0, 1.0)
    origin: Tuple[float, ...] = None  # type: ignore[assignment]

    def build(self) -> Grid:
        return Grid(shape=self.shape, spacing=self.spacing, origin=self.origin)


@dataclasses.dataclass(frozen=True)
class EikonalCfg:
    # "sweep" (plane sweeps: the kernels' solve on the card) or "jacobi"
    # (the plain Jacobi solve, on every route and device).
    method: str = "sweep"
    tol: float = 1e-4
    max_iters: int = 50
    n_inner: int = 2
    seed_radius: float = 3.0
    # Sweep kernel selection. "auto"/"on": the CUDA kernel for CUDA tensors
    # (the plain torch sweep for CPU tensors); "off": the plain torch sweep
    # on any device; "interpret" (a Pallas mode) is refused.
    use_pallas: str = "auto"


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    """Probabilistic model.

    mode: "tomo" (slowness only, known sources), "joint" (slowness +
    hypocenters + origin times) or "locate" (hypocenters over a fixed
    slowness). The port runs all three under every noise model.
    """

    mode: str = "tomo"
    inv_shape: Tuple[int, ...] = (16, 16)
    background_slowness: float = 1.0
    prior_sigma_u: float = 0.5
    # Observation noise: "fixed", "hierarchical" (sigma * exp(log_sigma),
    # log_sigma ~ N(0, sigma_hyper^2), one or per station) or "spike_slab"
    # (per station, indicator z ~ Bernoulli(noise_p0) switches between
    # sigma and sigma * exp(log_sigma), log_sigma ~ N(noise_slab_mu,
    # sigma_hyper^2): a slab centred on genuine inflation, e^2 ~ 7.4x);
    # hierarchical_noise=True means "hierarchical".
    sigma: float = 0.01
    noise_model: Optional[str] = None
    hierarchical_noise: bool = False
    sigma_hyper: float = 1.0
    per_station_noise: bool = False
    noise_p0: float = 0.1
    noise_slab_mu: float = 2.0

    def resolved_noise_model(self) -> str:
        if self.noise_model is not None:
            return self.noise_model
        return "hierarchical" if self.hierarchical_noise else "fixed"
    prior_sigma_t0: float = 1.0
    marginalize_t0: bool = False
    fixed_slowness_path: Optional[str] = None
    table_cache_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SamplerCfg:
    algorithm: str = "rwm"  # rwm | am | am_full | pcn | hmc | nuts | mala | smc
    n_chains: int = 4
    n_warmup: int = 500
    n_samples: int = 1000
    thin: int = 1
    seed: int = 0
    target_accept: float = 0.234
    step_size: float = 0.02
    n_leapfrog: int = 16
    max_tree_depth: int = 6
    n_particles: int = 1024
    ess_threshold: float = 0.5
    n_mutation_steps: int = 5
    use_pcn: bool = False
    precondition: str = "laplace"
    n_map_steps: int = 150


@dataclasses.dataclass(frozen=True)
class DataCfg:
    dataset: str = "crosswell2d"
    path: Optional[str] = None
    stations_path: Optional[str] = None
    arrivals_path: Optional[str] = None
    n_src: int = 8
    n_rec: int = 12
    n_events: int = 0
    n_stations: int = 0
    noise: float = 0.01
    seed: int = 1234
    checker_cells: Tuple[int, ...] = (4, 4)
    checker_amplitude: float = 0.15


@dataclasses.dataclass(frozen=True)
class DistCfg:
    chain_axis: str = "chains"
    n_devices: Optional[int] = None
    multihost: bool = False


@dataclasses.dataclass(frozen=True)
class IOCfg:
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0  # steps; 0 disables
    resume: Optional[str] = None
    log_every: int = 100
    profile_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class RunConfig:
    grid: GridCfg = GridCfg()
    eikonal: EikonalCfg = EikonalCfg()
    model: ModelCfg = ModelCfg()
    sampler: SamplerCfg = SamplerCfg()
    data: DataCfg = DataCfg()
    dist: DistCfg = DistCfg()
    io: IOCfg = IOCfg()
