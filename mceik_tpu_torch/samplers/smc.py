"""Tempered-likelihood Sequential Monte Carlo. Config 4's sampler.

Counterpart of ``mceik_tpu/samplers/smc.py`` on one device. Particles start
as exact prior draws; the inverse temperature beta climbs 0 -> 1 on an
adaptive ladder (each increment chosen by bisection so that the incremental
weights keep the ESS at ``ess_threshold * N``); each stage reweights,
resamples systematically and rejuvenates with K random-walk Metropolis steps
targeting ``log_prior + beta * log_lik``, whose shared proposal scale follows
the acceptance pooled over all particles. Under spike-slab noise each
mutation step is followed by the posterior's Gibbs scan over the station
indicators, its odds tempered by the same beta. One mutation step is one
batched log-likelihood over the whole population: at config 4, 10,000
particles x 8 sources = 80,000 fields in one solve. The log-evidence estimate
``log Z = sum_t logmeanexp(incremental log-weights)`` comes for free.

:func:`mutate` and :func:`reweight_resample` take their random draws as
tensors, as the MCMC kernels do, so a test can replay JAX's draws. As in the
reference, beta and its increments enter the device arithmetic in fp32.
With a checkpoint path, the population, the generator's state and the
ladder (stage, beta, log Z, the betas, ESS and acceptance histories) are
written after every stage, so a resumed run continues the ladder and its
random stream: killed after stage k and resumed, it ends with the
uninterrupted run's result.

Sharded over ranks (a ``mesh``, ``dist/mesh.py``: config 4's particles over
the cards) each rank holds its rows of the population and mutates them.
Every rank draws the whole population's random numbers and keeps its rows,
the log-likelihoods are all-gathered for the ladder (the ``next_beta``
bisection, the ESS, log Z and the resampling indices), the acceptance is
pooled over every rank's particles, and the resampled rows come from the
all-gathered population: every rank walks the unsharded run's ladder. Rank 0
writes the checkpoint, which holds the global population, and the result
holds the global population on every rank. With ``io.profile_dir`` rank 0
writes a ``torch.profiler`` trace of the second stage.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from mceik_tpu_torch.dist.mesh import (Mesh, all_gather0, chain_mesh,
                                       draw_rows, gather_chains,
                                       init_distributed, shard_chains)
from mceik_tpu_torch.dist.resample import (ess_from_log_weights, resample_tree,
                                           systematic_indices)
from mceik_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from mceik_tpu_torch.io.trace import (device_tensor, host_float, profiler,
                                      span, write_trace)
from mceik_tpu_torch.model.posterior import noise_gibbs_draws
from mceik_tpu_torch.utils import (tree_leaves, tree_map, tree_random_normal,
                                   tree_where)


@dataclasses.dataclass
class SMCState:
    params: Any                 # particle-batched tree
    log_prior: torch.Tensor     # (N,)
    log_lik: torch.Tensor       # (N,)
    log_step: torch.Tensor      # mutation proposal log-scale (shared)


@dataclasses.dataclass
class SMCResult:
    state: SMCState
    betas: List[float]
    ess_history: List[float]
    accept_history: List[float]
    log_evidence: float
    n_stages: int
    stage_seconds: List[float] = dataclasses.field(default_factory=list)


def _f32(x: float, device) -> torch.Tensor:
    return device_tensor(x, torch.float32, device)


def init_particles(posterior, gen: torch.Generator, n_particles: int,
                   step_size: float = 0.1, mesh: Mesh = Mesh()) -> SMCState:
    """``n_particles`` exact prior draws with their log prior and log
    likelihood (one batched solve of the population; sharded, of this
    rank's rows of it)."""
    with span("mceik.smc.init"):
        params = shard_chains(posterior.sample_prior(gen, n_particles), mesh)
        ll = posterior.log_lik(params)
        return SMCState(params=params, log_prior=posterior.log_prior(params),
                        log_lik=ll,
                        log_step=_f32(math.log(step_size), ll.device))


def mutate(state: SMCState, beta: float, scales: Any, log_prior_fn: Callable,
           log_lik_fn: Callable, normals: Sequence[Any],
           uniforms: torch.Tensor, target_accept: float = 0.234,
           gibbs_fn: Optional[Callable] = None,
           gibbs_draws: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
           mesh: Mesh = Mesh()) -> Tuple[SMCState, torch.Tensor]:
    """K tempered RWM steps over all particles, K = ``len(normals)``.

    ``normals``: K trees like the params (one standard normal per particle
    and coordinate); ``uniforms``: ``(K, N)``. ``gibbs_fn`` (the
    posterior's ``noise_gibbs``) runs after each step with the step's
    ``gibbs_draws`` pair (uniforms and normals, ``(N, n_sta)`` each) and
    the stage's beta, so indicator moves mix inside SMC too. Between steps
    the shared log-step moves by ``0.3 * (pooled accept prob - target)``.
    Sharded, the draws are this rank's rows and the acceptance is pooled
    over every rank's particles. Returns the new state and the mean pooled
    acceptance over the K steps."""
    with span("mceik.smc.mutate"):
        b = _f32(beta, state.log_lik.device)
        params, lp_prior, lp_lik, log_step = (state.params, state.log_prior,
                                              state.log_lik, state.log_step)
        pooled_all = []
        for k, (normal, uniform) in enumerate(zip(normals, uniforms)):
            step = torch.exp(log_step)
            prop = tree_map(lambda x, e, s: x + step * s * e, params, normal,
                            scales)
            prop_prior = log_prior_fn(prop)
            prop_lik = log_lik_fn(prop)
            log_ratio = (prop_prior + b * prop_lik) - (lp_prior + b * lp_lik)
            accept_prob = torch.exp(torch.clamp(log_ratio, max=0.0))
            accept = torch.log(uniform) < log_ratio
            params = tree_where(accept, prop, params)
            lp_prior = torch.where(accept, prop_prior, lp_prior)
            lp_lik = torch.where(accept, prop_lik, lp_lik)
            if gibbs_fn is not None:
                params, lp_prior, lp_lik = gibbs_fn(params, *gibbs_draws[k], b)
            pooled = all_gather0(accept_prob, mesh).mean()
            log_step = log_step + 0.3 * (pooled - target_accept)
            pooled_all.append(pooled)
        return (SMCState(params=params, log_prior=lp_prior, log_lik=lp_lik,
                         log_step=log_step), torch.stack(pooled_all).mean())


def _incremental(log_lik: torch.Tensor, beta_prev: float,
                 beta: float) -> torch.Tensor:
    """Incremental log-weights ``(beta - beta_prev) * log_lik``, the
    increment taken in fp32 as the reference's jitted stage does."""
    dev = log_lik.device
    return (_f32(beta, dev) - _f32(beta_prev, dev)) * log_lik


def ess_at(log_lik: torch.Tensor, beta_prev: float, beta: float) -> float:
    return host_float(ess_from_log_weights(
        _incremental(log_lik, beta_prev, beta)))


def reweight_resample(state: SMCState, beta_prev: float, beta: float,
                      u: torch.Tensor, mesh: Mesh = Mesh()
                      ) -> Tuple[SMCState, torch.Tensor]:
    """Reweight by the tempering increment and resample systematically with
    the uniform offset ``u``; returns the resampled state (sharded, this
    rank's rows) and the stage's log-evidence increment ``logmeanexp(lw)``
    over the global population."""
    with span("mceik.smc.resample"):
        lw = all_gather0(_incremental(state.log_lik, beta_prev, beta), mesh)
        log_inc = torch.logsumexp(lw, 0) - math.log(lw.shape[0])
        idx = systematic_indices(lw, u)
        rows = resample_tree({"params": state.params,
                              "log_prior": state.log_prior,
                              "log_lik": state.log_lik}, idx, mesh)
        return SMCState(log_step=state.log_step, **rows), log_inc


def next_beta(log_lik: torch.Tensor, beta_prev: float, target_ess: float,
              n_bisect: int = 30) -> float:
    """Largest beta <= 1 whose incremental weights keep ESS >= target
    (bisection on the host, one device sync per probe), and at least
    ``beta_prev + 1e-6``."""
    with span("mceik.smc.next_beta"):
        if ess_at(log_lik, beta_prev, 1.0) >= target_ess:
            return 1.0
        lo, hi = beta_prev, 1.0
        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            if ess_at(log_lik, beta_prev, mid) >= target_ess:
                lo = mid
            else:
                hi = mid
        return max(lo, beta_prev + 1e-6)


def stage(posterior, state: SMCState, beta: float, gen: torch.Generator,
          n_mutation_steps: int, target_ess: float, mesh: Mesh = Mesh()):
    """One rung of the ladder: the next beta, reweight and resample, then
    ``n_mutation_steps`` tempered RWM steps. Returns ``(state, beta_new,
    ess, log_inc, accept)``, the last three as floats (the stage is done on
    the device when it returns). Sharded, ``state`` is this rank's rows
    and the ladder follows the global population."""
    with span("mceik.smc.stage"):
        dev = state.log_lik.device
        ll = all_gather0(state.log_lik, mesh)
        n = ll.shape[0]
        beta_new = next_beta(ll, beta, target_ess)
        ess = ess_at(ll, beta, beta_new)
        u = torch.rand((), generator=gen, dtype=torch.float32, device=dev)
        state, log_inc = reweight_resample(state, beta, beta_new, u, mesh)
        normals = draw_rows(lambda g, p: [tree_random_normal(g, p)
                                          for _ in range(n_mutation_steps)],
                            gen, state.params, mesh)
        uniforms = torch.rand((n_mutation_steps, n), generator=gen,
                              dtype=torch.float32, device=dev)
        uniforms = shard_chains(uniforms.T, mesh).T
        gibbs = getattr(posterior, "noise_gibbs", None)
        gibbs_draws = ()
        if gibbs is not None:
            gibbs_draws = draw_rows(
                lambda g, p: [noise_gibbs_draws(g, p)
                              for _ in range(n_mutation_steps)],
                gen, state.params, mesh)
        state, acc = mutate(state, beta_new, posterior.prior_scales,
                            posterior.log_prior, posterior.log_lik, normals,
                            uniforms, gibbs_fn=gibbs, gibbs_draws=gibbs_draws,
                            mesh=mesh)
        return state, beta_new, ess, host_float(log_inc), host_float(acc)


def run_smc(posterior, gen: torch.Generator, n_particles: int,
            n_mutation_steps: int = 5, ess_threshold: float = 0.5,
            step_size: float = 0.1, max_stages: int = 200,
            verbose: bool = False, mesh: Optional[Mesh] = None,
            checkpoint_path: Optional[str] = None,
            resume: Optional[str] = None,
            profile_dir: Optional[str] = None) -> SMCResult:
    """Full tempered SMC run, prior -> posterior (or ``max_stages``
    stages in all, a resumed run's earlier stages included). The random
    draws come from ``gen`` (on the posterior's device).

    mesh:            the ranks the particles shard over (``n_particles`` must
                     divide over them); the result holds the global
                     population on every rank.
    checkpoint_path: write the population, ``gen``'s state and the ladder
                     after every stage (atomically; rank 0).
    resume:          continue the run whose checkpoint this is, when the
                     file exists (else start fresh): the population and
                     ``gen`` are restored, so the remaining stages are the
                     uninterrupted run's, sharded or not.
    profile_dir:     write a ``torch.profiler`` trace of this run's second
                     stage there (rank 0)."""
    mesh = mesh if mesh is not None else Mesh()
    if mesh.sharded and n_particles % mesh.world:
        raise ValueError(f"n_particles={n_particles} not divisible by "
                         f"{mesh.world} ranks")
    verbose = verbose and mesh.root
    betas, ess_hist, acc_hist, seconds = [0.0], [float(n_particles)], [], []
    log_z, beta, n_stages = 0.0, 0.0, 0
    if resume and os.path.exists(resume):
        # The example only gives the structure (no solve); every leaf and
        # the generator come from the checkpoint, the global population,
        # of which this rank keeps its rows.
        params = posterior.sample_prior(gen, n_particles)
        dev = tree_leaves(params)[0].device
        zeros = torch.zeros(n_particles, dtype=torch.float32, device=dev)
        example = {"state": SMCState(params=params, log_prior=zeros,
                                     log_lik=zeros.clone(),
                                     log_step=_f32(0.0, dev)),
                   "rng": gen.get_state()}
        ck, meta = load_checkpoint(resume, example)
        state = ck["state"]
        state = dataclasses.replace(state, **shard_chains(
            {"params": state.params, "log_prior": state.log_prior,
             "log_lik": state.log_lik}, mesh))
        gen.set_state(ck["rng"])
        betas, ess_hist = list(meta["betas"]), list(meta["ess_history"])
        acc_hist = list(meta["accept_history"])
        seconds = list(meta["stage_seconds"])
        log_z, beta, n_stages = meta["log_z"], betas[-1], meta["stage"]
        if verbose:
            print(f"[smc] resumed stage={n_stages} beta={beta:.4f} "
                  f"logZ={log_z:.2f} from {resume}", flush=True)
    else:
        if resume and verbose:
            print(f"[smc] resume path {resume} does not exist — starting "
                  "fresh", flush=True)
        state = init_particles(posterior, gen, n_particles, step_size, mesh)

    def every(state):
        """The global population (every rank takes part)."""
        return dataclasses.replace(state, **gather_chains(
            {"params": state.params, "log_prior": state.log_prior,
             "log_lik": state.log_lik}, mesh))

    target_ess = ess_threshold * n_particles
    first = n_stages
    while beta < 1.0 and n_stages < max_stages:
        prof = (profiler(state.log_lik.device)
                if profile_dir and n_stages == first + 1 and mesh.root
                else None)
        t0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            state, beta, ess, log_inc, acc = stage(
                posterior, state, beta, gen, n_mutation_steps, target_ess,
                mesh)
        seconds.append(time.perf_counter() - t0)
        if prof is not None:
            write_trace(prof, profile_dir, verbose, "stage 2")
        log_z += log_inc
        n_stages += 1
        betas.append(beta)
        ess_hist.append(ess)
        acc_hist.append(acc)
        if verbose:
            print(f"[smc] stage={n_stages} beta={beta:.4f} ess={ess:.0f} "
                  f"accept={acc:.3f} logZ={log_z:.2f}", flush=True)
        if checkpoint_path:
            whole = every(state)
            if mesh.root:
                save_checkpoint(checkpoint_path,
                                {"state": whole, "rng": gen.get_state()},
                                meta={"stage": n_stages, "beta": beta,
                                      "log_z": log_z, "betas": betas,
                                      "ess_history": ess_hist,
                                      "accept_history": acc_hist,
                                      "stage_seconds": seconds})
    return SMCResult(state=every(state), betas=betas, ess_history=ess_hist,
                     accept_history=acc_hist, log_evidence=log_z,
                     n_stages=n_stages, stage_seconds=seconds)


def setup(config, device="cuda", backend: Optional[str] = None):
    """The config's data and posterior on ``device`` (this rank's card
    under a multi-process launcher), the sampler's generator there, and the
    ranks: ``(posterior, gen, mesh)``."""
    from mceik_tpu_torch.api import check_run_options, prepare_device
    from mceik_tpu_torch.datasets import make_dataset
    from mceik_tpu_torch.model.posterior import build_posterior

    check_run_options(config)
    mesh = init_distributed(config.dist, prepare_device(device), backend)
    device = mesh.device
    grid = config.grid.build()
    data, _ = make_dataset(grid, config.data, config.model, device=device)
    posterior = build_posterior(config.model, data, grid, config.eikonal)
    return posterior, torch.Generator(device=device).manual_seed(
        config.sampler.seed), mesh


def run_smc_config(config, device="cuda", verbose: bool = True,
                   max_stages: int = 200,
                   backend: Optional[str] = None) -> SMCResult:
    """CLI entry: build the config's data and posterior on ``device`` and
    run SMC, the particles sharded over the ranks of a multi-process
    launcher when their count divides (``dist.n_devices`` caps the ranks),
    as the reference's ``run_smc_config`` picks its mesh. ``max_stages``
    caps the ladder (a smoke run measures stages without walking all the
    way to beta = 1)."""
    from mceik_tpu_torch.api import describe_mesh

    posterior, gen, mesh = setup(config, device, backend)
    device = gen.device
    scfg = config.sampler
    if verbose and mesh.root and mesh.sharded:
        print(describe_mesh(mesh), flush=True)
    pmesh = chain_mesh(mesh, scfg.n_particles, "particles")
    result = run_smc(posterior, gen, scfg.n_particles,
                     n_mutation_steps=scfg.n_mutation_steps,
                     ess_threshold=scfg.ess_threshold,
                     step_size=scfg.step_size, max_stages=max_stages,
                     verbose=verbose and mesh.root, mesh=pmesh,
                     checkpoint_path=config.io.checkpoint_path,
                     resume=config.io.resume,
                     profile_dir=config.io.profile_dir)
    if verbose and mesh.root:
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        print(f"[smc] done: stages={result.n_stages} "
              f"logZ={result.log_evidence:.2f} device={name} "
              f"wall={sum(result.stage_seconds):.2f}s"
              + (f" sharded over {pmesh.world} ranks" if pmesh.sharded
                 else ""))
    return result
