"""Top-level API: ``run(config, device) -> RunSummary``.

Counterpart of ``mceik_tpu/api.py`` for the tomo, joint and locate
posteriors under fixed, hierarchical or spike-slab noise: config -> grid ->
synthetic or loaded data -> posterior -> sampler (rwm, am, am_full, pcn,
mala, hmc or nuts; MALA with an optional Laplace preconditioner, and hmc,
nuts and pcn optionally in the whitened coordinates of a Laplace fit),
sampled in segments of ``io.log_every`` steps with one JSONL metrics
record per segment (plus one for the Laplace setup and one for the initial
states), then pooled moments and diagnostics. Welford moments carry across
segments, so segmentation never changes the statistics. Under spike-slab
noise every step is the continuous kernel followed by the exact Gibbs scan
over the station indicators, and the warmup anneals the scan's odds
(``spike_slab_warmup``).

With ``io.checkpoint_path`` the whole sampler state (every chain's state,
the adaptation state and the generator's state) is written atomically
every ``io.checkpoint_every`` steps (which also bounds a segment) and at
the end; ``io.resume`` restores it, skips the warmup (and MALA's Laplace
setup, whose pinned covariance is in the restored hyper) and continues the
interrupted run's random stream, where the reference re-derives its keys
from the seed. SMC has its own entry point,
``samplers.smc.run_smc_config``, which the CLI calls.

Under a multi-process launcher (``torchrun``) the chains are sharded over
the ranks (``dist/mesh.py``): every rank sets up the same posterior and
draws every chain's start, keeps its own rows, and takes the unsharded
run's draws; the adaptation pools every rank's chains, and rank 0 writes
the records, the summary and the checkpoint (the global chain batch, which
resumes sharded or not). A chain count that does not divide over the ranks
runs unsharded on every rank, rank 0 reporting. With ``io.profile_dir``
rank 0 writes a ``torch.profiler`` trace of the second segment there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from mceik_tpu_torch.config import RunConfig
from mceik_tpu_torch.datasets import make_dataset
from mceik_tpu_torch.diag.ess import ess, ess_per_param, split_rhat
from mceik_tpu_torch.diag.moments import welford_finalize, welford_merge_chains
from mceik_tpu_torch.dist.mesh import (Mesh, chain_mesh, gather_chains,
                                       init_distributed, shard_chains)
from mceik_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from mceik_tpu_torch.io.metrics import MetricsLogger
from mceik_tpu_torch.io.trace import profiler, write_trace
from mceik_tpu_torch.model.params import Params, box_logjac
from mceik_tpu_torch.model.posterior import build_posterior, noise_gibbs_draws
from mceik_tpu_torch.samplers import am, am_full, hmc, mala, nuts, pcn, rwm
from mceik_tpu_torch.samplers.base import (MCMCResult, draw_normal_uniform,
                                           init_chain_states, run_mcmc)
from mceik_tpu_torch.utils import tree_map

SAMPLERS = ("rwm", "am", "am_full", "pcn", "mala", "hmc", "nuts")


@dataclasses.dataclass
class RunSummary:
    """Host-side results: pooled posterior moments + diagnostics."""

    config: RunConfig
    result: MCMCResult               # last segment (device tensors)
    samples: Any                     # concatenated thinned draws (numpy)
    post_mean: Dict[str, Any]        # pooled posterior means of tracked fields
    post_var: Dict[str, Any]
    accept_rate: float
    rhat_max: float
    ess_logpost: float
    wall_time_s: float
    samples_per_sec: float           # raw chain-steps/s (all chains)
    eff_samples_per_sec: float       # ESS(logpost)/s
    truth: Dict[str, Any]
    recovery_corr: Optional[float]
    ess_param_min: float = float("nan")
    ess_param_median: float = float("nan")


def _check_supported(config: RunConfig) -> None:
    """Refuse, naming the feature, what the port does not run yet."""
    scfg = config.sampler
    if scfg.algorithm == "smc":
        raise ValueError("sampler 'smc' has its own entry point: "
                         "samplers.smc.run_smc_config (what the CLI runs)")
    if scfg.algorithm not in SAMPLERS:
        raise ValueError(f"unknown sampler {scfg.algorithm!r}: the port runs "
                         f"{', '.join(SAMPLERS)} and smc")
    check_run_options(config)
    check_noise_options(config)


def check_run_options(config: RunConfig) -> None:
    """Warn, before any setup, where the dist options fall back: several
    devices (``dist.n_devices``) or ``dist.multihost`` asked for without a
    multi-process launcher (``WORLD_SIZE`` unset or 1) run as one process
    on the requested device, as the reference's ``init_distributed`` falls
    back when no coordinator answers. Under a launcher the ranks shard
    (``dist.mesh.init_distributed``)."""
    dist = config.dist
    world = int(os.environ.get("WORLD_SIZE", "") or 1)
    if world <= 1 and ((dist.n_devices or 1) > 1 or dist.multihost):
        warnings.warn(
            f"dist.n_devices={dist.n_devices}, dist.multihost="
            f"{dist.multihost} but no multi-process launcher (WORLD_SIZE "
            "unset or 1): continuing as one process on the requested device")


def check_noise_options(config: RunConfig) -> None:
    """The reference's refusals under spike-slab noise, with its reasons
    (``run`` and the profiler call it before any setup)."""
    if config.model.resolved_noise_model() != "spike_slab":
        return
    scfg = config.sampler
    if scfg.algorithm in ("hmc", "nuts", "pcn") and \
            scfg.precondition == "whitened":
        raise ValueError(
            "spike_slab noise is not supported with "
            "precondition='whitened': the indicator Gibbs sweep operates on "
            "model params while the chain state lives in whitened "
            "coordinates")
    if scfg.algorithm == "pcn":
        raise ValueError(
            "spike_slab noise is not supported with the pcn sampler (its "
            "state tracks log_lik, not the full posterior, and "
            "prior-reversible rotation is undefined for indicators)")
    if scfg.algorithm == "mala":
        raise ValueError(
            "spike_slab noise is not supported with the mala sampler: the "
            "indicator Gibbs sweep changes the likelihood weights behind "
            "MALA's cached gradient (MALAState.grad), which would bias the "
            "Langevin drift; use hmc/nuts (recompute gradients every "
            "leapfrog) or am/am_full")


def prepare_device(device) -> torch.device:
    """The run's device, with fp32 matmuls and convolutions (no TF32:
    bf16/TF32 are too coarse at sigma ~ 0.01 s). A missing card raises
    rather than falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device (pass --device cpu to run on the CPU)")
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _logpost_stats(logpost: torch.Tensor) -> dict:
    lp = _to_numpy(logpost)
    return {"logpost_mean": round(float(lp.mean()), 3),
            "logpost_min": round(float(lp.min()), 3),
            "logpost_max": round(float(lp.max()), 3)}


def _step_size_of(hyper) -> float:
    """The logged step: exp(log step) for rwm, am, am_full and mala, the
    dual-averaged leapfrog step for hmc and nuts, and rho itself (not the
    reference's odds rho / (1 - rho)) for pcn."""
    if isinstance(hyper, pcn.PCNHyper):
        return float(torch.sigmoid(hyper.log_rho))
    if isinstance(hyper, hmc.HMCHyper):
        return float(torch.exp(hyper.da.log_eps))
    return float(torch.exp(hyper.log_step))


def _uses_gradients(scfg) -> bool:
    """hmc, nuts and mala take gradients; whitened pcn's Laplace setup
    does (its steps do not)."""
    return (scfg.algorithm in ("hmc", "nuts", "mala")
            or (scfg.algorithm == "pcn" and scfg.precondition == "whitened"))


def _laplace(posterior, scfg, logger):
    """The Laplace setup (MAP + Gauss-Newton covariance) with its JSONL
    record; returns ``(p_map, cov)``."""
    from mceik_tpu_torch.model.laplace import laplace_preconditioner
    t0 = time.perf_counter()
    p_map, cov, trace = laplace_preconditioner(posterior,
                                               n_map_steps=scfg.n_map_steps)
    if logger is not None:
        logger.log({"phase": "laplace",
                    "seconds": round(time.perf_counter() - t0, 3),
                    "n_trace": len(trace),
                    "logpost_first": round(trace[0], 3),
                    "logpost_last": round(trace[-1], 3)})
    return p_map, cov


def _gradient_kernel(scfg, logpost_fn, mesh: Mesh):
    if scfg.algorithm == "hmc":
        return hmc.make_kernel(logpost_fn, scfg.n_leapfrog)
    return nuts.make_kernel(logpost_fn, scfg.max_tree_depth, mesh=mesh)


def _dispatch_sampler(scfg, posterior, gen: torch.Generator, logger,
                      resuming: bool = False, mesh: Mesh = Mesh()):
    """Returns ``(kernel, adapter, hyper, finalize_fn, states, params_of)``,
    with the chains initialised (RWM has no finalize). ``params_of`` maps
    whitened chain states to model params, and is None when the states are
    model params. MALA carries cached gradients; with
    ``precondition="laplace"`` the MAP and Gauss-Newton covariance are
    computed once here and pinned, and the chains start at the MAP plus
    0.3x Laplace jitter. hmc, nuts and pcn with ``precondition="whitened"``
    run in the Laplace fit's whitened coordinates (``model/whitened.py``).

    ``resuming``: the states and hyper will be restored from a checkpoint,
    so MALA skips its Laplace setup (the pinned covariance is in the
    restored hyper) and the states and hyper here only give the structure.
    The whitened samplers cannot skip theirs: the map from whitened to
    model coordinates lives in the kernel, not in the checkpointed state,
    and the setup rebuilds it from the same seeded ascent.

    The states are every chain's (on every rank); ``mesh`` is what NUTS
    decides its loop exits over."""
    scales = posterior.prior_scales
    lp = posterior.logpost
    algo = scfg.algorithm
    if algo in ("hmc", "nuts", "pcn") and scfg.precondition == "whitened":
        from mceik_tpu_torch.model.whitened import whitened_view
        wv = whitened_view(posterior, *_laplace(posterior, scfg, logger))
        if algo == "pcn":
            # Generalized pCN: unit reference in the whitened coordinates,
            # acceptance on the non-Gaussian residual alone.
            states = init_chain_states(wv.resid_u, wv.init_u, gen,
                                       scfg.n_chains)
            return (pcn.make_kernel(wv.resid_u),
                    pcn.make_adapter(scfg.target_accept),
                    pcn.init_hyper(wv.scales_u, None, scfg.step_size),
                    pcn.finalize, states, wv.params_of)
        states = init_chain_states(wv.logpost_u, wv.init_u, gen,
                                   scfg.n_chains)
        target = max(scfg.target_accept, 0.7 if algo == "hmc" else 0.8)
        return (_gradient_kernel(scfg, wv.logpost_u, mesh),
                hmc.make_adapter(target),
                hmc.init_hyper(wv.scales_u, scfg.step_size, wv.zero_u),
                hmc.finalize, states, wv.params_of)
    if algo == "mala":
        target = max(scfg.target_accept, 0.574)
        hyper = mala.init_hyper(scales, scfg.step_size)
        init_fn = posterior.init_params
        adapt_cov = True
        if scfg.precondition == "laplace" and resuming:
            adapt_cov = False
        elif scfg.precondition == "laplace":
            p_map, cov = _laplace(posterior, scfg, logger)
            hyper = mala.prime_covariance(hyper, cov)
            adapt_cov = False
            x_map = mala._ravel(p_map, batch_dims=1)            # (1, d)
            active = (mala._ravel(scales) > 0).to(torch.float32)
            L_init = torch.linalg.cholesky(cov)
            unravel = mala._unravel_fn(p_map, batch_dims=1)

            def init_fn(gen, n):
                # MAP + 0.3x Laplace jitter: full draws from the Laplace
                # fit land far out in the soft, prior-dominated subspace
                # where the forward model is most nonlinear (reference
                # api.py); burn-in is discarded as usual.
                eps = active * torch.randn((n, x_map.shape[1]), generator=gen,
                                           dtype=torch.float32,
                                           device=x_map.device)
                return unravel(x_map + 0.3 * (eps @ L_init.T))

        states = mala.init_states(lp, init_fn, gen, scfg.n_chains)
        return (mala.make_kernel(lp), mala.make_adapter(target,
                                                        adapt_cov=adapt_cov),
                hyper, mala.finalize, states, None)
    if algo == "pcn":
        # Gaussian leaves by pCN against the prior; hypocentres by a random
        # walk whose logistic prior enters the acceptance.
        nongauss = None
        rw_scales = None
        if scales.hypo_raw is not None:
            nongauss = lambda p: box_logjac(p.hypo_raw)
            rw_scales = Params(hypo_raw=torch.ones_like(scales.hypo_raw))
        gauss_scales = dataclasses.replace(scales, hypo_raw=None)

        def state_lp(p):
            ll = posterior.log_lik(p)
            return ll if nongauss is None else ll + nongauss(p)

        states = init_chain_states(state_lp, posterior.init_params, gen,
                                   scfg.n_chains)
        return (pcn.make_kernel(posterior.log_lik, nongauss),
                pcn.make_adapter(scfg.target_accept),
                pcn.init_hyper(gauss_scales, rw_scales, scfg.step_size),
                pcn.finalize, states, None)
    states = init_chain_states(lp, posterior.init_params, gen, scfg.n_chains)
    if algo in ("hmc", "nuts"):
        target = max(scfg.target_accept, 0.7 if algo == "hmc" else 0.8)
        return (_gradient_kernel(scfg, lp, mesh), hmc.make_adapter(target),
                hmc.init_hyper(scales, scfg.step_size, scales), hmc.finalize,
                states, None)
    if algo == "rwm":
        return (rwm.make_kernel(lp), rwm.make_adapter(scfg.target_accept),
                rwm.init_hyper(scales, scfg.step_size), None, states, None)
    if algo == "am_full":
        return (am_full.make_kernel(lp), am_full.make_adapter(scfg.target_accept),
                am_full.init_hyper(scales, scfg.step_size),
                am_full.finalize, states, None)
    example = tree_map(lambda x: x[0], states.params)
    return (am.make_kernel(lp), am.make_adapter(scfg.target_accept),
            am.init_hyper(scales, scfg.step_size, example), am.finalize,
            states, None)


def _wrap_noise_gibbs(kernel, gibbs, beta: float = 1.0):
    """Compose a continuous kernel with the exact trans-dimensional noise
    Gibbs scan (``PosteriorModel.noise_gibbs``): the continuous move, then
    the indicator scan and the pseudo-prior refresh, the logpost updated
    from the same residuals. ``beta`` tempers only the indicator odds
    (warmup annealing); the state's logpost is always the un-tempered
    posterior. The composed kernel takes the base kernel's draws followed
    by the scan's uniforms and normals (its ``draw`` gives them)."""
    base_draw = getattr(kernel, "draw", draw_normal_uniform)

    def composed(state, hyper, base_draws, uniforms, fresh):
        state, info = kernel(state, hyper, *base_draws)
        params, lp_prior, lp_lik = gibbs(state.params, uniforms, fresh, beta)
        return dataclasses.replace(state, params=params,
                                   logpost=lp_prior + lp_lik), info

    def draw(gen: torch.Generator, state):
        base = base_draw(gen, state)
        return (base,) + noise_gibbs_draws(gen, state.params)

    composed.draw = draw
    return composed


def spike_slab_warmup(base_kernel, gibbs, adapter, states, hyper,
                      gen: torch.Generator, n_warmup: int, finalize_fn=None,
                      betas=(0.05, 0.2, 0.5, 1.0), mesh: Mesh = Mesh()):
    """Annealed-Gibbs warmup for spike-slab noise: the indicator odds are
    tempered up the ladder ``betas``, ``n_warmup // len(betas)`` adapted
    steps per rung (the last rung takes the rest) and one more step each,
    as the reference runs them. Genuinely noisy stations, whose likelihood
    ratio is huge, are flagged almost at once while clean ones keep full
    weight until the field has converged; without the ramp a transiently
    misfit clean station flips on at beta = 1 and the field loses the pull
    that would fit it. The last rung is beta = 1, so the kernel after
    warmup is the exact one. Returns ``(states, hyper)``."""
    w = max(n_warmup // len(betas), 1)
    parts = [w] * (len(betas) - 1) + [max(n_warmup - w * (len(betas) - 1), 1)]
    for beta, part in zip(betas, parts):
        r = run_mcmc(_wrap_noise_gibbs(base_kernel, gibbs, beta), adapter,
                     states, hyper, gen, n_warmup=part, n_steps=1, mesh=mesh)
        states, hyper = r.states, r.hyper
    if finalize_fn is not None:
        hyper = finalize_fn(hyper)
    return states, hyper


def with_noise_gibbs(posterior, kernel, adapter, states, hyper, finalize_fn,
                     gen: torch.Generator, n_warmup: int,
                     mesh: Mesh = Mesh()):
    """Under spike-slab noise: run the annealed warmup and return the
    continuous kernel composed with the exact Gibbs scan, with no warmup
    left. Otherwise everything as it came. Returns ``(kernel, states, hyper,
    n_warmup)``."""
    gibbs = posterior.noise_gibbs
    if gibbs is None:
        return kernel, states, hyper, n_warmup
    if n_warmup > 0:
        states, hyper = spike_slab_warmup(kernel, gibbs, adapter, states,
                                          hyper, gen, n_warmup,
                                          finalize_fn=finalize_fn, mesh=mesh)
    return _wrap_noise_gibbs(kernel, gibbs), states, hyper, 0


def _restore(path, states, hyper, gen: torch.Generator, scfg, verbose):
    """``(states, hyper)`` from the checkpoint at ``path``, with ``gen`` set
    to the checkpointed state; a checkpoint written under another
    precondition is refused (MALA would freeze a covariance that is not
    the Laplace one, and the whitened samplers' coordinates would not
    match)."""
    ck, meta = load_checkpoint(path, {"states": states, "hyper": hyper,
                                      "rng": gen.get_state()})
    ck_pre = meta.get("precondition")
    if (scfg.algorithm in ("mala", "hmc", "nuts", "pcn")
            and ck_pre is not None and ck_pre != scfg.precondition):
        raise ValueError(
            f"checkpoint {path} was written with precondition={ck_pre!r} "
            f"but this run requests {scfg.precondition!r} — refusing to "
            "resume (the preconditioner / chain coordinate system would not "
            "match the requested mode)")
    gen.set_state(ck["rng"])
    if verbose:
        print(f"[mceik-tpu-torch] resumed from {path} (meta={meta})")
    return ck["states"], ck["hyper"]


def describe_mesh(mesh: Mesh) -> str:
    """The line a sharded run starts with on rank 0: its backend and
    device."""
    return (f"[mceik-tpu-torch] dist: {mesh.world} ranks, backend "
            f"{mesh.backend}, rank 0 on {mesh.device}")


def run(config: RunConfig, device="cuda", verbose: bool = True,
        backend: Optional[str] = None) -> RunSummary:
    """Sample the config's posterior on ``device`` ("cuda" or "cpu"),
    sharded over the ranks of a multi-process launcher (``backend``: the
    process group's, "nccl" or "gloo"; by default picked by
    ``dist.mesh.pick_backend``)."""
    _check_supported(config)
    device = prepare_device(device)
    mesh = init_distributed(config.dist, device, backend)
    device = mesh.device
    if verbose and mesh.root and mesh.sharded:
        print(describe_mesh(mesh), flush=True)
    verbose = verbose and mesh.root
    cmesh = chain_mesh(mesh, config.sampler.n_chains)
    grid = config.grid.build()
    data, truth = make_dataset(grid, config.data, config.model, device=device)
    scfg, io = config.sampler, config.io
    posterior = build_posterior(config.model, data, grid, config.eikonal,
                                differentiable=_uses_gradients(scfg))

    # Resume only from a checkpoint that exists: a path not written yet
    # (checkpoint_path == resume in a restart loop) starts fresh, with the
    # whole setup.
    resuming = bool(io.resume) and os.path.exists(io.resume)
    if io.resume and not resuming and verbose:
        print(f"[mceik-tpu-torch] resume path {io.resume} does not exist "
              "— starting fresh")

    logger = MetricsLogger() if verbose else None
    gen = torch.Generator(device=device).manual_seed(scfg.seed)
    kernel, adapter, hyper, finalize_fn, states, params_of = \
        _dispatch_sampler(scfg, posterior, gen, logger, resuming, cmesh)
    n_warmup = scfg.n_warmup
    if resuming:
        states, hyper = _restore(io.resume, states, hyper, gen, scfg,
                                 verbose)
        n_warmup = 0        # the restored states are past their warmup
    collect_fn = params_of if params_of is not None else (lambda p: p)
    if logger is not None:
        logger.log({"phase": "init", "step": 0, "device": str(device),
                    **_logpost_stats(states.logpost)})
    # Every rank drew and restored every chain; from here on each holds
    # its rows.
    states = shard_chains(states, cmesh)
    n_warm_in = n_warmup
    kernel, states, hyper, n_warmup = with_noise_gibbs(
        posterior, kernel, adapter, states, hyper, finalize_fn, gen,
        n_warm_in, cmesh)
    if n_warmup < n_warm_in:
        # The annealed spike-slab warmup ran apart from the segments.
        every = gather_chains(states, cmesh)
        if logger is not None:
            logger.log({"phase": "warmup", "step": 0,
                        "noise_inclusion": round(float(
                            every.params.noise_z.mean()), 4),
                        **_logpost_stats(every.logpost)})

    # Locate mode samples no slowness: there is none to track.
    track_slowness = config.model.mode in ("tomo", "joint")

    def track_fn(params):
        # Whitened chains carry u; moments always see model params.
        p = collect_fn(params)
        out = {"params": p}
        if track_slowness:
            out["slowness"] = posterior.slowness_of(p)
        return out

    def checkpoint(step, **extra):
        # The global chain batch, written by rank 0 (every rank takes part
        # in the gather).
        every = gather_chains(states, cmesh)
        if mesh.root:
            save_checkpoint(io.checkpoint_path,
                            {"states": every, "hyper": hyper,
                             "rng": gen.get_state()},
                            meta={"step": step, "algorithm": scfg.algorithm,
                                  "precondition": scfg.precondition, **extra})

    seg = io.log_every if io.log_every > 0 else scfg.n_samples
    if io.checkpoint_every > 0:
        seg = min(seg, io.checkpoint_every)
    seg = max(1, min(seg, scfg.n_samples))
    n_seg = max(1, scfg.n_samples // seg)
    n_steps_actual = n_seg * seg

    t0 = time.perf_counter()
    seg_results = []
    welford = None
    step_done = 0
    for si in range(n_seg):
        # The reference traces the second segment (the first compiles).
        prof = (profiler(device) if io.profile_dir and si == 1 and mesh.root
                else None)
        with prof if prof is not None else contextlib.nullcontext():
            r = run_mcmc(kernel, adapter if si == 0 else None, states, hyper,
                         gen, n_warmup=n_warmup if si == 0 else 0,
                         n_steps=seg, thin=scfg.thin, track_fn=track_fn,
                         collect_fn=collect_fn,
                         finalize_fn=finalize_fn if si == 0 else None,
                         init_welford=welford, mesh=cmesh)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        if prof is not None:
            write_trace(prof, io.profile_dir, verbose, "segment 2")
        states, hyper, welford = r.states, r.hyper, r.welford
        step_done += seg
        seg_results.append(r)

        z = collect_fn(states.params).noise_z
        if z is not None:
            z = gather_chains(z, cmesh)
        last = (_to_numpy(r.logpost_trace)[-1] if len(r.logpost_trace)
                else _to_numpy(gather_chains(states.logpost, cmesh)))
        if logger is not None:
            extra = {k: round(float(r.info_trace[k].mean()), 4)
                     for k in ("divergent", "tree_depth") if k in r.info_trace}
            if z is not None:
                # Pooled inclusion rate: the share of (chain, station)
                # indicators on the slab after the segment.
                extra["noise_inclusion"] = round(float(z.mean()), 4)
            logger.log({
                "phase": "sample", "step": step_done,
                "accept": round(float(np.mean(_to_numpy(r.accept_trace))), 4),
                **extra,
                "logpost_mean": round(float(last.mean()), 3),
                "logpost_min": round(float(last.min()), 3),
                "logpost_max": round(float(last.max()), 3),
                "step_size": _step_size_of(hyper),
                "chain_steps_per_s": round(
                    step_done * scfg.n_chains / (time.perf_counter() - t0), 2),
            })
        if (io.checkpoint_path and io.checkpoint_every > 0
                and step_done % io.checkpoint_every == 0):
            checkpoint(step_done)
    wall = time.perf_counter() - t0
    if io.checkpoint_path:
        checkpoint(step_done, final=True)

    # --- host-side summary ---------------------------------------------
    kept = [r for r in seg_results if r.samples is not None]
    samples = (tree_map(lambda *xs: np.concatenate([_to_numpy(x) for x in xs]),
                        *[r.samples for r in kept]) if kept else None)
    logpost_trace = np.concatenate(
        [_to_numpy(r.logpost_trace) for r in seg_results], axis=0)
    accept_trace = np.concatenate(
        [_to_numpy(r.accept_trace) for r in seg_results], axis=0)

    mean, var = welford_finalize(welford_merge_chains(
        gather_chains(welford, cmesh)))
    post_mean = tree_map(_to_numpy, mean)
    post_var = tree_map(_to_numpy, var)

    accept = float(np.mean(accept_trace)) if accept_trace.size else float("nan")
    ess_lp = ess(logpost_trace) if logpost_trace.size else float("nan")

    probe = None
    if samples is not None:
        field = samples.u if samples.u is not None else samples.hypo_raw
        probe = field.reshape(logpost_trace.shape[0],
                              logpost_trace.shape[1], -1)
    rhat_max = (float(np.nanmax(split_rhat(probe))) if probe is not None
                else float("nan"))
    ess_min = ess_med = float("nan")
    if probe is not None:
        pe = ess_per_param(probe)
        ess_min, ess_med = float(np.min(pe)), float(np.median(pe))

    recovery = None
    if track_slowness and "slowness" in truth:
        s_mean = post_mean["slowness"]
        s_true = _to_numpy(truth["slowness"])
        a = s_mean - s_mean.mean()
        b = s_true - s_true.mean()
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        recovery = float((a * b).sum() / denom) if denom > 0 else 0.0

    n_total_steps = n_steps_actual * scfg.n_chains
    summary = RunSummary(
        config=config, result=seg_results[-1], samples=samples,
        post_mean=post_mean, post_var=post_var,
        accept_rate=accept, rhat_max=rhat_max, ess_logpost=ess_lp,
        wall_time_s=wall, samples_per_sec=n_total_steps / wall,
        eff_samples_per_sec=ess_lp / wall,
        truth={k: _to_numpy(v) for k, v in truth.items()},
        recovery_corr=recovery, ess_param_min=ess_min,
        ess_param_median=ess_med,
    )
    if verbose:
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        print(f"[mceik-tpu-torch] {scfg.algorithm} chains={scfg.n_chains} "
              f"warmup={n_warmup} samples={n_steps_actual} device={name} "
              f"wall={wall:.2f}s accept={accept:.3f} rhat={rhat_max:.3f} "
              f"ess(logpost)={ess_lp:.1f} ess(param min/med)={ess_min:.1f}"
              f"/{ess_med:.1f} samples/s={summary.samples_per_sec:.1f} "
              + (f"recovery_corr={recovery:.3f}" if recovery is not None
                 else ""))
    return summary
