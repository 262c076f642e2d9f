"""Top-level API: ``run(config, device) -> RunSummary``.

Counterpart of ``mceik_tpu/api.py`` for the tomo and joint posteriors under
fixed, hierarchical or spike-slab noise: config -> grid -> synthetic data
-> posterior -> sampler (rwm, am, am_full, pcn, mala, hmc or nuts; MALA
with an optional Laplace preconditioner, and hmc, nuts and pcn optionally
in the whitened coordinates of a Laplace fit), sampled in segments of
``io.log_every`` steps with one JSONL metrics record per segment (plus one
for the Laplace setup and one for the initial states), then pooled moments
and diagnostics. Welford moments carry across segments, so segmentation
never changes the statistics. Under spike-slab noise every step is the
continuous kernel followed by the exact Gibbs scan over the station
indicators, and the warmup anneals the scan's odds (``spike_slab_warmup``).
SMC has its own entry point, ``samplers.smc.run_smc_config``, which the CLI
calls.
"""

from __future__ import annotations

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
from mceik_tpu_torch.io.metrics import MetricsLogger
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
    """Refuse the io and dist options the port does not run yet (every
    sampler).

    ``dist.multihost`` without a multi-process launcher (``WORLD_SIZE``
    unset or 1) warns and runs as one process on the requested device, as
    the reference's ``init_distributed`` falls back when no coordinator
    answers; more than one process or device is distribution, not ported
    yet."""
    io, dist = config.io, config.dist
    if io.checkpoint_path or io.resume or io.checkpoint_every:
        raise NotImplementedError("checkpointing and resume are not ported "
                                  "yet")
    if io.profile_dir:
        raise NotImplementedError("io.profile_dir: profiling is not ported")
    world = os.environ.get("WORLD_SIZE", "") or "1"
    if (dist.n_devices or 1) > 1 or world != "1":
        raise NotImplementedError(
            f"multi-device runs (dist.n_devices={dist.n_devices}, "
            f"WORLD_SIZE={world}): distribution is not ported yet")
    if dist.multihost:
        warnings.warn("dist.multihost=true but no multi-process launcher "
                      "(WORLD_SIZE unset or 1): continuing as one process on "
                      "the requested device")


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


def _gradient_kernel(scfg, logpost_fn):
    if scfg.algorithm == "hmc":
        return hmc.make_kernel(logpost_fn, scfg.n_leapfrog)
    return nuts.make_kernel(logpost_fn, scfg.max_tree_depth)


def _dispatch_sampler(scfg, posterior, gen: torch.Generator, logger):
    """Returns ``(kernel, adapter, hyper, finalize_fn, states, params_of)``,
    with the chains initialised (RWM has no finalize). ``params_of`` maps
    whitened chain states to model params, and is None when the states are
    model params. MALA carries cached gradients; with
    ``precondition="laplace"`` the MAP and Gauss-Newton covariance are
    computed once here and pinned, and the chains start at the MAP plus
    0.3x Laplace jitter. hmc, nuts and pcn with ``precondition="whitened"``
    run in the Laplace fit's whitened coordinates (``model/whitened.py``)."""
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
        return (_gradient_kernel(scfg, wv.logpost_u), hmc.make_adapter(target),
                hmc.init_hyper(wv.scales_u, scfg.step_size, wv.zero_u),
                hmc.finalize, states, wv.params_of)
    if algo == "mala":
        target = max(scfg.target_accept, 0.574)
        hyper = mala.init_hyper(scales, scfg.step_size)
        init_fn = posterior.init_params
        adapt_cov = True
        if scfg.precondition == "laplace":
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
        return (_gradient_kernel(scfg, lp), hmc.make_adapter(target),
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
                      betas=(0.05, 0.2, 0.5, 1.0)):
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
                     states, hyper, gen, n_warmup=part, n_steps=1)
        states, hyper = r.states, r.hyper
    if finalize_fn is not None:
        hyper = finalize_fn(hyper)
    return states, hyper


def with_noise_gibbs(posterior, kernel, adapter, states, hyper, finalize_fn,
                     gen: torch.Generator, n_warmup: int):
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
                                          finalize_fn=finalize_fn)
    return _wrap_noise_gibbs(kernel, gibbs), states, hyper, 0


def run(config: RunConfig, device="cuda", verbose: bool = True) -> RunSummary:
    """Sample the config's posterior on ``device`` ("cuda" or "cpu")."""
    _check_supported(config)
    device = prepare_device(device)
    grid = config.grid.build()
    data, truth = make_dataset(grid, config.data, config.model, device=device)
    scfg = config.sampler
    posterior = build_posterior(config.model, data, grid, config.eikonal,
                                differentiable=_uses_gradients(scfg))

    logger = MetricsLogger() if verbose else None
    gen = torch.Generator(device=device).manual_seed(scfg.seed)
    kernel, adapter, hyper, finalize_fn, states, params_of = \
        _dispatch_sampler(scfg, posterior, gen, logger)
    collect_fn = params_of if params_of is not None else (lambda p: p)
    if logger is not None:
        logger.log({"phase": "init", "step": 0, "device": str(device),
                    **_logpost_stats(states.logpost)})
    kernel, states, hyper, n_warmup = with_noise_gibbs(
        posterior, kernel, adapter, states, hyper, finalize_fn, gen,
        scfg.n_warmup)
    if logger is not None and n_warmup < scfg.n_warmup:
        # The annealed spike-slab warmup ran apart from the segments.
        logger.log({"phase": "warmup", "step": 0,
                    "noise_inclusion": round(float(
                        states.params.noise_z.mean()), 4),
                    **_logpost_stats(states.logpost)})

    def track_fn(params):
        # Whitened chains carry u; moments always see model params.
        p = collect_fn(params)
        return {"params": p, "slowness": posterior.slowness_of(p)}

    seg = config.io.log_every if config.io.log_every > 0 else scfg.n_samples
    seg = max(1, min(seg, scfg.n_samples))
    n_seg = max(1, scfg.n_samples // seg)
    n_steps_actual = n_seg * seg

    t0 = time.perf_counter()
    seg_results = []
    welford = None
    step_done = 0
    for si in range(n_seg):
        r = run_mcmc(kernel, adapter if si == 0 else None, states, hyper, gen,
                     n_warmup=n_warmup if si == 0 else 0, n_steps=seg,
                     thin=scfg.thin, track_fn=track_fn, collect_fn=collect_fn,
                     finalize_fn=finalize_fn if si == 0 else None,
                     init_welford=welford)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        states, hyper, welford = r.states, r.hyper, r.welford
        step_done += seg
        seg_results.append(r)

        if logger is not None:
            lp = _to_numpy(r.logpost_trace)
            last = lp[-1] if len(lp) else _to_numpy(states.logpost)
            extra = {k: round(float(r.info_trace[k].mean()), 4)
                     for k in ("divergent", "tree_depth") if k in r.info_trace}
            z = collect_fn(states.params).noise_z
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
    wall = time.perf_counter() - t0

    # --- host-side summary ---------------------------------------------
    kept = [r for r in seg_results if r.samples is not None]
    samples = (tree_map(lambda *xs: np.concatenate([_to_numpy(x) for x in xs]),
                        *[r.samples for r in kept]) if kept else None)
    logpost_trace = np.concatenate(
        [_to_numpy(r.logpost_trace) for r in seg_results], axis=0)
    accept_trace = np.concatenate(
        [_to_numpy(r.accept_trace) for r in seg_results], axis=0)

    mean, var = welford_finalize(welford_merge_chains(welford))
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
    if "slowness" in truth:
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
